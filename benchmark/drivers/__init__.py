"""One module a way of driving the program; a traffic file names it.  Each
has ``run(cell, seed, seconds, trace, started, device) -> harness.Record``,
whose kept proofs are a ``harness.Sample``'s (``Sample.fill``).  A driver
that draws each proof's statement hands the served proof's public inputs
to ``Sample.offer(proof, public)``; one that serves the configuration's
default statement passes none."""
