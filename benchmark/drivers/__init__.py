"""One module a way of driving the program; a traffic file names it.  Each
has ``run(cell, seed, seconds, trace, started, device) -> harness.Record``."""
