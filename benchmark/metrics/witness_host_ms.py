"""The witness layer's host work, timed inside the program: its spans
``witness.seeds`` (the seeds made on the host) and ``witness.upload`` (their
copy to the card), a proof's mean over the traced window.  The launch of
the expansion and the card's time are not in it (``witness_ms`` is)."""

from benchmark.metrics._spans import ms_per_proof


def read(rec, metric, context):
    return ms_per_proof(rec, ("witness.seeds", "witness.upload"))
