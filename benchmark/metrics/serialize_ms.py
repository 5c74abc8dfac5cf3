"""The proof's bytes: the program's span ``stream.serialize``
(``ProofStream.serialize``), a proof's mean over the traced window."""

from benchmark.metrics._spans import ms_per_proof


def read(rec, metric, context):
    return ms_per_proof(rec, ("stream.serialize",))
