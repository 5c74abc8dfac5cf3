"""The host emission's wire segments: the program's spans
``fri.round_emit`` (each FRI round's triples and Merkle paths) and
``stark.open_emit`` (the trace openings and their paths), a proof's mean
over the traced window."""

from benchmark.metrics._spans import ms_per_proof


def read(rec, metric, context):
    return ms_per_proof(rec, ("fri.round_emit", "stark.open_emit"))
