"""The prove layer's statement: the program's span ``stark.statement`` (a
batch's public inputs, its proofs' boundary values, written into the slot
for K11, then copied to the card in stream order), a proof's mean over the
traced window.  A program whose statements are compiled into K11 has no
such span: None."""

from benchmark.metrics._spans import ms_per_proof


def read(rec, metric, context):
    return ms_per_proof(rec, ("stark.statement",))
