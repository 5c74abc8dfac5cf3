"""The prove layer's host dispatch: the program's span ``stark.dispatch``
(the columns copied into the slot, the graph captured on a slot's first
replay, the replay, the read issued), a proof's mean over the traced
window."""

from benchmark.metrics._spans import ms_per_proof


def read(rec, metric, context):
    return ms_per_proof(rec, ("stark.dispatch",))
