"""The host blocked on a batch's one read: the program's span
``stark.fetch_wait`` (finish() waiting for the card's buffer), a proof's
mean over the traced window.  Near 0 where the host paces the card (the
read has landed before the host asks), large where the card paces the
host."""

from benchmark.metrics._spans import ms_per_proof


def read(rec, metric, context):
    return ms_per_proof(rec, ("stark.fetch_wait",))
