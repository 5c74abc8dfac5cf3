"""Builds and captures inside the window, per 1000 proofs: the counts of
the program's spans ``compose.build`` (a K11 library made for a source not
yet loaded: a new AIR, or a statement compiled into code) and
``cuda.capture`` (a slot's CUDA graph captured) among the spans of the
traced window.  It must read 0: every statement of a shape is data for
one build and one graph a slot made in set-up.  None where the run
recorded no spans."""

from benchmark.metrics._spans import totals


def read(rec, metric, context):
    got = totals()
    if not got or not rec.traced_proofs:
        return None
    count = sum(got.get(name, (0.0, 0))[1] for name in ("compose.build", "cuda.capture"))
    return count / rec.traced_proofs * 1e3
