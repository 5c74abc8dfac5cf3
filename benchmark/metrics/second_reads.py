"""The single-fetch prove's wasted reads: the count of the program's span
``fri.second_read`` (the card's sampler fell short, so the query gather ran
again with the host's indices and a second read) per 1000 proofs of the
traced window; 0 where spans were recorded and none of them."""

from benchmark.metrics._spans import totals


def read(rec, metric, context):
    got = totals()
    if not got or not rec.traced_proofs:
        return None
    return got.get("fri.second_read", (0.0, 0))[1] / rec.traced_proofs * 1e3
