"""The 95th percentile of every proof's latency in the window, from the
call to its bytes (Python's statistics.quantiles, 100 quantiles)."""

import statistics


def read(rec, metric, context):
    if len(rec.latencies_s) < 20:
        return None
    return statistics.quantiles(rec.latencies_s, n=100)[94] * 1e3
