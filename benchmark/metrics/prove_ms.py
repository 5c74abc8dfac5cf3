"""The window over the proofs completed in it, one proof in flight: the mean
time of a proof from its witness to its bytes, idle time between proofs
included (the host clock)."""


def read(rec, metric, context):
    if not rec.latencies_s or not rec.completed:
        return None
    return rec.window_s / rec.completed * 1e3
