"""The witness layer: the mean of the traced run's span around the
program's device witness (host seeds, the upload, K12), ended by a
synchronize."""


def read(rec, metric, context):
    got = rec.spans.get("witness_s")
    return sum(got) / len(got) * 1e3 if got else None
