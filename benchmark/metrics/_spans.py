"""The program's span recorder (stark_tpu_torch.utils.profiling), read
after a traced run: its totals hold the spans closed while torch's profiler
ran, in a run of the benchmark the traced window alone.  A program without
the recorder, or a run that recorded nothing, gives None."""


def totals():
    """{span: (host seconds, count)}, or None."""
    try:
        from stark_tpu_torch.utils.profiling import snapshot_spans
    except ImportError:
        return None
    return snapshot_spans() or None


def ms_per_proof(rec, names) -> float | None:
    """The host milliseconds of the spans ``names`` a proof of the traced
    window; None where none of them was recorded."""
    got = totals()
    if not got or not rec.traced_proofs or not any(n in got for n in names):
        return None
    return sum(got[n][0] for n in names if n in got) / rec.traced_proofs * 1e3
