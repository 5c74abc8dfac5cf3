"""The kernels: the sum over roofline/ of each kernel's least time for the
traced window's proofs, over the profiled device seconds of the kernels it
covers (every card's), in percent.  A kernel that no longer runs
finds nothing in the trace and drops out of both sums."""

from benchmark import roofline


def read(rec, metric, context):
    if not rec.traces or not rec.traced_proofs:
        return None
    least, spent = 0.0, 0.0
    for name, mod in roofline.kernels().items():
        seconds = sum(s for t in rec.traces for k, s in t["kernels"].items()
                      if roofline.matches(mod, k))
        if seconds <= 0.0:
            continue
        least += roofline.least_seconds(mod, context["shape"]) * rec.traced_proofs
        spent += seconds
    return least / spent * 100.0 if spent else None
