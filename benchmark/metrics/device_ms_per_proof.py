"""The device program: the union of the card's activity over the traced
window (torch.profiler), over the proofs completed in it; over several
cards the slowest card's."""


def read(rec, metric, context):
    if not rec.traces or not rec.traced_proofs:
        return None
    return max(t["busy_s"] for t in rec.traces) / rec.traced_proofs * 1e3
