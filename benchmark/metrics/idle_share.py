"""The device: 1 - (the union of the card's activity) / (the traced
window), in percent; over several cards the idlest card's."""


def read(rec, metric, context):
    if not rec.traces:
        return None
    return max(1.0 - t["busy_s"] / t["window_s"] for t in rec.traces) * 100.0
