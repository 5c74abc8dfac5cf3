"""K9, K15, K10 (sponge_absorb, constraint_challenges, sample_indices): the
Fiat-Shamir chain on the card, bound by the latency of its sequential hashes
and not by memory: by bytes, the roots it absorbs (32 bytes each, the trace
root and every FRI round's), a bound that is nearly 0."""

KERNELS = ("stark_sponge_absorb", "stark_constraint_challenges", "stark_sample_indices")


def work(s):
    return {"bytes": 32 * (s["rounds"] + 1)}
