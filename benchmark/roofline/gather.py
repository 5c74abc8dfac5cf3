"""K13, the query gather: every value and sibling digest a proof opens, read
once and written once into the buffer the host reads: each FRI round's 3
values and 3 paths a test, and at each round-0 point (2 a test) every frame
row's c values and its trace path."""

KERNELS = ("stark_query_gather",)


def work(s):
    k, N = s["tests"], s["N"]
    lg = lambda w: w.bit_length() - 1  # noqa: E731
    opened = 2 * k * s["frame"] * (4 * s["c"] + 32 * lg(N))
    for r in range(s["rounds"] - 1):
        w = N >> r
        opened += 3 * k * 4 + 2 * k * 32 * lg(w) + k * 32 * lg(w // 2)
    return {"bytes": 2 * opened}
