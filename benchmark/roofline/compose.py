"""K11, the composition codeword: the (c, N) trace LDE read, the (N,)
codeword written (its point tables may be computed on the fly)."""

KERNELS = ("stark_compose",)


def work(s):
    return {"bytes": 4 * s["c"] * s["N"] + 4 * s["N"]}
