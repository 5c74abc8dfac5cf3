"""K1-K3 and K14, the interpolation and the low-degree extension: the (c, T)
witness read and the (c, N) coset values written, 4 bytes a value (the
coefficients between them need not reach memory)."""

KERNELS = ("stark_ntt_", "stark_lde_pad_scale")


def work(s):
    return {"bytes": 4 * s["c"] * (s["T"] + s["N"])}
