"""K12, the device witness (fib_expand, mds_expand): the (c, T) columns
written, 4 bytes a value (its seeds, O(sqrt T) words, left out)."""

KERNELS = ("stark_fib_expand", "stark_mds_expand")


def work(s):
    return {"bytes": 4 * s["c"] * s["T"]}
