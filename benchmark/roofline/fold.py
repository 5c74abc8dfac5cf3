"""K4 and K4-dyn, the FRI folds: each round but the last reads its codeword
(W values) and writes the folded one (W / 2), 4 bytes a value."""

KERNELS = ("stark_fri_fold",)


def work(s):
    return {"bytes": sum(6 * (s["N"] >> r) for r in range(s["rounds"] - 1))}
