"""K5-K8 (hash_rows, merkle_level, merkle_tail, merkle_forest): the trace
tree and every FRI round's tree.  Each tree reads its leaves' values (4
bytes each) and writes its whole level stack (2 W - 1 digests of 32 bytes,
kept for the openings)."""

KERNELS = ("stark_hash_rows", "stark_merkle_")


def work(s):
    n = 4 * s["c"] * s["N"] + 32 * (2 * s["N"] - 1)
    for r in range(s["rounds"]):
        w = s["N"] >> r
        n += 4 * w + 32 * (2 * w - 1)
    return {"bytes": n}
