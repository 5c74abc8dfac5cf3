"""A segment of a Fibonacci run, as a zkVM proves an execution cut into
segments: one register t, t(i + 2) = t(i + 1) + t(i) on rows 0 .. T-3, and
the statement's public inputs (a, b, y, z): the state it starts from, t(0)
= a and t(1) = b, and the state it ends in, t(T-2) = y and t(T-1) = z (rows
outside the transition's).  The recurrence is the stark-rs trace generator's
(src/trace.rs), which starts from (1, 1)."""

from __future__ import annotations

import numpy as np

P = 998244353
REGISTERS = 1
FRAME_OFFSETS = (0, 1, 2)
CONSTRAINT_DEGREE = 1
TRANSITIONS = 1
#: The segment length of the cell (RISC Zero's default segment_limit_po2, 20).
SEGMENT = 1 << 20


def end_pair(trace_length: int, start) -> tuple[int, int]:
    """(t(T-2), t(T-1)) of the run from ``start``: the matrix [[0, 1], [1,
    1]] to the power T-2 applied to (t(0), t(1)), by squaring."""
    def mul(x, y):
        return [[(x[i][0] * y[0][j] + x[i][1] * y[1][j]) % P for j in range(2)]
                for i in range(2)]

    m, r, e = [[0, 1], [1, 1]], [[1, 0], [0, 1]], trace_length - 2
    while e:
        if e & 1:
            r = mul(r, m)
        m = mul(m, m)
        e >>= 1
    a, b = (v % P for v in start)
    return (r[0][0] * a + r[0][1] * b) % P, (r[1][0] * a + r[1][1] * b) % P


def default(trace_length: int) -> tuple:
    """The default statement's public inputs: the start (1, 1) and its end
    pair at ``trace_length``."""
    return (1, 1, *end_pair(trace_length, (1, 1)))


#: The default statement's public inputs at the cell's T.
PUBLIC = default(SEGMENT)


def transition(frame):
    return [(frame[2][0] - frame[1][0] - frame[0][0]) % P]


def boundary(trace_length: int, public=None):
    """(row, register, value) of every boundary constraint."""
    a, b, y, z = default(trace_length) if public is None else public
    return [(0, 0, a % P), (1, 0, b % P), (trace_length - 2, 0, y % P),
            (trace_length - 1, 0, z % P)]


def trace(trace_length: int, public=None) -> np.ndarray:
    """(1, T) uint32: the run from the start pair, mod p.  Raises where its
    last two values are not the end pair: a statement with a wrong end pair
    is false, and has no witness."""
    a, b, y, z = (v % P for v in (default(trace_length) if public is None else public))
    out = np.empty(trace_length, dtype=np.uint32)
    for i in range(trace_length):
        out[i] = a
        a, b = b, (a + b) % P
    if (int(out[-2]), int(out[-1])) != (y, z):
        raise ValueError(f"the run from ({out[0]}, {out[1]}) ends in ({out[-2]}, {out[-1]}), "
                         f"not in the end pair ({y}, {z}): a false statement")
    return out[None]
