"""Fibonacci: one register t, t(i + 2) = t(i + 1) + t(i) on rows 0 .. T-3,
from the start pair (t(0), t(1)), the statement's public inputs; the
stark-rs trace generator (src/trace.rs) starts from (1, 1)."""

from __future__ import annotations

import numpy as np

P = 998244353
REGISTERS = 1
FRAME_OFFSETS = (0, 1, 2)
CONSTRAINT_DEGREE = 1
TRANSITIONS = 1
#: The default statement's public inputs: the start pair (t(0), t(1)).
PUBLIC = (1, 1)


def transition(frame):
    return [(frame[2][0] - frame[1][0] - frame[0][0]) % P]


def boundary(trace_length: int, public=PUBLIC):
    """(row, register, value) of every boundary constraint."""
    a, b = public
    return [(0, 0, a % P), (1, 0, b % P)]


def trace(trace_length: int, public=PUBLIC) -> np.ndarray:
    """(1, T) uint32: the sequence from the start pair, mod p."""
    out = np.empty(trace_length, dtype=np.uint32)
    a, b = (v % P for v in public)
    for i in range(trace_length):
        out[i] = a
        a, b = b, (a + b) % P
    return out[None]
