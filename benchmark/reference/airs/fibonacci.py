"""Fibonacci: one register t, t(i + 2) = t(i + 1) + t(i) on rows 0 .. T-3,
t(0) = t(1) = 1 (the stark-rs trace generator, src/trace.rs)."""

from __future__ import annotations

import numpy as np

P = 998244353
REGISTERS = 1
FRAME_OFFSETS = (0, 1, 2)
CONSTRAINT_DEGREE = 1
TRANSITIONS = 1


def transition(frame):
    return [(frame[2][0] - frame[1][0] - frame[0][0]) % P]


def boundary(trace_length: int):
    """(row, register, value) of every boundary constraint."""
    return [(0, 0, 1), (1, 0, 1)]


def trace(trace_length: int) -> np.ndarray:
    """(1, T) uint32: the sequence mod p."""
    out = np.empty(trace_length, dtype=np.uint32)
    a, b = 1, 1
    for i in range(trace_length):
        out[i] = a
        a, b = b, (a + b) % P
    return out[None]
