"""Fibonacci AIR — the flagship workload (reference trace.rs:36-49 is the
generator; the constraint system is new, since the reference has none).

Single register t; transition t(w^2 x) = t(w x) + t(x) on rows 0..T-3;
boundary t(row 0) = 1, t(row 1) = 1.
"""

from __future__ import annotations

import numpy as np
import torch

from stark_tpu_torch.models.air import Air, BoundaryConstraint
from stark_tpu_torch.ops import cuda
from stark_tpu_torch.ops import witness as W
from stark_tpu_torch.ops.fieldops import P


class FibonacciAir(Air):
    num_registers = 1
    frame_offsets = (0, 1, 2)
    constraint_degree = 1

    def transition_constraints(self, frame, ops):
        t0 = frame[0][0]
        t1 = frame[1][0]
        t2 = frame[2][0]
        return [ops.sub(t2, ops.add(t1, t0))]

    def boundary_constraints(self, trace_length: int):
        return [
            BoundaryConstraint(row=0, register=0, value=1),
            BoundaryConstraint(row=1, register=0, value=1),
        ]


def fibonacci_trace_mod_p(length: int) -> "np.ndarray":
    """The Fibonacci sequence in F_p — the honest witness for FibonacciAir,
    as a (length, 1) uint32 ndarray.

    (The reference generator keeps exact integers; proving needs the
    field-reduced sequence so the transition holds mod p.)
    """
    def gen():
        a, b = 1, 1
        for _ in range(length):
            yield a
            a, b = b, (a + b) % P

    return np.fromiter(gen(), dtype=np.uint32, count=length).reshape(
        length, 1
    )


def fibonacci_seeds(length: int) -> tuple[np.ndarray, int]:
    """The packed seeds s0 | s1 | u0 | u1 (uint32) of the block expansion
    and their block count nb (stark_tpu/models/fibonacci.py:92-114).

    With a_i = F_{i+1} (F_1 = F_2 = 1), the addition formula F_{m+n} =
    F_m F_{n+1} + F_{m-1} F_n at m = kB + 1, n = j gives a_{kB+j} =
    F_{kB+1} F_{j+1} + F_{kB} F_j: a rank-2 outer product of the block
    seeds s0[k] = F_{kB}, s1[k] = F_{kB+1} and the in-block ladder u0[j] =
    F_j, u1[j] = F_{j+1}, B ~ sqrt(length) a power of two."""
    assert length >= 1
    B = 1 << max(0, (length.bit_length() - 1) // 2)
    nb = (length + B - 1) // B
    fj = [0, 1]
    for _ in range(B):
        fj.append((fj[-1] + fj[-2]) % P)
    fB_1, fB, fB1 = fj[B - 1], fj[B], fj[B + 1]
    s0, s1 = np.empty(nb, dtype=np.uint32), np.empty(nb, dtype=np.uint32)
    m0, m1 = 0, 1  # (F_0, F_1), stepped by the B-advance matrix
    for k in range(nb):
        s0[k], s1[k] = m0, m1
        m0, m1 = (fB * m1 + fB_1 * m0) % P, (fB1 * m1 + fB * m0) % P
    u = np.array(fj[: B + 1], dtype=np.uint32)
    return np.concatenate([s0, s1, u[:B], u[1:]]), nb


def fibonacci_trace_cols_device(length: int, device="cuda") -> torch.Tensor:
    """(1, length) int32 trace columns on ``device``, equal to
    ``fibonacci_trace_mod_p(length).T``, made there from O(sqrt(length))
    seeds (kernel K12, ops/witness.fib_expand) instead of uploading the
    witness.  Feed it to ``StarkProver.prove(trace_cols=...)``."""
    device = cuda.device_or_raise(device, "fibonacci_trace_cols_device")
    seeds, nb = fibonacci_seeds(length)
    seeds_dev = torch.from_numpy(seeds.view(np.int32)).to(device)
    return W.fib_expand(seeds_dev, nb, length)
