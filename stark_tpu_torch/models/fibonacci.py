"""Fibonacci AIR — the flagship workload (reference trace.rs:36-49 is the
generator; the constraint system is new, since the reference has none).

Single register t; transition t(w^2 x) = t(w x) + t(x) on rows 0..T-3;
boundary t(row 0) = 1, t(row 1) = 1.
"""

from __future__ import annotations

from stark_tpu_torch.models.air import Air, BoundaryConstraint
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
    import numpy as np

    def gen():
        a, b = 1, 1
        for _ in range(length):
            yield a
            a, b = b, (a + b) % P

    return np.fromiter(gen(), dtype=np.uint32, count=length).reshape(
        length, 1
    )

