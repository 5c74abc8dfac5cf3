"""Algebraic Intermediate Representation (AIR) abstraction.

The reference has no constraint system — its `trace.rs` is an orphan with no
consumer (SURVEY section 2, component 15).  This layer is the new design that
completes the pipeline: an AIR declares

* ``num_registers`` — trace columns;
* ``frame_offsets`` — the row offsets a transition constraint reads
  (e.g. (0, 1, 2) for a two-step recurrence);
* ``transition_constraints`` — polynomials in the frame registers that must
  vanish on every enforcement row, written once against a small op namespace
  so the SAME definition runs (a) batched on device over the whole LDE
  domain and (b) scalar on host at the verifier's spot-check points;
* ``boundary_constraints`` — (row, register, value) fixtures.

Constraint evaluation is pointwise over the LDE domain: :class:`BatchOps`
runs it as int64 torch ops over whole (N,) tensors.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from stark_tpu_torch.ops import fieldops as F
from stark_tpu_torch.ops.fieldops import P


class BatchOps:
    """Constraint arithmetic over (N,) int64 tensors of values in [0, p)."""

    add = staticmethod(F.addmod)
    sub = staticmethod(F.submod)
    mul = staticmethod(F.mulmod)
    neg = staticmethod(F.negmod)

    @staticmethod
    def const(value, like):
        return torch.full(like.shape, value % P, dtype=torch.int64, device=like.device)


class ScalarOps:
    """The same arithmetic over host ints (verifier spot checks)."""

    @staticmethod
    def add(a, b):
        return (a + b) % P

    @staticmethod
    def sub(a, b):
        return (a - b) % P

    @staticmethod
    def mul(a, b):
        return (a * b) % P

    @staticmethod
    def neg(a):
        return (-a) % P

    @staticmethod
    def const(value, like):
        return value % P


@dataclass(frozen=True)
class BoundaryConstraint:
    row: int
    register: int
    value: int


class Air:
    """Base class.  Subclasses define the constraint polynomials."""

    num_registers: int = 1
    frame_offsets: tuple = (0, 1)
    #: max total degree of any transition constraint as a polynomial in the
    #: frame registers (degree multiplier on the trace polynomials).
    constraint_degree: int = 1

    def transition_constraints(self, frame, ops):
        """frame[k][r]: register r at row offset k (array or scalar).
        Returns a list of constraint evaluations."""
        raise NotImplementedError

    def boundary_constraints(self, trace_length: int) -> list[BoundaryConstraint]:
        raise NotImplementedError

    @property
    def max_offset(self) -> int:
        return max(self.frame_offsets)

    def num_transition_constraints(self) -> int:
        # Evaluate once on dummy scalars to count.
        frame = {
            k: [1 for _ in range(self.num_registers)] for k in self.frame_offsets
        }
        return len(self.transition_constraints(frame, ScalarOps))
