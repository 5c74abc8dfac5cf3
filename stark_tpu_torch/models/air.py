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
* ``boundary_constraints`` — (row, register, value) fixtures; their values
  may be the statement's public inputs (``boundary_constraints(T,
  public)``), their rows and registers are the AIR's shape.

Constraint evaluation is pointwise over the LDE domain: :class:`BatchOps`
runs it as int64 torch ops over whole (N,) tensors; :class:`TapeOps`
records it once as a straight-line :class:`Tape`, from which ops/compose.py
generates the composition kernel K11 for the AIR.
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


class Tape:
    """A straight-line program over F_p: node j is ``nodes[j]``, one of
    ``("in", offset, register)`` (a frame value), ``("const", v)`` (v in
    [0, p)), ``("add" | "sub" | "mul", a, b)`` or ``("neg", a)`` with a, b
    earlier nodes.  Equal nodes are one node, operands of ``add`` and
    ``mul`` in order, and an operation on constants alone is its value.
    ``outputs``: the node of each transition constraint."""

    def __init__(self):
        self.nodes: list[tuple] = []
        self._index: dict[tuple, int] = {}
        self.outputs: list[int] = []

    def node(self, key: tuple) -> "TapeValue":
        j = self._index.get(key)
        if j is None:
            j = self._index[key] = len(self.nodes)
            self.nodes.append(key)
        return TapeValue(self, j)

    def const_value(self, j: int):
        """The value of node j if it is a constant, else None."""
        node = self.nodes[j]
        return node[1] if node[0] == "const" else None

    def live(self) -> list[int]:
        """The nodes the outputs depend on, in tape order."""
        need = set(self.outputs)
        for j in range(len(self.nodes) - 1, -1, -1):
            if j in need and self.nodes[j][0] in ("add", "sub", "mul", "neg"):
                need.update(self.nodes[j][1:])
        return sorted(need)

    def evaluate(self, frame) -> list[int]:
        """The outputs at one point, ``frame[k][r]`` host ints (a small
        interpreter: the tape's semantics, held against ScalarOps)."""
        vals: list[int] = []
        for node in self.nodes:
            op = node[0]
            if op == "in":
                vals.append(int(frame[node[1]][node[2]]) % P)
            elif op == "const":
                vals.append(node[1])
            elif op == "neg":
                vals.append(-vals[node[1]] % P)
            else:
                a, b = vals[node[1]], vals[node[2]]
                vals.append((a + b if op == "add" else a - b if op == "sub" else a * b) % P)
        return [vals[j] for j in self.outputs]


class TapeValue:
    """A value of :class:`TapeOps`: node ``index`` of ``tape``."""

    __slots__ = ("tape", "index")

    def __init__(self, tape: Tape, index: int):
        self.tape = tape
        self.index = index


class TapeOps:
    """The same arithmetic recorded as a :class:`Tape` (one record per AIR:
    :func:`record_constraints`)."""

    def __init__(self, tape: Tape):
        self.tape = tape

    def _binary(self, op: str, a: TapeValue, b: TapeValue) -> TapeValue:
        ca, cb = self.tape.const_value(a.index), self.tape.const_value(b.index)
        if ca is not None and cb is not None:
            return self.const(ScalarOps.add(ca, cb) if op == "add" else
                              ScalarOps.sub(ca, cb) if op == "sub" else
                              ScalarOps.mul(ca, cb), a)
        i, j = a.index, b.index
        if op != "sub" and j < i:
            i, j = j, i
        return self.tape.node((op, i, j))

    def add(self, a, b):
        return self._binary("add", a, b)

    def sub(self, a, b):
        return self._binary("sub", a, b)

    def mul(self, a, b):
        return self._binary("mul", a, b)

    def neg(self, a):
        c = self.tape.const_value(a.index)
        if c is not None:
            return self.const(-c, a)
        return self.tape.node(("neg", a.index))

    def const(self, value, like):
        return self.tape.node(("const", int(value) % P))


def record_constraints(air: "Air") -> Tape:
    """``air.transition_constraints`` recorded once over a frame of input
    nodes (every offset of ``air.frame_offsets``, every register)."""
    tape = Tape()
    ops = TapeOps(tape)
    frame = {k: [tape.node(("in", k, r)) for r in range(air.num_registers)]
             for k in air.frame_offsets}
    tape.outputs = [v.index for v in air.transition_constraints(frame, ops)]
    return tape


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

    def boundary_constraints(self, trace_length: int,
                             public=None) -> list[BoundaryConstraint]:
        """The boundary constraints of the statement with the public inputs
        ``public``; None: the AIR's default statement, what it proves
        without public inputs.  The public inputs set the values alone: every
        statement's rows and registers are the default's, since they fix
        the prover's tables and its K11 build.  An AIR without public
        inputs may take ``trace_length`` alone."""
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
