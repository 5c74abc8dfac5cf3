"""The composition codeword (kernel K11): code generation, build, launch,
and the plain version.

Counterpart of stark_tpu/stark.py::StarkProver._compose_impl (:570-616)
and of its vmap over a batch (stark_tpu/batch.py:554-559).  The weights
of the constraint terms come from device memory: kernel K15 writes them
there on the single-fetch prove (ops/hash_batch.constraint_challenges);
challenges drawn on the host go up first.  The AIR's
transition constraints are user code, so the kernel is generated per AIR:
``models.air.record_constraints`` records them once as a straight-line
tape, :func:`generate_source` writes it as a C++ function of one point
(every node a local ``uint32_t``, canonical in [0, p); a sum with products
by constants one lazy 64-bit sum of its linear form, reduced once; any
other product by a constant a Shoup product with its companion computed
here; an AIR whose straight-line body would run past :data:`TABLE_LINES`
lines, which nvcc takes minutes over, is written instead as a stream of
8-byte steps that a compact interpreter in csrc/compose.cuh runs, 4 points
a thread, its slots given out by liveness (:class:`TableForm`: the table
form), and
csrc/compose.cuh adds what no AIR changes: the frame loads, the zerofier
factor, the boundary quotients, the weights and the sum, over a (B, c, N)
grid.  The boundary constraints' values are not in the source: each proof's
lie in device memory (``compose(values=)``, a row a proof), the statement's
public inputs, so that one build serves every statement of an AIR.  The
generated source goes into ``stark_tpu_torch/_build/`` and is
built at first use by ``utils.build.build_library``, which keys the
library by its bytes: one library per AIR, built once.  Every AIR's
library counts its launches under one name, ``compose`` (:data:`COMPOSE`).

:func:`compose_plain` is the eager int64 version; a tensor on the CPU
takes it, a tensor on a card the kernel.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import heapq
import os
import threading
import time

import numpy as np
import torch

from stark_tpu_torch.models.air import Air, BoundaryConstraint, record_constraints
from stark_tpu_torch.ops import cuda
from stark_tpu_torch.ops import fieldops as F
from stark_tpu_torch.ops.fieldops import P
from stark_tpu_torch.utils.build import BUILD_DIR, build_library
from stark_tpu_torch.utils import profiling

COMPOSE = cuda.Kernel(
    "compose", "stark_compose",
    [cuda.ptr] * 6 + [ctypes.c_longlong] + [cuda.i32] * 3 + [cuda.ptr, cuda.i32,
                                                             ctypes.c_longlong, cuda.ptr],
    source="stark_tpu_torch/csrc/compose.cuh",
    replaces="stark_tpu/stark.py:570", generated=True,
)
HEADERS = ("field.cuh", "compose.cuh")
R1 = (1 << 32) % P
R2 = R1 * R1 % P
#: Seconds each AIR library's build took in this process, by the sha256 of
#: its generated source (0.0: found built).
BUILD_SECONDS: dict[str, float] = {}
#: Products a lazy 64-bit sum takes before it folds, and what a folded sum
#: counts as (csrc/compose.cuh kLazyTerms, kFoldTerms).
LAZY_TERMS, FOLD_TERMS = 16, 2
# Integer operations per point, as the generated body and compose.cuh
# compute them: a Montgomery product 7, a Shoup product 4, an addition or
# subtraction mod p 2, a product of two variables 11 (Montgomery, then
# Shoup by R); a term of a lazy sum is one 64-bit multiply-add, a fold one
# more, the closing reduction 6 (fold, multiply, multiply high, carry,
# add, add-and-minimum).
OPS_MONT, OPS_SHOUP, OPS_ADD, OPS_MUL = 7, 4, 2, 11
OPS_WIDE, OPS_FOLD, OPS_REDUCE = 1, 1, 6
#: The most lines the straight-line form's body and its sums (a line a
#: term, compose.cuh unrolls them whole) may take: a larger AIR is
#: generated in the table form.  On an H100 80GB HBM3 (700 W; PERF.md, PR
#: 16: tools/tune_kernels.py ``compose builds`` and ``compose turns``)
#: nvcc took 2.6, 6.5, 20.1 and 103.8 s over 387, 1,539, 3,075 and 6,147
#: straight-line lines, and 2.6-3.1 s over the table form at any size,
#: whose kernel ran 2.1-9.3 times slower at the paths' AIRs: the limit
#: keeps a straight-line build near 10 s.
TABLE_LINES = 2048
#: csrc/compose.cuh's Step ops, in its order, and the flag of a step whose
#: value is a transition term.
STEP_OPS = ("in", "const", "add", "sub", "neg", "mulc", "mul", "copy")
STEP_OUT = 8
#: Spare steps after a stream's last (csrc/compose.cuh loads one ahead).
SPARE_STEPS = 1
#: A table-form block's threads, the first of these whose slots (16 bytes
#: a thread a slot: csrc/compose.cuh kTablePoints points) fit TABLE_SMEM,
#: the shared memory a block may take (PERF.md §6: tools/tune_kernels.py
#: compose turns times 128 and 256 beside it).
TABLE_THREADS = (64, 32)
TABLE_SMEM = 227 * 1024


def shoup(w: np.ndarray) -> np.ndarray:
    """Shoup companions floor(w 2^32 / p) of values w in [0, p)."""
    return ((np.asarray(w, dtype=np.uint64) << np.uint64(32)) // np.uint64(P)).astype(
        np.uint32)


def lazy_folds(terms: int) -> int:
    """Folds a lazy sum of ``terms`` products makes (one before each term
    that would be its LAZY_TERMS + 1-th since the last)."""
    folds, count = 0, 0
    for _ in range(terms):
        if count == LAZY_TERMS:
            folds, count = folds + 1, FOLD_TERMS
        count += 1
    return folds


def lazy_ops(terms: int) -> int:
    """Operations of a lazy sum of ``terms`` products, reduced once."""
    return terms * OPS_WIDE + lazy_folds(terms) * OPS_FOLD + OPS_REDUCE


def _linear_forms(tape) -> dict:
    """{node: (coefficients {base node: c}, constant)} of every live node
    that is linear in its inputs (add, sub, neg, a product by a constant):
    its value is sum c x + constant mod p over bases x, each a frame input
    or a product of two variables."""
    forms: dict = {}

    def form(j):
        c = tape.const_value(j)
        if c is not None:
            return {}, c
        return forms.get(j, ({j: 1}, 0))

    for j in tape.live():
        node = tape.nodes[j]
        op = node[0]
        if op in ("add", "sub"):
            (fa, ca), (fb, cb) = form(node[1]), form(node[2])
            sign = 1 if op == "add" else P - 1
            d = dict(fa)
            for k, v in fb.items():
                d[k] = (d.get(k, 0) + sign * v) % P
            forms[j] = ({k: v for k, v in d.items() if v}, (ca + sign * cb) % P)
        elif op == "neg":
            fa, ca = form(node[1])
            forms[j] = ({k: P - v for k, v in fa.items()}, -ca % P)
        elif op == "mul":
            ca, cb = tape.const_value(node[1]), tape.const_value(node[2])
            if ca is not None or cb is not None:
                x, w = (node[2], ca) if ca is not None else (node[1], cb)
                fx, cx = form(x)
                forms[j] = ({k: v * w % P for k, v in fx.items() if v * w % P},
                            cx * w % P)
    return forms


class ComposeProgram:
    """An AIR's composition, as the kernel is generated from it:
    ``boundary`` is the domain's list of BoundaryConstraint (rows may
    depend on the trace length); ``rows`` the distinct boundary rows in
    order of first use, one ``dinv`` table each; ``groups[j]`` boundary
    j's index among them.  ``table``: the form of the generated source,
    the table form (True), the straight-line form (False), or (None) the
    straight-line form unless its lines pass :data:`TABLE_LINES`.  The
    boundaries' values are the default statement's (:meth:`values`); the
    source holds their rows and registers only."""

    def __init__(self, air: Air, boundary: list[BoundaryConstraint],
                 table: bool | None = None):
        self.air = air
        self.tape = record_constraints(air)
        self.boundary = list(boundary)
        self.rows = list(dict.fromkeys(int(bc.row) for bc in self.boundary))
        self.groups = [self.rows.index(int(bc.row)) for bc in self.boundary]
        self.transitions = len(self.tape.outputs)
        self.terms = self.transitions + len(self.boundary)
        self.source, self.body_operations, self.lines = generate_source(self)
        self.table = self.lines > TABLE_LINES if table is None else table
        #: The table form's step stream (:class:`TableForm`), or None.
        self.form = TableForm(self.tape) if self.table else None
        if self.table:
            self.source, self.body_operations = generate_table_source(self)
        self.sha256 = hashlib.sha256(self.source.encode()).hexdigest()
        #: The default statement's values on a device, by (device, B).
        self._defaults: dict = {}

    def weights(self, alphas, betas) -> np.ndarray:
        """(B, terms) challenges (or (terms,)) -> (B, 4 terms) uint32
        launch words: per term a R^2, its companion, b R, its companion."""
        a = np.atleast_2d(np.asarray(alphas, dtype=np.int64)) % P
        b = np.atleast_2d(np.asarray(betas, dtype=np.int64)) % P
        if a.shape != b.shape or a.shape[1] != self.terms:
            raise ValueError(f"{self.terms} weights a proof, got {a.shape} and {b.shape}")
        wa = (a.astype(np.uint64) * np.uint64(R2) % np.uint64(P)).astype(np.uint32)
        wb = (b.astype(np.uint64) * np.uint64(R1) % np.uint64(P)).astype(np.uint32)
        return np.stack([wa, shoup(wa), wb, shoup(wb)], axis=2).reshape(a.shape[0], -1)

    def values(self, values=None, b: int = 1) -> np.ndarray:
        """(B, boundaries) boundary values (host ints, a row a proof; None:
        the default statement's for each of ``b`` proofs) -> the (B,
        max(boundaries, 1)) int32 words K11 reads, canonical in [0, p)."""
        if values is None:
            values = [[int(bc.value) for bc in self.boundary]] * b
        v = np.asarray(values, dtype=np.int64).reshape(-1, len(self.boundary))
        out = np.zeros((v.shape[0], max(len(self.boundary), 1)), dtype=np.int32)
        out[:, : len(self.boundary)] = v % P
        return out

    def default_values(self, b: int, device) -> torch.Tensor:
        """The default statement's words (:meth:`values`) for ``b`` proofs
        on ``device``, made once."""
        key = (torch.device(device), b)
        got = self._defaults.get(key)
        if got is None:
            got = self._defaults[key] = torch.from_numpy(self.values(None, b)).to(device)
        return got

    def challenges(self, words: torch.Tensor) -> tuple[np.ndarray, np.ndarray]:
        """The inverse of :meth:`weights`: (B, 4 terms) int32 weight words
        (K15's, on any device) -> ((B, terms), (B, terms)) int64 alphas and
        betas mod p."""
        w = words.cpu().numpy().view(np.uint32).astype(np.uint64).reshape(
            words.shape[0], self.terms, 4)
        inv_r1 = pow(R1, P - 2, P)
        return ((w[..., 0] * np.uint64(inv_r1 * inv_r1 % P) % np.uint64(P)).astype(np.int64),
                (w[..., 2] * np.uint64(inv_r1) % np.uint64(P)).astype(np.int64))

    def operations(self) -> int:
        """Integer operations per point (the bound's count): the generated
        body's, then compose.cuh's weighted sums and table products."""
        ops = self.body_operations
        # Per term two Shoup products and two additions; per weighted sum
        # two Montgomery products and an addition, and one more addition
        # into the total per boundary row; a subtraction per boundary.
        ops += self.terms * 2 * (OPS_SHOUP + OPS_ADD) + 2 * len(self.boundary)
        sums = (1 if self.transitions else 0) + len(self.rows)
        return ops + sums * (2 * OPS_MONT + OPS_ADD) + len(self.rows) * OPS_ADD

    def table_loads(self) -> int:
        """(N,) tables the kernel reads: exz and xt with transitions, xb
        with boundaries, one dinv a row."""
        return (2 if self.transitions else 0) + (1 + len(self.rows) if self.rows else 0)

    def registers_read(self) -> int:
        """LDE rows the kernel reads (its frame's registers and the
        boundaries')."""
        regs = {self.tape.nodes[j][2] for j in self.tape.live()
                if self.tape.nodes[j][0] == "in"}
        return len(regs | {int(bc.register) for bc in self.boundary})


def generate_source(program: ComposeProgram) -> tuple[str, int, int]:
    """The AIR's C++ source in the straight-line form, ``struct Air``
    (csrc/compose.cuh) and its entry, the operations per point of its body,
    and its lines (the body's, and a line a term of compose.cuh's unrolled
    sums).  The same bytes for the same AIR and boundary list.

    A node the constraints need as a value (an output, an operand of a
    product of two variables) that is a sum with products by constants
    other than +-1 is written as a lazy 64-bit sum of its linear form over
    frame inputs and such products (each coefficient c as c R mod p, each
    constant k as k R mod p, which the reduction's 2^-32 takes back);
    every other node as the tape has it: a product by a constant a Shoup
    product with its literal companion, an addition or subtraction mod p,
    a product of two variables mul_mod."""
    tape, air = program.tape, program.air
    forms = _linear_forms(tape)

    def ref(j: int) -> str:
        c = tape.const_value(j)
        return f"{c}u" if c is not None else f"n{j}"

    def lazy(j: int) -> bool:
        d = forms.get(j, ({}, 0))[0]
        return len(d) >= 2 and any(v not in (1, P - 1) for v in d.values())

    need = set(tape.outputs)
    for j in sorted(tape.live(), reverse=True):
        if j not in need:
            continue
        node = tape.nodes[j]
        if lazy(j):
            need.update(forms[j][0])
        elif node[0] != "in":
            need.update(x for x in node[1:] if tape.const_value(x) is None)

    loads, body, ops = [], [], 0
    for j in sorted(need):
        node = tape.nodes[j]
        op = node[0]
        if op == "in":
            loads.append(f"    const uint32_t n{j} = at({node[1]}, {node[2]});")
        elif lazy(j):
            d, k = forms[j]
            terms = [f"(uint64_t)n{x} * {c * R1 % P}u" for x, c in sorted(d.items())]
            if k:
                terms.append(f"{k * R1 % P}ull")
            body.append(f"    uint64_t s{j} = {terms[0]};")
            count = 1
            for t in terms[1:]:
                if count == LAZY_TERMS:
                    body.append(f"    s{j} = stark::fold64(s{j});")
                    count = FOLD_TERMS
                body.append(f"    s{j} += {t};")
                count += 1
            body.append(f"    const uint32_t n{j} = stark::reduce64(s{j});")
            ops += lazy_ops(len(terms))
        elif op == "neg":
            body.append(f"    const uint32_t n{j} = stark::sub_mod(0u, {ref(node[1])});")
            ops += OPS_ADD
        elif op in ("add", "sub"):
            body.append(f"    const uint32_t n{j} = stark::{op}_mod({ref(node[1])}, "
                        f"{ref(node[2])});")
            ops += OPS_ADD
        elif op == "mul":
            a, b = node[1], node[2]
            ca, cb = tape.const_value(a), tape.const_value(b)
            if ca is not None or cb is not None:
                x, w = (b, ca) if ca is not None else (a, cb)
                body.append(f"    const uint32_t n{j} = stark::shoup_mul(n{x}, {w}u, "
                            f"{int(shoup(w))}u);")
                ops += OPS_SHOUP
            else:
                body.append(f"    const uint32_t n{j} = stark::mul_mod(n{a}, n{b});")
                ops += OPS_MUL
    inputs = {(tape.nodes[j][1], tape.nodes[j][2]): j for j in need
              if tape.nodes[j][0] == "in"}
    bounds = []
    for i, bc in enumerate(program.boundary):
        j = inputs.get((0, int(bc.register)))
        if j is None:
            j = f"b{int(bc.register)}"
            line = f"    const uint32_t {j} = at(0, {int(bc.register)});"
            if line not in loads:
                loads.append(line)
        else:
            j = f"n{j}"
        bounds.append(f"    v[{i}] = {j};")
    outs = [f"    c[{k}] = {ref(j)};" for k, j in enumerate(tape.outputs)]
    nb = len(program.boundary)
    rows = ", ".join(str(g) for g in program.groups) or "0"
    source = "\n".join([
        f"// Kernel K11 for the AIR {type(air).__name__}, generated by",
        "// stark_tpu_torch/ops/compose.py from its transition constraints.",
        '#include "compose.cuh"',
        "",
        "namespace stark_air {",
        "",
        "struct Air {",
        f"  static constexpr int kRegisters = {air.num_registers};",
        f"  static constexpr int kTransitions = {program.transitions};",
        f"  static constexpr int kBoundaries = {nb};",
        f"  static constexpr int kRows = {len(program.rows)};",
        f"  static constexpr int kTerms = {program.terms};",
        "  static constexpr bool kTable = false;",
        "  // Boundary j's row (its index among the distinct rows): an array",
        "  // local to a function, which device code may index.",
        "  __device__ __forceinline__ static int boundary_row(int j) {",
        f"    constexpr int k[{max(nb, 1)}] = {{{rows}}};",
        "    return k[j];",
        "  }",
        "  __device__ __forceinline__ static void values(",
        "      const stark::Frame& at,",
        f"      uint32_t (&c)[{max(program.transitions, 1)}],",
        f"      uint32_t (&v)[{max(nb, 1)}]) {{",
        *loads, *body, *outs, *bounds,
        "  }",
        "};",
        "",
        "}  // namespace stark_air",
        "",
        "STARK_COMPOSE_ENTRY(stark_air::Air)",
        "",
    ])
    lines = len(loads) + len(body) + len(outs) + len(bounds) + program.terms
    return source, ops, lines


class TableForm:
    """The table form's step stream (csrc/compose.cuh Step), as the
    generator writes it and the kernel runs it: ``steps`` (S + SPARE_STEPS,
    4) int64 rows (op, dst, a, b) in order (:data:`STEP_OPS`; an output's
    op or'ed with :data:`STEP_OUT`, its dst then the transition term's
    index), then a spare step that the kernel's prefetch reads and never
    runs; ``constants`` the values that steps name by index; ``slots`` the
    slots a point needs (the live set's widest point); ``threads`` a
    block's threads, the first of :data:`TABLE_THREADS` whose slots fit
    :data:`TABLE_SMEM`; ``operations`` the steps' per point."""

    def __init__(self, tape):
        order = _table_order(tape)
        index: dict[int, int] = {}        # constant value -> its index
        constants: list[int] = []

        def const(v: int) -> int:
            if v not in index:
                index[v] = len(constants)
                constants.append(v)
            return index[v]

        # Each value's last reader; then the slots by a linear scan: a
        # step's operands whose last reader it is are freed before its own
        # value takes the lowest free slot.
        reads = [[j] if copy else _operands(tape, j) for j, _, copy in order]
        last = {x: q for q, rd in enumerate(reads) for x in rd}
        free: list[int] = []
        slot: dict[int, int] = {}
        rows, ops = [], 0
        for q, (j, term, copy) in enumerate(order):
            operand = [slot[x] for x in reads[q]]
            for x in set(reads[q]):
                if last[x] == q:
                    heapq.heappush(free, slot.pop(x))
            node, a, b = tape.nodes[j], 0, 0
            op = node[0]
            if copy:
                op, a = "copy", operand[0]
            elif op == "const":
                b = const(node[1])
            elif op == "in":
                a, b = node[1] & 0xFFFF, node[2]
            elif op in ("add", "sub", "neg"):
                a, b = operand[0], operand[-1]
                ops += OPS_ADD
            else:
                factor = [tape.const_value(x) for x in node[1:]
                          if tape.const_value(x) is not None]
                if factor:                              # a product by a constant
                    op, a, b = "mulc", operand[0], const(factor[0])
                    ops += OPS_SHOUP
                else:
                    a, b = operand[0], operand[-1]
                    ops += OPS_MUL
            if term is not None:
                rows.append((STEP_OPS.index(op) | STEP_OUT, term, a, b))
            else:
                slot[j] = heapq.heappop(free) if free else len(slot) + len(free)
                rows.append((STEP_OPS.index(op), slot[j], a, b))
        if len(tape.outputs) >= 1 << 16 or len(constants) >= 1 << 16:
            raise ValueError(f"{len(tape.outputs)} transitions, {len(constants)} constants: "
                             "a step names at most 65,535")
        self.steps = np.asarray(rows + [(STEP_OPS.index("copy"), 0, 0, 0)] * SPARE_STEPS,
                                dtype=np.int64)
        self.constants = constants
        self.slots = max((r[1] + 1 for r in rows if not r[0] & STEP_OUT), default=0)
        self.operations = ops
        fits = [t for t in TABLE_THREADS if self.slots * t * 16 <= TABLE_SMEM]
        if not fits:
            raise ValueError(f"the table form's point holds {self.slots} live values, at "
                             f"most {TABLE_SMEM // (16 * TABLE_THREADS[-1])}")
        self.threads = fits[0]


def _operands(tape, j: int) -> list[int]:
    """The nodes whose values node j's step reads from slots: an addition's,
    subtraction's or negation's operands, a product's but a constant
    factor (a square's one operand once)."""
    node = tape.nodes[j]
    if node[0] in ("add", "sub", "neg"):
        return list(node[1:])
    if node[0] == "mul":
        return [x for x in dict.fromkeys(node[1:]) if tape.const_value(x) is None]
    return []


def _table_order(tape) -> list[tuple[int, int | None, bool]]:
    """The table form's steps in order, as (node, term, copy): the live
    nodes that need a value in tape order, each frame input and constant
    (a constant only where a step reads it from a slot or it is an output:
    a product by a constant names it) just before its first reader.  A
    node that is one output and read by no step carries it (term its
    index); any other output's node keeps a slot, and a copy step (copy
    True) right after it adds each of its terms."""
    terms: dict[int, list[int]] = {}
    for k, j in enumerate(tape.outputs):
        terms.setdefault(j, []).append(k)
    readers: dict[int, int] = {}
    for j in tape.live():
        for x in _operands(tape, j):
            readers[x] = readers.get(x, 0) + 1
    order: list = []
    placed: set = set()

    def place(j):
        if j in placed:
            return
        placed.add(j)
        for x in _operands(tape, j):
            place(x)
        ks = terms.get(j, [])
        if len(ks) == 1 and not readers.get(j):
            order.append((j, ks[0], False))
        else:
            order.append((j, None, False))
            order.extend((j, k, True) for k in ks)

    for j in tape.live():
        if tape.nodes[j][0] not in ("in", "const") or j in terms:
            place(j)
    return order


def generate_table_source(program: ComposeProgram) -> tuple[str, int]:
    """The AIR's C++ source in the table form, and the operations per
    point of its steps: the step stream of :class:`TableForm`, its
    constants, and the boundary constraints by row (each its index and
    register; its value is the proof's), as arrays in device memory that
    compose.cuh's loops read.  The same values as the straight-line form."""
    air, form = program.air, program.form
    by_row = sorted(range(len(program.boundary)), key=lambda j: program.groups[j])
    ends = np.cumsum(np.bincount(np.asarray(program.groups, dtype=np.int64),
                                 minlength=len(program.rows)))

    def array(ctype: str, name: str, items: list[str]) -> list[str]:
        rows = [", ".join(items[k:k + 8]) for k in range(0, len(items), 8)] or ["{}"]
        return [f"__device__ const {ctype} {name}[{max(len(items), 1)}] = {{",
                *(f"    {r}," for r in rows), "};"]

    step_items = [f"{{{op | dst << 16}u, {a | b << 16}u}}" for op, dst, a, b in
                  form.steps.tolist()]
    const_items = [f"{{{k}u, {int(shoup(k))}u}}" for k in form.constants]
    bound_items = [f"{{{j}u, {int(program.boundary[j].register)}u}}" for j in by_row]
    source = "\n".join([
        f"// Kernel K11 for the AIR {type(air).__name__}, generated by",
        "// stark_tpu_torch/ops/compose.py from its transition constraints",
        "// (the table form).",
        '#include "compose.cuh"',
        "",
        "namespace stark_air {",
        "",
        *array("stark::Step", "kStream", step_items),
        *array("stark::Constant", "kConstants", const_items),
        *array("stark::BoundaryTerm", "kBoundaryTerms", bound_items),
        *array("int", "kRowEnds", [str(int(e)) for e in ends]),
        "",
        "struct Air {",
        f"  static constexpr int kRegisters = {air.num_registers};",
        f"  static constexpr int kTransitions = {program.transitions};",
        f"  static constexpr int kBoundaries = {len(program.boundary)};",
        f"  static constexpr int kRows = {len(program.rows)};",
        f"  static constexpr int kTerms = {program.terms};",
        "  static constexpr bool kTable = true;",
        f"  static constexpr int kSteps = {len(form.steps) - SPARE_STEPS};",
        f"  static constexpr int kSlots = {form.slots};",
        f"  static constexpr int kThreads = {form.threads};",
        "  __device__ __forceinline__ static const stark::Step* steps() { return kStream; }",
        "  __device__ __forceinline__ static const stark::Constant* constants() {",
        "    return kConstants;",
        "  }",
        "  __device__ __forceinline__ static const stark::BoundaryTerm* boundaries() {",
        "    return kBoundaryTerms;",
        "  }",
        "  __device__ __forceinline__ static const int* row_ends() { return kRowEnds; }",
        "};",
        "",
        "}  // namespace stark_air",
        "",
        "STARK_COMPOSE_ENTRY(stark_air::Air)",
        "",
    ])
    return source, form.operations


def _source_file(source: str) -> str:
    """The generated source, written once into the build directory (a
    private temporary name for each process and thread: two AIRs can
    generate one source, and threads build side by side)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    path = os.path.join(BUILD_DIR, f"compose-{hashlib.sha256(source.encode()).hexdigest()[:16]}.cu")
    if not os.path.exists(path):
        tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
        with open(tmp, "w") as f:
            f.write(source)
        os.replace(tmp, path)
    return path


def _headers() -> list[str]:
    return [os.path.join(cuda.CSRC, h) for h in HEADERS]


@functools.lru_cache(maxsize=None)
def library(source: str) -> ctypes.CDLL:
    """The AIR's kernel library: built with nvcc at first use, loaded (the
    span ``compose.build``, once a source in a process)."""
    t0 = time.perf_counter()
    with profiling.span("compose.build"):
        path = build_library("stark_compose", [_source_file(source)], _headers(),
                             [cuda._nvcc(), *cuda.NVCC_FLAGS, "-I", cuda.CSRC])
    BUILD_SECONDS[hashlib.sha256(source.encode()).hexdigest()] = time.perf_counter() - t0
    lib = ctypes.CDLL(path)
    lib.stark_compose.argtypes = [*COMPOSE.argtypes, cuda.ptr]
    lib.stark_compose.restype = cuda.i32
    lib.stark_cuda_error_string.argtypes = [cuda.i32]
    lib.stark_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def host_library(source: str) -> ctypes.CDLL:
    """The same source built with the host C++ compiler: its entry
    ``stark_compose_host`` runs the per-point function at every point (the
    CPU tests' check of the generated code)."""
    path = build_library("stark_compose_host", [_source_file(source)], _headers(),
                         ["c++", "-std=c++17", "-O2", "-shared", "-fPIC", "-x", "c++",
                          "-I", cuda.CSRC])
    lib = ctypes.CDLL(path)
    lib.stark_compose_host.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_longlong] + \
        [ctypes.c_int] * 3 + [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]
    lib.stark_compose_host.restype = ctypes.c_int
    return lib


class Tables:
    """The trace-independent (N,) tables of a prover, int32 canonical
    values on its device: ``exz`` = excl zinv (the transition zerofier's
    factor), ``xt`` = x^s_t, ``xb`` = x^s_b, ``dinv`` (rows, N) =
    1 / (x - w^row) per distinct boundary row."""

    def __init__(self, exz, xt, xb, dinv):
        self.exz, self.xt, self.xb, self.dinv = exz, xt, xb, dinv

    @classmethod
    def build(cls, *, n: int, trace_length: int, blowup: int, offset: int, omega_n: int,
              omega_t: int, excluded: list[int], shift_t: int, shift_b: int,
              rows: list[int], device, start: int = 0, count: int | None = None
              ) -> "Tables":
        """The tables of a coset x_i = offset omega_n^i of n points (a
        trace domain of ``trace_length`` generated by omega_t), made once
        (in int64, stored int32): the transition zerofier's factor 1 /
        (x^T - 1) prod_e (x - excluded_e), the degree shifts x^shift_t and
        x^shift_b, and 1 / (x - omega_t^r) for each boundary row r.  With
        ``start`` and ``count``, only the points start .. start + count - 1
        (a rank's share; both multiples of ``blowup``)."""
        count = n - start if count is None else count
        if start % blowup or count % blowup or not 0 < start + count <= n:
            raise ValueError(f"points {start} .. +{count} of {n}, blowup {blowup}")
        x_dom = F.powers(omega_n, count, scale=offset * pow(omega_n, start, P),
                         device=device)
        rho = pow(omega_n, trace_length, P)                         # order = blowup
        zinv_cycle = [F.host_inv(pow(offset, trace_length, P) * pow(rho, j, P) - 1)
                      for j in range(blowup)]
        exz = torch.tensor(zinv_cycle, dtype=torch.int64, device=device).repeat(
            count // blowup)
        for w in excluded:
            exz = F.mulmod(exz, F.submod(x_dom, w))
        xt, xb = (F.powers(pow(omega_n, s, P), count,
                           scale=pow(offset, s, P) * pow(omega_n, s * start, P),
                           device=device)
                  for s in (shift_t, shift_b))
        dinv = [F.invmod(F.submod(x_dom, pow(omega_t, row, P))) for row in rows]
        dinv = torch.stack(dinv) if dinv else torch.zeros((1, count), dtype=torch.int64,
                                                          device=device)
        return cls(*(t.to(torch.int32).contiguous() for t in (exz, xt, xb, dinv)))


def compose(program: ComposeProgram, lde: torch.Tensor, tables: Tables, alphas,
            betas, blowup: int, points: int | None = None, *,
            weights: torch.Tensor | None = None, values=None) -> torch.Tensor:
    """(c, N) int32 LDE -> (N,) int32 codeword, or B proofs at once: (B, c,
    N) -> (B, N).  ``alphas``, ``betas``: (terms,) host ints, or (B, terms)
    for B proofs; or, instead (both None), ``weights``: the (B, 4 terms)
    int32 weight words on the LDE's device (K15's, ComposeProgram.weights'
    layout).  ``points``: the halo form (a rank's share): each row holds
    ``points`` points of the coset and then the frame's reach past them
    (the next share's first points), read without a wrap; the tables are
    the share's, the result (B, points).  ``values``: each proof's boundary
    values, the (B, max(boundaries, 1)) int32 words of
    :meth:`ComposeProgram.values` on the LDE's device; None: the default
    statement's.  On a card one K11 launch, reading the weights and values
    from device memory (host weights go up from pinned memory first); on
    the CPU the plain version."""
    if (weights is None) == (alphas is None and betas is None):
        raise ValueError("pass alphas and betas, or weights")
    single = lde.dim() == 2
    if weights is not None and weights.device != lde.device:
        raise ValueError(f"weights on {weights.device}, the LDE on {lde.device}")
    lde3 = lde[None] if single else lde
    b, c, span = lde3.shape
    if values is None:
        values = program.default_values(b, lde.device)
    if tuple(values.shape) != (b, max(len(program.boundary), 1)):
        raise ValueError(f"values {tuple(values.shape)} for {b} proofs of "
                         f"{len(program.boundary)} boundaries")
    if values.device != lde.device:
        raise ValueError(f"values on {values.device}, the LDE on {lde.device}")
    if lde.device.type == "cpu":
        if weights is not None:
            alphas, betas = program.challenges(weights)
            if single:
                alphas, betas = alphas[0], betas[0]
        return compose_plain(program, lde, tables, alphas, betas, blowup, points,
                             values=values)
    n = span if points is None else points
    if weights is None:
        words = torch.from_numpy(program.weights(alphas, betas).view(np.int32))
        weights = words.pin_memory().to(lde.device, non_blocking=True)
    if tuple(weights.shape) != (b, 4 * program.terms) or c != program.air.num_registers:
        raise ValueError(f"weights {tuple(weights.shape)} for {b} LDEs of {c} rows; the "
                         f"AIR has {program.terms} terms and {program.air.num_registers} "
                         "registers")
    if b > 65535:
        raise ValueError(f"{b} proofs in one launch, at most 65535")
    if points is None and n & (n - 1):
        raise ValueError(f"an LDE of {n} points, not a power of two")
    if tuple(tables.exz.shape) != (n,):
        raise ValueError(f"an LDE of {n} points, tables of {tuple(tables.exz.shape)}")
    if points is not None and span < n + program.air.max_offset * blowup:
        raise ValueError(f"rows of {span} words hold no halo of "
                         f"{program.air.max_offset * blowup} past {n} points")
    for t, name in ((lde3, "lde"), (tables.exz, "exz"), (tables.xt, "xt"),
                    (tables.xb, "xb"), (tables.dinv, "dinv"), (weights, "weights"),
                    (values, "values")):
        cuda.check_operand(t, name)
    if weights.data_ptr() % 16:
        raise ValueError("weights must be 16-byte aligned (a term is one 16-byte load)")
    lib = library(program.source)
    out = torch.empty((b, n), dtype=torch.int32, device=lde3.device)
    COMPOSE.launch(
        lde3.device, lde3.data_ptr(), tables.exz.data_ptr(), tables.xt.data_ptr(),
        tables.xb.data_ptr(), tables.dinv.data_ptr(), out.data_ptr(), n, c, blowup, b,
        weights.data_ptr(), weights.numel(), span, values.data_ptr(), lib=lib,
    )
    return out[0] if single else out


def compose_plain(program: ComposeProgram, lde: torch.Tensor, tables: Tables, alphas,
                  betas, blowup: int, points: int | None = None, *,
                  values=None) -> torch.Tensor:
    """K11's plain version: elementwise int64 torch ops
    (stark_tpu/stark.py:_compose_impl; vmapped for B proofs); ``points``
    the halo form and ``values`` the proofs' boundary values, as in
    :func:`compose`."""
    from stark_tpu_torch.models.air import BatchOps

    air, dev = program.air, lde.device
    x = lde.long()
    a = np.asarray(alphas, dtype=np.int64)
    bt = np.asarray(betas, dtype=np.int64)
    if a.ndim == 1:
        weights = [(int(u), int(v)) for u, v in zip(a, bt)]
    else:
        # per term a (B, 1) column of each
        weights = list(zip(torch.from_numpy(a.T.copy())[..., None].to(dev),
                           torch.from_numpy(bt.T.copy())[..., None].to(dev)))
    exz, xt, xb = tables.exz.long(), tables.xt.long(), tables.xb.long()
    if points is None:
        # ONE roll of the whole LDE per frame offset; the registers are its
        # rows (dimension -2).
        frame = {
            k: list((x if k == 0 else torch.roll(x, -k * blowup, -1)).unbind(-2))
            for k in air.frame_offsets
        }
    else:
        # A share with its halo: offset k reads k blowup points further on.
        frame = {k: list(x[..., k * blowup : k * blowup + points].unbind(-2))
                 for k in air.frame_offsets}
    n = x.shape[-1] if points is None else points
    cons = air.transition_constraints(frame, BatchOps)
    total = torch.zeros(x.shape[:-2] + (n,), dtype=torch.int64, device=dev)
    for ci, c in enumerate(cons):
        q = F.mulmod(c, exz)
        w = F.addmod(F.mulmod(xt, weights[ci][0]), weights[ci][1])
        total = F.addmod(total, F.mulmod(w, q))
    # Per boundary the proofs' values: one int for one proof, a (B, 1)
    # column for B.
    v = (program.values(None) if values is None else values.cpu().numpy()).astype(np.int64)
    bvals = [torch.from_numpy(v[:, j, None]).to(dev) if x.dim() > 2 else int(v[0, j])
             for j in range(len(program.boundary))]
    for bi, bc in enumerate(program.boundary):
        num = F.submod(frame[0][bc.register], bvals[bi])
        q = F.mulmod(num, tables.dinv[program.groups[bi]].long())
        wa, wb = weights[program.transitions + bi]
        w = F.addmod(F.mulmod(xb, wa), wb)
        total = F.addmod(total, F.mulmod(w, q))
    return total.to(torch.int32)
