"""The composition codeword (kernel K11): code generation, build, launch,
and the plain version.

Counterpart of stark_tpu/stark.py::StarkProver._compose_impl (:570-616)
and of its vmap over a batch (stark_tpu/batch.py:554-559).  The AIR's
transition constraints are user code, so the kernel is generated per AIR:
``models.air.record_constraints`` records them once as a straight-line
tape, :func:`generate_source` writes it as a C++ function of one point
(every node a local ``uint32_t``, canonical in [0, p), a product by a
constant a Shoup product with its companion computed here), and
csrc/compose.cuh adds what no AIR changes: the frame loads, the zerofier
factor, the boundary quotients, the weights and the sum, over a (B, c, N)
grid.  The generated source goes into ``stark_tpu_torch/_build/`` and is
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
import os
import time

import numpy as np
import torch

from stark_tpu_torch.models.air import Air, BoundaryConstraint, record_constraints
from stark_tpu_torch.ops import cuda
from stark_tpu_torch.ops import fieldops as F
from stark_tpu_torch.ops.fieldops import P
from stark_tpu_torch.utils.build import BUILD_DIR, build_library

COMPOSE = cuda.Kernel(
    "compose", "stark_compose",
    [cuda.ptr] * 6 + [ctypes.c_longlong] + [cuda.i32] * 3 + [cuda.ptr, cuda.i32],
    source="stark_tpu_torch/csrc/compose.cuh",
    replaces="stark_tpu/stark.py:570", generated=True,
)
HEADERS = ("field.cuh", "compose.cuh")
#: Weight words one launch's parameters hold (csrc/compose.cuh).
MAX_WORDS = 8000
R1 = (1 << 32) % P
R2 = R1 * R1 % P
#: Seconds each AIR library's build took in this process, by the sha256 of
#: its generated source (0.0: found built).
BUILD_SECONDS: dict[str, float] = {}
# Integer operations per point, as the generated body and compose.cuh
# compute them: a Montgomery product 7, a Shoup product 4, an addition or
# subtraction mod p 2, a product of two variables 11 (Montgomery, then
# Shoup by R).
OPS_MONT, OPS_SHOUP, OPS_ADD, OPS_MUL = 7, 4, 2, 11


def shoup(w: np.ndarray) -> np.ndarray:
    """Shoup companions floor(w 2^32 / p) of values w in [0, p)."""
    return ((np.asarray(w, dtype=np.uint64) << np.uint64(32)) // np.uint64(P)).astype(
        np.uint32)


class ComposeProgram:
    """An AIR's composition, as the kernel is generated from it:
    ``boundary`` is the domain's list of BoundaryConstraint (rows may
    depend on the trace length); ``rows`` the distinct boundary rows in
    order of first use, one ``dinv`` table each; ``groups[j]`` boundary
    j's index among them."""

    def __init__(self, air: Air, boundary: list[BoundaryConstraint]):
        self.air = air
        self.tape = record_constraints(air)
        self.boundary = list(boundary)
        self.rows = list(dict.fromkeys(int(bc.row) for bc in self.boundary))
        self.groups = [self.rows.index(int(bc.row)) for bc in self.boundary]
        self.transitions = len(self.tape.outputs)
        self.terms = self.transitions + len(self.boundary)
        self.source = generate_source(self)
        self.sha256 = hashlib.sha256(self.source.encode()).hexdigest()

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

    def operations(self) -> int:
        """Integer operations per point (the bound's count)."""
        ops = 0
        for j in self.tape.live():
            node = self.tape.nodes[j]
            if node[0] in ("add", "sub", "neg"):
                ops += OPS_ADD
            elif node[0] == "mul":
                consts = sum(self.tape.const_value(x) is not None for x in node[1:])
                ops += OPS_SHOUP if consts else OPS_MUL
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


def generate_source(program: ComposeProgram) -> str:
    """The AIR's C++ source: ``struct Air`` (csrc/compose.cuh) and its entry.
    The same bytes for the same AIR and boundary list."""
    tape, air = program.tape, program.air
    live = tape.live()

    def ref(j: int) -> str:
        c = tape.const_value(j)
        return f"{c}u" if c is not None else f"n{j}"

    loads, body = [], []
    for j in live:
        node = tape.nodes[j]
        op = node[0]
        if op == "in":
            loads.append(f"    const uint32_t n{j} = at({node[1]}, {node[2]});")
        elif op == "neg":
            body.append(f"    const uint32_t n{j} = stark::sub_mod(0u, {ref(node[1])});")
        elif op in ("add", "sub"):
            body.append(f"    const uint32_t n{j} = stark::{op}_mod({ref(node[1])}, "
                        f"{ref(node[2])});")
        elif op == "mul":
            a, b = node[1], node[2]
            ca, cb = tape.const_value(a), tape.const_value(b)
            if ca is not None or cb is not None:
                x, w = (b, ca) if ca is not None else (a, cb)
                body.append(f"    const uint32_t n{j} = stark::shoup_mul(n{x}, {w}u, "
                            f"{int(shoup(w))}u);")
            else:
                body.append(f"    const uint32_t n{j} = stark::mul_mod(n{a}, n{b});")
    inputs = {(tape.nodes[j][1], tape.nodes[j][2]): j for j in live
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
    values = ", ".join(f"{int(bc.value) % P}u" for bc in program.boundary) or "0u"
    return "\n".join([
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
        "  // Boundary j's row (its index among the distinct rows) and value;",
        "  // arrays local to a function, which device code may index.",
        "  __device__ __forceinline__ static int boundary_row(int j) {",
        f"    constexpr int k[{max(nb, 1)}] = {{{rows}}};",
        "    return k[j];",
        "  }",
        "  __device__ __forceinline__ static uint32_t boundary_value(int j) {",
        f"    constexpr uint32_t k[{max(nb, 1)}] = {{{values}}};",
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


def _source_file(source: str) -> str:
    """The generated source, written once into the build directory."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    path = os.path.join(BUILD_DIR, f"compose-{hashlib.sha256(source.encode()).hexdigest()[:16]}.cu")
    if not os.path.exists(path):
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            f.write(source)
        os.replace(tmp, path)
    return path


def _headers() -> list[str]:
    return [os.path.join(cuda.CSRC, h) for h in HEADERS]


@functools.lru_cache(maxsize=None)
def library(source: str) -> ctypes.CDLL:
    """The AIR's kernel library: built with nvcc at first use, loaded."""
    t0 = time.perf_counter()
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
        [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.stark_compose_host.restype = ctypes.c_int
    return lib


class Tables:
    """The trace-independent (N,) tables of a prover, int32 canonical
    values on its device: ``exz`` = excl zinv (the transition zerofier's
    factor), ``xt`` = x^s_t, ``xb`` = x^s_b, ``dinv`` (rows, N) =
    1 / (x - w^row) per distinct boundary row."""

    def __init__(self, exz, xt, xb, dinv):
        self.exz, self.xt, self.xb, self.dinv = exz, xt, xb, dinv


def compose(program: ComposeProgram, lde: torch.Tensor, tables: Tables, alphas,
            betas, blowup: int) -> torch.Tensor:
    """(c, N) int32 LDE -> (N,) int32 codeword, or B proofs at once: (B, c,
    N) -> (B, N).  ``alphas``, ``betas``: (terms,) host ints, or (B, terms)
    for B proofs.  On a card one K11 launch (or one per 8,000 weight
    words); on the CPU the plain version."""
    if lde.device.type == "cpu":
        return compose_plain(program, lde, tables, alphas, betas, blowup)
    single = lde.dim() == 2
    lde3 = lde[None] if single else lde
    b, c, n = lde3.shape
    words = program.weights(alphas, betas)
    if words.shape[0] != b or c != program.air.num_registers:
        raise ValueError(f"{words.shape[0]} proofs' weights for {b} LDEs of "
                         f"{c} rows, the AIR has {program.air.num_registers}")
    if n & (n - 1) or tuple(tables.exz.shape) != (n,):
        raise ValueError(f"an LDE of {n} points, tables of {tuple(tables.exz.shape)}")
    for t, name in ((lde3, "lde"), (tables.exz, "exz"), (tables.xt, "xt"),
                    (tables.xb, "xb"), (tables.dinv, "dinv")):
        cuda.check_operand(t, name)
    per = MAX_WORDS // words.shape[1]
    if per < 1:
        raise ValueError(f"{program.terms} terms need more weight words than a launch holds")
    lib = library(program.source)
    out = torch.empty((b, n), dtype=torch.int32, device=lde3.device)
    for j in range(0, b, per):
        part = np.ascontiguousarray(words[j : j + per])
        COMPOSE.launch(
            lde3.device, lde3[j].data_ptr(), tables.exz.data_ptr(), tables.xt.data_ptr(),
            tables.xb.data_ptr(), tables.dinv.data_ptr(), out[j].data_ptr(), n, c, blowup,
            part.shape[0], part.ctypes.data, part.size, lib=lib,
        )
    return out[0] if single else out


def compose_plain(program: ComposeProgram, lde: torch.Tensor, tables: Tables, alphas,
                  betas, blowup: int) -> torch.Tensor:
    """K11's plain version: elementwise int64 torch ops
    (stark_tpu/stark.py:_compose_impl; vmapped for B proofs)."""
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
    # ONE roll of the whole LDE per frame offset; the registers are its
    # rows (dimension -2).
    frame = {
        k: list((x if k == 0 else torch.roll(x, -k * blowup, -1)).unbind(-2))
        for k in air.frame_offsets
    }
    cons = air.transition_constraints(frame, BatchOps)
    total = torch.zeros(x.shape[:-2] + x.shape[-1:], dtype=torch.int64, device=dev)
    for ci, c in enumerate(cons):
        q = F.mulmod(c, exz)
        w = F.addmod(F.mulmod(xt, weights[ci][0]), weights[ci][1])
        total = F.addmod(total, F.mulmod(w, q))
    for bi, bc in enumerate(program.boundary):
        num = F.submod(frame[0][bc.register], int(bc.value) % P)
        q = F.mulmod(num, tables.dinv[program.groups[bi]].long())
        wa, wb = weights[program.transitions + bi]
        w = F.addmod(F.mulmod(xb, wa), wb)
        total = F.addmod(total, F.mulmod(w, q))
    return total.to(torch.int32)
