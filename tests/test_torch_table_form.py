"""K11's table form (ops/compose.py TableForm, csrc/compose.cuh
compose_points_table): its step stream against stark_tpu.

A numpy model runs the stream step by step as the kernel does (each op
decoded from the packed words that the generated source holds, every slot
read and written where the allocator put it, a flagged step's value added
as its term at once) and is held against ``stark_tpu``'s
``StarkProver._compose_impl`` on every example AIR, the 65-register AIR of
test_torch_wide.py and a counter with 64 and 512 distinct linear
constraints, at T = 64 or less; the allocator's slot count is the widest
point of the stream's live set.  On a card (marker ``gpu``): the kernel
against the eager compose at the shapes ``tools/tune_kernels.py`` times it
(the paths' AIRs forced into the table form, the distinct counter at 1,024
and 3,632 constraints).  Tolerance zero: field values are exact.
"""

import re

import numpy as np
import pytest
import torch

from stark_tpu_torch import StarkConfig, StarkProver
from stark_tpu_torch.models import MODEL_NAMES, get_model
from stark_tpu_torch.models.air import Air, BoundaryConstraint
from stark_tpu_torch.ops import compose as CO
from stark_tpu_torch.ops.fieldops import P
from test_torch_wide import wide_air
from torch_port_support import cuda_device, rand_field  # noqa: F401


def distinct_air(base, boundary, transitions: int):
    """A counter from 5 (x' = x + 1) with ``transitions`` constraints, the
    step times 1, 2, .., transitions (a distinct linear form each; the AIR
    of tools/tune_kernels.distinct_air), for either package's Air."""

    class DistinctAir(base):
        num_registers = 1
        frame_offsets = (0, 1)
        constraint_degree = 1

        def transition_constraints(self, frame, ops):
            x0, x1 = frame[0][0], frame[1][0]
            step = ops.sub(ops.sub(x1, x0), ops.const(1, x0))
            return [ops.mul(ops.const(i + 1, x0), step) for i in range(transitions)]

        def boundary_constraints(self, trace_length):
            return [boundary(row=0, register=0, value=5)]

    return DistinctAir()


# (name, T, blowup): every example AIR at its blowup, wide65 and the
# distinct counters (the longest at T = 16).
AIRS = [(m, 64, get_model(m)[2]) for m in MODEL_NAMES] + [
    ("wide65", 64, 4), ("distinct64", 64, 4), ("distinct512", 16, 4)]


def make_air(name: str, base=Air, boundary=BoundaryConstraint):
    if name == "wide65":
        return wide_air(base, boundary)
    if name.startswith("distinct"):
        return distinct_air(base, boundary, int(name[len("distinct"):]))
    if base is Air:
        return get_model(name)[0]
    from stark_tpu.models import get_model as j_get_model

    return j_get_model(name)[0]


def table_prover(name: str, t: int, blowup: int):
    """The port's CPU prover of the AIR and its table-form program."""
    air = make_air(name)
    prover = StarkProver(air, StarkConfig(trace_length=t, blowup=blowup), device="cpu")
    return prover, CO.ComposeProgram(air, prover.program.boundary, table=True)


def decode(word0: int, word1: int) -> tuple[int, int, int, int]:
    """A packed step (csrc/compose.cuh Step) -> (op, dst, a, b)."""
    return word0 & 0xFFFF, word0 >> 16, word1 & 0xFFFF, word1 >> 16


def packed_stream(source: str) -> list[tuple[int, int]]:
    """The generated source's kStream words."""
    body = re.search(r"kStream\[\d+\] = \{(.*?)\};", source, re.S)[1]
    return [(int(a), int(b)) for a, b in re.findall(r"\{(\d+)u, (\d+)u\}", body)]


def model(prog, lde: np.ndarray, tables, alphas, betas, blowup: int) -> np.ndarray:
    """The table form's codeword of (B, c, N) ``lde`` in numpy (uint64 mod
    p): the step stream decoded from the source's words and run step by
    step over every point at once, slot by slot as the allocator gave them
    out; then the zerofier, the degree shifts and the boundary rows."""
    b, _, n = lde.shape
    x = lde.astype(np.uint64)
    idx = np.arange(n)
    consts = [np.uint64(k) for k in prog.form.constants]
    slots: dict[int, np.ndarray] = {}
    al, be = (np.asarray(v, dtype=np.uint64).reshape(b, -1)[..., None] for v in (alphas, betas))
    sa = np.zeros((b, n), dtype=np.uint64)
    sb = np.zeros((b, n), dtype=np.uint64)
    stream = packed_stream(prog.source)
    steps = int(re.search(r"kSteps = (\d+);", prog.source)[1])
    assert len(stream) == steps + CO.SPARE_STEPS  # the spare step the kernel prefetches
    for word0, word1 in stream[:steps]:
        op, dst, a, c = decode(word0, word1)
        kind = CO.STEP_OPS[op & (CO.STEP_OUT - 1)]
        if kind == "in":
            off = a - (1 << 16) if a & 0x8000 else a
            v = x[:, c, (idx + off * blowup) % n]
        elif kind == "const":
            v = np.full((b, n), consts[c], dtype=np.uint64)
        elif kind == "add":
            v = (slots[a] + slots[c]) % P
        elif kind == "sub":
            v = (slots[a] + P - slots[c]) % P
        elif kind == "neg":
            v = (P - slots[a]) % P
        elif kind == "mulc":
            v = slots[a] * consts[c] % P
        elif kind == "mul":
            v = slots[a] * slots[c] % P
        else:
            v = slots[a]
        if op & CO.STEP_OUT:
            sa = (sa + v * al[:, dst] % P) % P
            sb = (sb + v * be[:, dst] % P) % P
        else:
            slots[dst] = v
    exz, xt, xb = (t.numpy().astype(np.uint64) for t in (tables.exz, tables.xt, tables.xb))
    total = exz * ((xt * sa % P + sb) % P) % P
    for r in range(len(prog.rows)):
        ra = np.zeros((b, n), dtype=np.uint64)
        rb = np.zeros((b, n), dtype=np.uint64)
        for j, bc in enumerate(prog.boundary):
            if prog.groups[j] != r:
                continue
            d = (x[:, bc.register] + P - int(bc.value) % P) % P
            ra = (ra + d * al[:, prog.transitions + j] % P) % P
            rb = (rb + d * be[:, prog.transitions + j] % P) % P
        dinv = tables.dinv[r].numpy().astype(np.uint64)
        total = (total + dinv * ((xb * ra % P + rb) % P)) % P
    return total.astype(np.uint32)


@pytest.mark.parametrize("name, t, blowup", AIRS)
def test_step_stream_model_matches_stark_tpu(name, t, blowup):
    import jax.numpy as jnp
    from stark_tpu import StarkConfig as JConfig
    from stark_tpu import StarkProver as JProver
    from stark_tpu.models.air import Air as JAir
    from stark_tpu.models.air import BoundaryConstraint as JBoundary

    prover, prog = table_prover(name, t, blowup)
    rng = np.random.default_rng(len(name) + t)
    lde = rand_field(rng, (1, prover.air.num_registers, prover.dom.N))
    alphas, betas = (rand_field(rng, prog.terms) for _ in range(2))
    got = model(prog, lde, prover.tables, alphas, betas, blowup)
    jp = JProver(make_air(name, JAir, JBoundary), JConfig(trace_length=t, blowup=blowup))
    want = jp._compose_impl(jnp.asarray(lde[0]), jnp.asarray(alphas), jnp.asarray(betas),
                            *jp._domain_consts())
    np.testing.assert_array_equal(got[0], np.asarray(want))


def widest_live_set(stream: list[tuple[int, int]], steps: int) -> int:
    """The most values live at once in a decoded stream: a value lives from
    the step that writes its slot to its slot's last read before the next
    write (a step's reads come before its write)."""
    born: dict[int, int] = {}        # slot -> step of the live value's write
    spans: list[tuple[int, int]] = []
    last: dict[int, int] = {}
    for q, (word0, word1) in enumerate(stream[:steps]):
        op, dst, a, c = decode(word0, word1)
        kind = CO.STEP_OPS[op & (CO.STEP_OUT - 1)]
        reads = {"add": [a, c], "sub": [a, c], "mul": [a, c], "neg": [a], "mulc": [a],
                 "copy": [a]}.get(kind, [])
        for s in reads:
            assert s in born, f"step {q} reads slot {s} before a write"
            last[s] = q
        if not op & CO.STEP_OUT:
            if dst in born:
                spans.append((born[dst], last.get(dst, born[dst])))
            born[dst], last[dst] = q, q
    spans += [(born[s], last[s]) for s in born]
    return max((sum(1 for lo, hi in spans if lo <= q and (hi > q or lo == q))
                for q in range(steps)), default=0)


@pytest.mark.parametrize("name, t, blowup", AIRS)
def test_slots_are_the_live_sets_widest_point(name, t, blowup):
    _, prog = table_prover(name, t, blowup)
    form = prog.form
    stream = packed_stream(prog.source)
    steps = len(form.steps) - CO.SPARE_STEPS
    assert [decode(*w) for w in stream] == [tuple(r) for r in form.steps.tolist()]
    assert f"kSlots = {form.slots};" in prog.source
    assert form.slots == widest_live_set(stream, steps) <= steps
    assert f"kThreads = {form.threads};" in prog.source
    assert form.slots * form.threads * 16 <= CO.TABLE_SMEM


def test_the_distinct_counters_need_two_slots():
    # Each constraint a product of the step by its constant, added as its
    # term at once: the frame's two inputs, then the step's value.
    for n in (64, 512):
        _, prog = table_prover(f"distinct{n}", 16, 4)
        ops = [CO.STEP_OPS[op & 7] for op, *_ in prog.form.steps[:-CO.SPARE_STEPS].tolist()]
        outs = [op & CO.STEP_OUT for op, *_ in prog.form.steps[:-CO.SPARE_STEPS].tolist()]
        assert prog.form.slots == 2 and len(ops) == n + 5 and sum(1 for o in outs if o) == n
        assert ops[-n:] == ["mulc"] * n and prog.form.threads == CO.TABLE_THREADS[0]


# The shapes tools/tune_kernels.py times the table form at: (AIR, T, B).
CARD_SHAPES = [("fib", 1 << 20, 1), ("mds", 1 << 16, 1), ("fib", 1 << 14, 8),
               ("distinct1024", 1 << 16, 1), ("distinct3632", 1 << 16, 1)]


@pytest.mark.gpu
@pytest.mark.parametrize("name, t, b", CARD_SHAPES)
def test_table_form_at_the_timed_shapes_on_card(cuda_device, name, t, b):
    air = make_air(name)
    card = StarkProver(air, StarkConfig(trace_length=t, blowup=4), cuda_device)
    prog = CO.ComposeProgram(air, card.program.boundary, table=True)
    rng = np.random.default_rng(t + b)
    lde = torch.from_numpy(rand_field(rng, (b, air.num_registers, card.dom.N)).astype(
        np.int32)).to(cuda_device)
    alphas, betas = (rand_field(rng, (b, prog.terms)) for _ in range(2))
    want = CO.compose_plain(prog, lde, card.tables, alphas, betas, 4)
    for _ in range(2):
        assert torch.equal(CO.compose(prog, lde, card.tables, alphas, betas, 4), want)
