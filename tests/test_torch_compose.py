"""The composition codeword (kernel K11, ops/compose.py) against stark_tpu.

The port's eager compose (K11's plain version, ``StarkProver._compose``
on the CPU) against ``stark_tpu.StarkProver._compose_impl`` with its
``_domain_consts()`` on the same seeded LDE and weights, for every example
AIR at T = 64, one proof and B = 3 against ``jax.vmap`` of it; the tape
that the kernel is generated from (``models.air.TapeOps``) against
``ScalarOps`` at seeded frames, for every example AIR and the 65-register
AIR of test_torch_wide.py; the generated source's bytes; and the generated
per-point function built with the host C++ compiler (csrc/compose.cuh's
host entry) against the eager compose at every point, in both of the
forms the generator writes (straight-line and table).  On a card only
(marker ``gpu``): the kernel against the eager compose.  Tolerance zero:
field values are exact.
"""

import numpy as np
import pytest
import torch

from stark_tpu_torch import StarkConfig, StarkProver
from stark_tpu_torch.models import MODEL_NAMES, get_model
from stark_tpu_torch.models.air import Air, BoundaryConstraint, ScalarOps, record_constraints
from stark_tpu_torch.ops import compose as CO
from stark_tpu_torch.ops import cuda
from stark_tpu_torch.ops.fieldops import P
from test_torch_wide import wide_air
from torch_port_support import cuda_device, rand_field  # noqa: F401

T = 64


def config(model: str, trace_length: int = T) -> StarkConfig:
    return StarkConfig(trace_length=trace_length, blowup=get_model(model)[2])


def operands(model: str, b: int, seed: int):
    """A seeded (B, c, N) LDE and (B, terms) weights, 0 and p - 1 planted."""
    prover = StarkProver(get_model(model)[0], config(model), device="cpu")
    rng = np.random.default_rng(seed)
    lde = rand_field(rng, (b, prover.air.num_registers, prover.dom.N))
    terms = prover.program.terms
    return prover, lde, rand_field(rng, (b, terms)), rand_field(rng, (b, terms))


@pytest.fixture(scope="module")
def jax_provers():
    from stark_tpu import StarkConfig as JConfig
    from stark_tpu import StarkProver as JProver
    from stark_tpu.models import get_model as j_get_model

    return {m: JProver(j_get_model(m)[0], JConfig(trace_length=T, blowup=get_model(m)[2]))
            for m in MODEL_NAMES}


@pytest.mark.parametrize("model", MODEL_NAMES)
def test_eager_compose_matches_stark_tpu(jax_provers, model):
    import jax.numpy as jnp

    prover, lde, alphas, betas = operands(model, 1, 10)
    jp = jax_provers[model]
    want = jp._compose_impl(jnp.asarray(lde[0]), jnp.asarray(alphas[0]),
                            jnp.asarray(betas[0]), *jp._domain_consts())
    got = prover._compose(torch.from_numpy(lde[0].astype(np.int32)), alphas[0], betas[0])
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), np.asarray(want))


@pytest.mark.parametrize("model", MODEL_NAMES)
def test_eager_compose_batch_matches_vmap(jax_provers, model):
    import jax
    import jax.numpy as jnp

    prover, lde, alphas, betas = operands(model, 3, 20)
    jp = jax_provers[model]
    vmapped = jax.vmap(jp._compose_impl, in_axes=(0, 0, 0) + (None,) * 6)
    want = vmapped(jnp.asarray(lde), jnp.asarray(alphas), jnp.asarray(betas),
                   *jp._domain_consts())
    got = prover._compose(torch.from_numpy(lde.astype(np.int32)), alphas, betas)
    assert got.shape == (3, prover.dom.N)
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), np.asarray(want))


def every_air():
    airs = [(m, get_model(m)[0]) for m in MODEL_NAMES]
    return airs + [("wide65", wide_air(Air, BoundaryConstraint))]


@pytest.mark.parametrize("name, air", every_air(), ids=lambda v: v if isinstance(v, str) else "")
def test_tape_matches_scalar_ops(name, air):
    tape = record_constraints(air)
    rng = np.random.default_rng(len(name))
    for trial in range(8):
        frame = {k: [int(v) for v in rand_field(rng, air.num_registers)]
                 for k in air.frame_offsets}
        if trial == 0:
            frame = {k: [P - 1] * air.num_registers for k in air.frame_offsets}
        assert tape.evaluate(frame) == air.transition_constraints(frame, ScalarOps)


def test_tape_shares_equal_nodes_and_folds_constants():
    tape = record_constraints(get_model("mds")[0])
    assert len(set(tape.nodes)) == len(tape.nodes)
    ops = [n[0] for n in tape.nodes]
    # 16 frame inputs; per constraint 8 products by constants, 7 sums, a
    # square, an addition and a subtraction, where column 0 of the matrix
    # is 1 in every row: its product is one node for all 8 constraints
    # (8 x 8 - 7 + 8 squares = 65 products).
    assert ops.count("in") == 16 and ops.count("mul") == 65
    assert ops.count("add") == 8 * 8 and ops.count("sub") == 8
    # A commuted sum is the same node; constants fold.
    from stark_tpu_torch.models.air import Tape, TapeOps

    t = Tape()
    o = TapeOps(t)
    x, y = t.node(("in", 0, 0)), t.node(("in", 1, 0))
    assert o.add(x, y).index == o.add(y, x).index
    assert o.sub(x, y).index != o.sub(y, x).index
    two, three = o.const(2, x), o.const(P + 3, x)
    assert t.nodes[o.mul(two, three).index] == ("const", 6)
    assert t.nodes[o.neg(two).index] == ("const", P - 2)


def test_generated_source_same_bytes_per_air_and_distinct():
    sources = {}
    for name, air in every_air():
        d = StarkProver(air, StarkConfig(trace_length=T, blowup=8), device="cpu").dom
        first = CO.ComposeProgram(air, d.boundary).source
        assert CO.ComposeProgram(air, d.boundary).source == first
        sources[name] = first
    assert len(set(sources.values())) == len(sources)


def host_compose(prog, tables, lde: np.ndarray, alphas, betas, blowup: int,
                 points: int | None = None, values=None) -> np.ndarray:
    """The generated per-point function built with the host C++ compiler
    (csrc/compose.cuh's host entry), run at every point of B = lde.shape[0]
    proofs; ``points``: each row a share of that many points and its halo;
    ``values``: the proofs' boundary values (None: the default statement's)."""
    lib = CO.host_library(prog.source)
    arrs = [np.ascontiguousarray(t.numpy()) for t in
            (tables.exz, tables.xt, tables.xb, tables.dinv)]
    words = np.ascontiguousarray(prog.weights(alphas, betas))
    lde = np.ascontiguousarray(lde.astype(np.uint32))
    b, c, span = lde.shape
    vals = np.ascontiguousarray(prog.values(values, b))
    n = span if points is None else points
    out = np.zeros((b, n), dtype=np.uint32)
    rc = lib.stark_compose_host(lde.ctypes.data, *(x.ctypes.data for x in arrs),
                                out.ctypes.data, n, c, blowup, b, words.ctypes.data, span,
                                vals.ctypes.data)
    assert rc == 0
    return out


@pytest.mark.parametrize("model", MODEL_NAMES)
def test_host_built_body_matches_eager(model):
    prover, lde, alphas, betas = operands(model, 3, 30)
    want = prover._compose(torch.from_numpy(lde.astype(np.int32)), alphas, betas).numpy()
    got = host_compose(prover.program, prover.tables, lde, alphas, betas, prover.cfg.blowup)
    np.testing.assert_array_equal(got, want.astype(np.uint32))


def test_generated_form_follows_the_lines():
    # Every AIR here writes its straight-line form (well inside
    # TABLE_LINES); either form on request, the table form's bytes fixed.
    for name, air in every_air():
        d = StarkProver(air, StarkConfig(trace_length=T, blowup=8), device="cpu").dom
        prog = CO.ComposeProgram(air, d.boundary)
        assert not prog.table and prog.lines <= CO.TABLE_LINES, name
        assert "kTable = false" in prog.source
        table = CO.ComposeProgram(air, d.boundary, table=True)
        assert table.table and "kTable = true" in table.source
        assert table.source == CO.ComposeProgram(air, d.boundary, table=True).source
        assert table.lines == prog.lines and table.terms == prog.terms
    air = get_model("mds")[0]
    bound = StarkProver(air, config("mds"), device="cpu").dom.boundary
    assert CO.ComposeProgram(air, bound, table=False).source == CO.ComposeProgram(
        air, bound).source


def table_program(prover):
    """The table form of ``prover``'s AIR and boundary list."""
    return CO.ComposeProgram(prover.air, prover.program.boundary, table=True)


@pytest.mark.parametrize("model", MODEL_NAMES)
def test_host_built_table_form_matches_eager(model):
    # compose.cuh's compose_points_table: B = 3 over the whole coset, and
    # on each share of 2 with its halo.
    prover, lde, alphas, betas = operands(model, 3, 80)
    want = prover._compose(torch.from_numpy(lde.astype(np.int32)), alphas, betas).numpy()
    prog = table_program(prover)
    got = host_compose(prog, prover.tables, lde, alphas, betas, prover.cfg.blowup)
    np.testing.assert_array_equal(got, want.astype(np.uint32))
    for d in range(2):
        share, tables, cut = share_with_halo(prover, lde, d, 2)
        got = host_compose(prog, tables, share, alphas, betas, prover.cfg.blowup,
                           points=cut.stop - cut.start)
        np.testing.assert_array_equal(got, want[:, cut].astype(np.uint32))


def test_table_form_steps_and_boundaries_by_row():
    # The wide AIR: 65 transitions, 65 boundaries on row 0; a step a live
    # node that needs a value (no step for a constant that is only a
    # product's factor), its slots by liveness, the boundary terms in row
    # order with their ends.
    import re

    def steps(air, blowup):
        d = StarkProver(air, StarkConfig(trace_length=T, blowup=blowup), device="cpu").dom
        prog = CO.ComposeProgram(air, d.boundary, table=True)
        live = prog.tape.live()
        consts = sum(1 for j in live if prog.tape.nodes[j][0] == "const")
        got = [int(re.search(rf"{k} = (\d+);", prog.source)[1]) for k in ("kSteps", "kSlots")]
        return prog, got, len(live), consts

    # MDS: 49 constants, 8 of them read by a sum, the rest only factors;
    # its live set at most 10 values wide.
    _, got, live, consts = steps(get_model("mds")[0], 8)
    assert (live, consts, got) == (202, 49, [161, 10])
    # wide: every constant is read by a subtraction; each constraint's
    # value is its term at once.
    air = wide_air(Air, BoundaryConstraint)
    prog, got, live, _ = steps(air, 4)
    assert got[0] == live and got[1] < live
    assert "kRowEnds[1] = {\n    65,\n};" in prog.source
    rng = np.random.default_rng(66)
    prover = StarkProver(air, StarkConfig(trace_length=T, blowup=4), device="cpu")
    lde = rand_field(rng, (2, air.num_registers, prover.dom.N))
    alphas, betas = (rand_field(rng, (2, prog.terms)) for _ in range(2))
    want = prover._compose(torch.from_numpy(lde.astype(np.int32)), alphas, betas).numpy()
    got = host_compose(prog, prover.tables, lde, alphas, betas, 4)
    np.testing.assert_array_equal(got, want.astype(np.uint32))


def share_with_halo(prover, lde: np.ndarray, d: int, size: int):
    """Rank d's share of a (B, c, N) LDE over ``size`` ranks with its halo
    (the next share's first max offset x blowup points, rank 0's behind the
    last share), its tables, and its points (parallel/pstark.py)."""
    n, m = prover.dom.N, prover.dom.N // size
    reach = prover.air.max_offset * prover.cfg.blowup
    cols = (d * m + np.arange(m + reach)) % n
    return (np.ascontiguousarray(lde[..., cols]), prover._tables(d * m, m),
            slice(d * m, (d + 1) * m))


@pytest.mark.parametrize("model", MODEL_NAMES)
@pytest.mark.parametrize("size", [2, 4])
def test_share_with_halo_matches_eager(model, size):
    # Every rank's share, the last one's halo wrapping to rank 0: the plain
    # version and the host-built body on a (B, c, share + halo) buffer.
    prover, lde, alphas, betas = operands(model, 3, 60 + size)
    want = prover._compose(torch.from_numpy(lde.astype(np.int32)), alphas, betas).numpy()
    for d in range(size):
        share, tables, cut = share_with_halo(prover, lde, d, size)
        m = cut.stop - cut.start
        plain = CO.compose_plain(prover.program, torch.from_numpy(share.astype(np.int32)),
                                 tables, alphas, betas, prover.cfg.blowup, points=m)
        np.testing.assert_array_equal(plain.numpy(), want[:, cut])
        got = host_compose(prover.program, tables, share, alphas, betas, prover.cfg.blowup,
                           points=m)
        np.testing.assert_array_equal(got, want[:, cut].astype(np.uint32))


def blowups(model: str):
    return [b for b in (4, 8, 16) if b >= get_model(model)[2]]


@pytest.fixture(scope="module")
def jax_wide():
    from stark_tpu import StarkConfig as JConfig
    from stark_tpu import StarkProver as JProver
    from stark_tpu.models.air import Air as JAir
    from stark_tpu.models.air import BoundaryConstraint as JBoundary

    return {b: JProver(wide_air(JAir, JBoundary), JConfig(trace_length=T, blowup=b))
            for b in (4, 8)}


# The kernel's per-point function (host build: the lazy sums of the
# generated body) against stark_tpu at every AIR, at each blowup an AIR
# allows among 4, 8 and 16 (StarkConfig refuses blowup 2 in both packages;
# test_host_built_body_at_blowup_2 takes it below the config), one proof
# and B = 3 against jax.vmap.
CASES = [(m, bl, b) for m in MODEL_NAMES for bl in blowups(m) for b in (1, 3)] + [
    ("wide65", bl, b) for bl in (4, 8) for b in (1, 3)]


@pytest.mark.parametrize("model, blowup, b", CASES)
def test_host_built_body_matches_stark_tpu(jax_provers, jax_wide, model, blowup, b):
    import jax
    import jax.numpy as jnp
    from stark_tpu import StarkConfig as JConfig
    from stark_tpu import StarkProver as JProver
    from stark_tpu.models import get_model as j_get_model

    if model == "wide65":
        air, jp = wide_air(Air, BoundaryConstraint), jax_wide[blowup]
    else:
        air = get_model(model)[0]
        jp = (jax_provers[model] if blowup == get_model(model)[2] else
              JProver(j_get_model(model)[0], JConfig(trace_length=T, blowup=blowup)))
    prover = StarkProver(air, StarkConfig(trace_length=T, blowup=blowup), device="cpu")
    rng = np.random.default_rng(blowup * 10 + b)
    lde = rand_field(rng, (b, air.num_registers, prover.dom.N))
    alphas, betas = (rand_field(rng, (b, prover.program.terms)) for _ in range(2))
    got = host_compose(prover.program, prover.tables, lde, alphas, betas, blowup)
    if b == 1:
        want = jp._compose_impl(jnp.asarray(lde[0]), jnp.asarray(alphas[0]),
                                jnp.asarray(betas[0]), *jp._domain_consts())[None]
    else:
        want = jax.vmap(jp._compose_impl, in_axes=(0, 0, 0) + (None,) * 6)(
            jnp.asarray(lde), jnp.asarray(alphas), jnp.asarray(betas), *jp._domain_consts())
    np.testing.assert_array_equal(got, np.asarray(want))


def tables_at(air, trace_length: int, blowup: int):
    """K11's tables and program for a coset of ``blowup`` times the trace
    domain, built without a StarkConfig (which takes blowup >= 4), with
    the degree shifts of a domain at blowup 8 (every example AIR takes it)."""
    from stark_tpu_torch.ops.fieldops import GENERATOR, primitive_nth_root
    from stark_tpu_torch.stark import _Domain

    d = _Domain(StarkConfig(trace_length=trace_length, blowup=8), air)
    n = trace_length * blowup
    tables = CO.Tables.build(
        n=n, trace_length=trace_length, blowup=blowup, offset=GENERATOR,
        omega_n=primitive_nth_root(n), omega_t=d.omega, excluded=d.excluded,
        shift_t=d.transition_shift, shift_b=d.boundary_shift,
        rows=list(dict.fromkeys(int(bc.row) for bc in d.boundary)), device="cpu")
    return CO.ComposeProgram(air, d.boundary), tables


@pytest.mark.parametrize("model", MODEL_NAMES)
@pytest.mark.parametrize("b", [1, 3])
def test_host_built_body_at_blowup_2(model, b):
    air = get_model(model)[0]
    prog, tables = tables_at(air, T, 2)
    rng = np.random.default_rng(b)
    lde = rand_field(rng, (b, air.num_registers, 2 * T))
    alphas, betas = (rand_field(rng, (b, prog.terms)) for _ in range(2))
    want = CO.compose_plain(prog, torch.from_numpy(lde.astype(np.int32)), tables,
                            alphas, betas, 2)
    np.testing.assert_array_equal(host_compose(prog, tables, lde, alphas, betas, 2),
                                  want.numpy().astype(np.uint32))


@pytest.mark.parametrize("model, blowup", [(m, bl) for m in MODEL_NAMES for bl in blowups(m)])
def test_tables_match_stark_tpu_domain_consts(jax_provers, model, blowup):
    # Tables.build (exz = excl zinv, x^s_t, x^s_b, a dinv row per distinct
    # boundary row) against stark_tpu's domain constants.
    from stark_tpu import StarkConfig as JConfig
    from stark_tpu import StarkProver as JProver
    from stark_tpu.models import get_model as j_get_model

    prover = StarkProver(get_model(model)[0], StarkConfig(trace_length=T, blowup=blowup),
                         device="cpu")
    jp = JProver(j_get_model(model)[0], JConfig(trace_length=T, blowup=blowup))
    x_dom, zinv, excl, xt, xb, dinv = (np.asarray(a).astype(np.int64)
                                       for a in jp._domain_consts())
    t = prover.tables
    np.testing.assert_array_equal(t.exz.numpy(), excl * zinv % P)
    np.testing.assert_array_equal(t.xt.numpy(), xt)
    np.testing.assert_array_equal(t.xb.numpy(), xb)
    rows = [int(bc.row) for bc in prover.dom.boundary]
    for j, g in enumerate(prover.program.groups):
        assert rows[j] == prover.program.rows[g]
        np.testing.assert_array_equal(t.dinv[g].numpy(), dinv[j])


class LongSumAir(Air):
    """Sums past the lazy limit: 20 registers, two constraints built on a
    sum of 20 products by p - 1 and p - 2 (the largest coefficients), one
    squaring it, and a boundary a register on one row (a row sum of 21
    terms)."""

    num_registers = 20
    frame_offsets = (0, 1)
    constraint_degree = 2

    def transition_constraints(self, frame, ops):
        acc = None
        for j in range(self.num_registers):
            term = ops.mul(frame[0][j], ops.const(P - 1 - (j % 2), frame[0][j]))
            acc = term if acc is None else ops.add(acc, term)
        return [ops.sub(frame[1][0], ops.mul(acc, acc)), acc]

    def boundary_constraints(self, trace_length):
        return [BoundaryConstraint(row=0, register=j, value=0)
                for j in range(self.num_registers)]


def test_lazy_sums_fold_past_sixteen_products():
    air = LongSumAir()
    prover = StarkProver(air, StarkConfig(trace_length=T, blowup=8), device="cpu")
    prog = prover.program
    assert prog.source.count("stark::fold64") == 1   # the 20-term sum, once
    assert CO.lazy_folds(16) == 0 and CO.lazy_folds(17) == 1 and CO.lazy_folds(31) == 2
    n = prover.dom.N
    worst = np.full((2, air.num_registers, n), P - 1, dtype=np.int64)
    rng = np.random.default_rng(3)
    mixed = rand_field(rng, (2, air.num_registers, n))
    for lde in (worst, mixed):
        w = np.full((2, prog.terms), P - 1, dtype=np.int64)
        for alphas, betas in ((w, w), (rand_field(rng, w.shape), w)):
            want = prover._compose(torch.from_numpy(lde.astype(np.int32)), alphas, betas)
            np.testing.assert_array_equal(
                host_compose(prog, prover.tables, lde, alphas, betas, 8),
                want.numpy().astype(np.uint32))


class DeepAir(Air):
    """Frame depth 2 (two excluded points, two frame offsets past 0):
    s[i + 2] = s[i + 1] + s[i]."""

    num_registers = 1
    frame_offsets = (0, 1, 2)
    constraint_degree = 1

    def transition_constraints(self, frame, ops):
        return [ops.sub(frame[2][0], ops.add(frame[1][0], frame[0][0]))]

    def boundary_constraints(self, trace_length):
        return [BoundaryConstraint(row=0, register=0, value=1),
                BoundaryConstraint(row=1, register=0, value=1)]


@pytest.mark.parametrize("b", [1, 3])
def test_host_built_body_with_two_excluded_points(b):
    prover = StarkProver(DeepAir(), StarkConfig(trace_length=T, blowup=4), device="cpu")
    assert prover.dom.max_off == 2 and len(prover.dom.excluded) == 2
    rng = np.random.default_rng(b)
    lde = rand_field(rng, (b, 1, prover.dom.N))
    alphas, betas = (rand_field(rng, (b, prover.program.terms)) for _ in range(2))
    want = prover._compose(torch.from_numpy(lde.astype(np.int32)), alphas, betas).numpy()
    np.testing.assert_array_equal(
        host_compose(prover.program, prover.tables, lde, alphas, betas, 4),
        want.astype(np.uint32))


def test_generated_body_sums_mds_rows_lazily():
    prog = StarkProver(get_model("mds")[0], config("mds"), device="cpu").program
    # 8 lazy row sums of 8 products each, 8 squares, no Shoup product left.
    assert prog.source.count("stark::reduce64") == 8
    assert prog.source.count("stark::mul_mod") == 8
    assert "shoup_mul" not in prog.source
    assert prog.operations() < 702   # the eager body's count (PR 8)


def test_tables_one_dinv_per_distinct_row():
    mds = StarkProver(get_model("mds")[0], config("mds"), device="cpu")
    fib = StarkProver(get_model("fib")[0], config("fib"), device="cpu")
    assert mds.program.rows == [0] and tuple(mds.tables.dinv.shape) == (1, mds.dom.N)
    assert fib.program.rows == [0, 1] and tuple(fib.tables.dinv.shape) == (2, fib.dom.N)
    assert all(t.dtype == torch.int32 for t in
               (mds.tables.exz, mds.tables.xt, mds.tables.xb, mds.tables.dinv))


def test_weights_words():
    prog = StarkProver(get_model("fib")[0], config("fib"), device="cpu").program
    words = prog.weights([[5, 6, 7]], [[P - 1, 0, 1]]).astype(np.int64)
    r = (1 << 32) % P
    assert words.shape == (1, 12)
    assert list(words[0, 0::4]) == [5 * r * r % P, 6 * r * r % P, 7 * r * r % P]
    assert list(words[0, 2::4]) == [(P - 1) * r % P, 0, r]
    assert all(words[0, 1::2] == (words[0, 0::2] << 32) // P)
    with pytest.raises(ValueError):
        prog.weights([1, 2], [3, 4])


@pytest.mark.gpu
@pytest.mark.parametrize("model", MODEL_NAMES)
@pytest.mark.parametrize("b", [1, 3, 32])
def test_kernel_matches_eager_on_card(cuda_device, model, b):
    prover, lde, alphas, betas = operands(model, b, 40 + b)
    want = prover._compose(torch.from_numpy(lde.astype(np.int32)), alphas, betas)
    card = StarkProver(prover.air, prover.cfg, cuda_device)
    before = cuda.launch_counts()["compose"]
    x = torch.from_numpy(lde.astype(np.int32)).to(cuda_device)
    for _ in range(2):
        got = card._compose(x, alphas, betas)
        assert torch.equal(got.cpu(), want)
    single = card._compose(x[0], alphas[0], betas[0])
    assert torch.equal(single.cpu(), want[0])
    assert cuda.launch_counts()["compose"] == before + 3


@pytest.mark.gpu
@pytest.mark.parametrize("model", MODEL_NAMES)
def test_table_form_kernel_matches_eager_on_card(cuda_device, model):
    # The table form built with nvcc: B = 3 on the whole coset and on the
    # last of 4 shares with its halo.
    prover, lde, alphas, betas = operands(model, 3, 90)
    want = prover._compose(torch.from_numpy(lde.astype(np.int32)), alphas, betas)
    card = StarkProver(prover.air, prover.cfg, cuda_device)
    prog = table_program(card)
    x = torch.from_numpy(lde.astype(np.int32)).to(cuda_device)
    got = CO.compose(prog, x, card.tables, alphas, betas, prover.cfg.blowup)
    assert torch.equal(got.cpu(), want)
    share, _, cut = share_with_halo(prover, lde, 3, 4)
    got = CO.compose(prog, torch.from_numpy(share.astype(np.int32)).to(cuda_device),
                     card._tables(cut.start, cut.stop - cut.start), alphas, betas,
                     prover.cfg.blowup, points=cut.stop - cut.start)
    assert torch.equal(got.cpu(), want[:, cut])


@pytest.mark.gpu
def test_wide_kernel_matches_eager_on_card(cuda_device):
    air = wide_air(Air, BoundaryConstraint)
    cfg = StarkConfig(trace_length=T, blowup=4)
    prover = StarkProver(air, cfg, device="cpu")
    rng = np.random.default_rng(65)
    lde = torch.from_numpy(rand_field(rng, (air.num_registers, prover.dom.N)).astype(np.int32))
    alphas, betas = (rand_field(rng, prover.program.terms) for _ in range(2))
    want = prover._compose(lde, alphas, betas)
    got = StarkProver(air, cfg, cuda_device)._compose(lde.to(cuda_device), alphas, betas)
    assert torch.equal(got.cpu(), want)


@pytest.mark.gpu
@pytest.mark.parametrize("model, trace_length, b", [("fib", 1 << 20, 1), ("mds", 1 << 16, 1),
                                                    ("fib", 1 << 14, 8)])
def test_kernel_at_the_paths_shapes_on_card(cuda_device, model, trace_length, b):
    # Fibonacci T=2^20 and MDS T=2^16 proves, batch8's (8, 1, 2^16).
    air = get_model(model)[0]
    card = StarkProver(air, StarkConfig(trace_length=trace_length, blowup=4), cuda_device)
    rng = np.random.default_rng(trace_length + b)
    lde = torch.from_numpy(rand_field(rng, (b, air.num_registers, card.dom.N)).astype(
        np.int32)).to(cuda_device)
    alphas, betas = (rand_field(rng, (b, card.program.terms)) for _ in range(2))
    want = CO.compose_plain(card.program, lde, card.tables, alphas, betas, 4)
    assert torch.equal(card._compose(lde, alphas, betas), want)


@pytest.mark.gpu
@pytest.mark.parametrize("model", MODEL_NAMES)
def test_kernel_on_a_share_with_halo_on_card(cuda_device, model):
    prover, lde, alphas, betas = operands(model, 3, 70)
    want = prover._compose(torch.from_numpy(lde.astype(np.int32)), alphas, betas)
    card = StarkProver(prover.air, prover.cfg, cuda_device)
    share, _, cut = share_with_halo(prover, lde, 3, 4)
    tables = card._tables(cut.start, cut.stop - cut.start)
    got = CO.compose(card.program, torch.from_numpy(share.astype(np.int32)).to(cuda_device),
                     tables, alphas, betas, prover.cfg.blowup, points=cut.stop - cut.start)
    assert torch.equal(got.cpu(), want[:, cut])


@pytest.mark.gpu
def test_kernel_splits_weights_over_launches_on_card(cuda_device):
    # 130 MDS proofs' weights (64 words each), more than the 8,000 words a
    # launch's parameters held when the weights rode there: read from
    # device memory now, one launch takes them all.
    prover, lde, alphas, betas = operands("mds", 130, 50)
    want = prover._compose(torch.from_numpy(lde.astype(np.int32)), alphas, betas)
    card = StarkProver(prover.air, prover.cfg, cuda_device)
    before = cuda.launch_counts()["compose"]
    got = card._compose(torch.from_numpy(lde.astype(np.int32)).to(cuda_device), alphas, betas)
    assert torch.equal(got.cpu(), want)
    assert cuda.launch_counts()["compose"] == before + 1
