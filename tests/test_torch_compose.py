"""The composition codeword (kernel K11, ops/compose.py) against stark_tpu.

The port's eager compose (K11's plain version, ``StarkProver._compose``
on the CPU) against ``stark_tpu.StarkProver._compose_impl`` with its
``_domain_consts()`` on the same seeded LDE and weights, for every example
AIR at T = 64, one proof and B = 3 against ``jax.vmap`` of it; the tape
that the kernel is generated from (``models.air.TapeOps``) against
``ScalarOps`` at seeded frames, for every example AIR and the 65-register
AIR of test_torch_wide.py; the generated source's bytes; and the generated
per-point function built with the host C++ compiler (csrc/compose.cuh's
host entry) against the eager compose at every point.  On a card only
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


@pytest.mark.parametrize("model", MODEL_NAMES)
def test_host_built_body_matches_eager(model):
    prover, lde, alphas, betas = operands(model, 3, 30)
    want = prover._compose(torch.from_numpy(lde.astype(np.int32)), alphas, betas).numpy()
    prog, tables = prover.program, prover.tables
    lib = CO.host_library(prog.source)
    arrs = [np.ascontiguousarray(t.numpy()) for t in
            (tables.exz, tables.xt, tables.xb, tables.dinv)]
    words = np.ascontiguousarray(prog.weights(alphas, betas))
    lde = np.ascontiguousarray(lde)
    out = np.zeros((3, prover.dom.N), dtype=np.uint32)
    rc = lib.stark_compose_host(lde.ctypes.data, *(a.ctypes.data for a in arrs),
                                out.ctypes.data, prover.dom.N, lde.shape[1],
                                prover.cfg.blowup, 3, words.ctypes.data)
    assert rc == 0
    np.testing.assert_array_equal(out, want.astype(np.uint32))


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
def test_kernel_splits_weights_over_launches_on_card(cuda_device):
    # 130 MDS proofs' weights (64 words each) outgrow one launch's 8,000.
    prover, lde, alphas, betas = operands("mds", 130, 50)
    want = prover._compose(torch.from_numpy(lde.astype(np.int32)), alphas, betas)
    card = StarkProver(prover.air, prover.cfg, cuda_device)
    before = cuda.launch_counts()["compose"]
    got = card._compose(torch.from_numpy(lde.astype(np.int32)).to(cuda_device), alphas, betas)
    assert torch.equal(got.cpu(), want)
    assert cuda.launch_counts()["compose"] == before + 2
