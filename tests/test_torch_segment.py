"""Public inputs as data: the Fibonacci segment AIR (``fib_segment``) and
every statement of a shape through one K11 build and one graph a slot.

On the CPU at T = 2^6 and 2^8: the port's segment proofs through
``StarkProver.prove``, ``BatchStarkProver.prove_batch``, ``prove_many``
(depth 2) and ``prove_stream`` over seeded start pairs equal the plain
reference's (benchmark/reference, airs/fibonacci_segment.py) statement by
statement, and ``stark_tpu``'s through a subclass of its FibonacciAir with
the four boundaries made here (JAX in the test only); the verifier holds
each proof to its own public inputs; one prover proves every statement with
no further build; the device witness and its end pair equal the
reference's walk at awkward start pairs, the end pair made in O(1) from
the length's basis equals every block's seeds combined, and a second
statement at a length makes no basis; K11's three forms (straight-line,
table, a share with its halo), built with the host compiler, take each
proof's values; and every existing AIR's default statement keeps the bytes
it had while its boundary values were compiled into K11 (pinned).  Marked
``gpu``: the same on a card, one K11 build and one capture a slot.
"""

from __future__ import annotations

import hashlib
import random

import numpy as np
import pytest
import torch

from benchmark.reference import prover as R
from benchmark.reference.airs import fibonacci_segment as RS
from stark_tpu_torch import StarkConfig, StarkProver, StarkVerifier
from stark_tpu_torch.batch import BatchStarkProver
from stark_tpu_torch.models import MODEL_NAMES, get_model
from stark_tpu_torch.models.air import BoundaryConstraint
from stark_tpu_torch.models import fibonacci as FIB
from stark_tpu_torch.models.fibonacci import (
    FibonacciSegmentAir,
    fibonacci_seeds,
    fibonacci_segment_cols_device,
    fibonacci_segment_end,
    fibonacci_trace_cols_device,
    fibonacci_trace_mod_p,
)
from stark_tpu_torch.ops import compose as CO
from stark_tpu_torch.ops import cuda
from stark_tpu_torch.ops.fieldops import P
from torch_port_support import cuda_device, rand_field  # noqa: F401

SIZES = [(64, 16), (256, 64)]
#: Six start pairs drawn from a seed, the first two awkward.
STARTS = [(0, 0), (P - 1, P - 1)] + [
    (r.randrange(P), r.randrange(P)) for r in [random.Random(2**31 + 25)] for _ in range(4)]


def publics(T: int) -> list[tuple]:
    return [(*s, *fibonacci_segment_end(T, s)) for s in STARTS]


def config(T: int, tests: int) -> StarkConfig:
    return StarkConfig(trace_length=T, blowup=4, num_colinearity_tests=tests)


def reference(T: int, tests: int, public) -> bytes:
    st = R.Statement(RS, T, 4, tests, public)
    return R.prove(st, torch.from_numpy(st.witness().astype(np.int64)))


def witness(T: int, public, device="cpu") -> torch.Tensor:
    cols, end = fibonacci_segment_cols_device(T, public[:2], device=device)
    assert end == tuple(public[2:])
    return cols


@pytest.fixture(scope="module")
def references() -> dict:
    return {(T, tests): [reference(T, tests, pub) for pub in publics(T)]
            for T, tests in SIZES}


@pytest.mark.parametrize("T,tests", SIZES)
def test_segment_proofs_equal_the_reference(references, T, tests):
    pubs, want = publics(T), references[(T, tests)]
    assert len(set(want)) == len(want) == 6
    cfg = config(T, tests)
    single = StarkProver(FibonacciSegmentAir(), cfg, device="cpu")
    assert [single.prove(trace_cols=witness(T, p), public=p) for p in pubs] == want
    batch = BatchStarkProver(FibonacciSegmentAir(), cfg, batch=3, device="cpu")
    got = [proof for lo in (0, 3) for proof in batch.prove_batch(
        traces_cols=[witness(T, p) for p in pubs[lo:lo + 3]], publics=pubs[lo:lo + 3])]
    assert got == want
    many = BatchStarkProver(FibonacciSegmentAir(), cfg, batch=4, device="cpu")
    assert many.prove_many(traces_cols=[witness(T, p) for p in pubs], depth=2,
                           publics=pubs) == want
    # the generator form, fed lazily, a batch's list at a time (the last
    # one padded and cut)
    batches = list(many.prove_stream(((witness(T, p), p) for p in pubs), depth=2))
    assert [len(b) for b in batches] == [4, 2] and sum(batches, []) == want


@pytest.mark.parametrize("path", ["three reads", "two reads"])
def test_every_read_path_takes_the_statement(references, path):
    # fused_round off: the challenges drawn on the host; 32 tests at T=64:
    # one FRI round, not chainable
    T, tests = (64, 16) if path == "three reads" else (64, 32)
    prover = BatchStarkProver(FibonacciSegmentAir(), config(T, tests), batch=2, device="cpu")
    prover.fri.fused_round = path != "three reads"
    pubs = publics(T)[:2] if path == "three reads" else publics(T)[2:4]
    want = (references[(T, tests)][:2] if path == "three reads" else
            [reference(T, tests, p) for p in pubs])
    assert prover.prove_batch(traces_cols=[witness(T, p) for p in pubs], publics=pubs) == want


def test_segment_proofs_equal_stark_tpu(references):
    from stark_tpu import StarkConfig as JConfig
    from stark_tpu import StarkProver as JProver
    from stark_tpu.models.air import BoundaryConstraint as JBoundary
    from stark_tpu.models.fibonacci import FibonacciAir as JFibonacci

    class JSegment(JFibonacci):
        """stark_tpu's FibonacciAir with the segment's four boundaries."""

        def __init__(self, public):
            self.public = public

        def boundary_constraints(self, trace_length):
            a, b, y, z = self.public
            return [JBoundary(0, 0, a), JBoundary(1, 0, b),
                    JBoundary(trace_length - 2, 0, y), JBoundary(trace_length - 1, 0, z)]

    T, tests = SIZES[0]
    for pub, want in zip(publics(T), references[SIZES[0]], strict=True):
        prover = JProver(JSegment(pub), JConfig(trace_length=T, blowup=4,
                                                num_colinearity_tests=tests))
        rows = witness(T, pub).numpy().T.astype(np.uint32)
        assert prover.prove(rows) == want


@pytest.mark.parametrize("T,tests", SIZES)
def test_the_verifier_holds_each_proof_to_its_statement(references, T, tests):
    verifier = StarkVerifier(FibonacciSegmentAir(), config(T, tests))
    pubs, proofs = publics(T), references[(T, tests)]
    assert verifier.verify_batch(proofs, publics=pubs) == [True] * 6
    for k, (pub, proof) in enumerate(zip(pubs, proofs)):
        assert verifier.verify(proof, public=pub)
        end = (*pub[:3], (pub[3] + 1) % P)
        assert not verifier.verify(proof, public=end)
        assert not verifier.verify(proof, public=pubs[(k + 1) % 6])
    assert not any(verifier.verify_batch(proofs, publics=pubs[1:] + pubs[:1]))


def test_a_false_statement_is_rejected():
    # The prover proves what it is told: a wrong end pair gives a proof of a
    # false statement, which the verifier rejects; the reference has no
    # witness for it.
    T, tests = SIZES[1]
    pub = publics(T)[2]
    wrong = (*pub[:2], (pub[2] + 1) % P, pub[3])
    prover = StarkProver(FibonacciSegmentAir(), config(T, tests), device="cpu")
    proof = prover.prove(trace_cols=witness(T, pub), public=wrong)
    verifier = StarkVerifier(FibonacciSegmentAir(), config(T, tests))
    assert not verifier.verify(proof, public=wrong)
    assert not verifier.verify(proof, public=pub)
    with pytest.raises(ValueError, match="false statement"):
        RS.trace(T, wrong)


def test_public_inputs_set_values_not_rows():
    class Moving(FibonacciSegmentAir):
        def boundary_constraints(self, trace_length, public=None):
            got = super().boundary_constraints(trace_length, public)
            return got if public is None else got[:3] + [BoundaryConstraint(5, 0, 1)]

    prover = StarkProver(Moving(), config(64, 16), device="cpu")
    with pytest.raises(ValueError, match="rows or registers"):
        prover.prove(trace_cols=witness(64, publics(64)[0]), public=publics(64)[0])
    air, trace_fn, blowup = get_model("fib_segment")
    default = StarkProver(air, StarkConfig(trace_length=64, blowup=blowup,
                                           num_colinearity_tests=16), device="cpu")
    assert default.dom.values() == list(RS.default(64))
    assert default.prove(trace_fn(64)) == reference(64, 16, None)


def test_one_build_serves_every_statement(monkeypatch):
    captures = []
    monkeypatch.setattr(cuda.Graph, "__init__", lambda *a, **k: captures.append(a))
    T, tests = SIZES[0]
    prover = BatchStarkProver(FibonacciSegmentAir(), config(T, tests), batch=2, device="cpu")
    source, builds = prover._single.program.source, dict(CO.BUILD_SECONDS)
    pubs = publics(T)
    first = prover.prove_many(traces_cols=[witness(T, p) for p in pubs[:2]], publics=pubs[:2])
    rest = prover.prove_many(traces_cols=[witness(T, p) for p in pubs[2:]], publics=pubs[2:])
    assert first + rest == [reference(T, tests, p) for p in pubs]
    assert prover._single.program.source == source and CO.BUILD_SECONDS == builds
    assert not captures and [len(s) for s in prover._single._slots.values()] == [2]
    assert "stark_air" in source and "boundary_value" not in source


@pytest.mark.parametrize("start", [(0, 0), (P - 1, P - 1), (123456789, 123456789), (1, 1),
                                   (0, 1)])
@pytest.mark.parametrize("T", [64, 256])
def test_device_witness_and_end_pair_equal_the_reference(T, start):
    cols, end = fibonacci_segment_cols_device(T, start, device="cpu")
    want = RS.trace(T, (*start, *end))
    assert cols.dtype == torch.int32 and cols.shape == (1, T)
    np.testing.assert_array_equal(cols.numpy().astype(np.uint32), want)
    assert end == RS.end_pair(T, start)
    np.testing.assert_array_equal(fibonacci_trace_mod_p(T, start).T, want)


def _end_from_every_seed(T: int, start) -> tuple[int, int]:
    """The end pair as the segment path made it before the basis went to the
    card: every block's seeds combined on the host from the default run's
    (fibonacci_seeds), then the last rows' values."""
    seeds, nb = fibonacci_seeds(T)
    b = (len(seeds) - 2 * nb) // 2
    f0 = seeds[:nb].astype(np.int64)
    fm1 = (seeds[nb : 2 * nb] - f0) % P
    fm2 = (f0 - fm1) % P
    x, y = (int(v) % P for v in start)
    s1, s0 = (x * fm1 + y * f0) % P, (x * fm2 + y * fm1) % P
    u = seeds[2 * nb :]

    def value(i):
        k, j = divmod(i, b)
        return (int(s1[k]) * int(u[b + j]) + int(s0[k]) * int(u[j])) % P

    return value(T - 2), value(T - 1)


@pytest.mark.parametrize("T", [64, 256, 1 << 20])
def test_the_end_pair_in_o1_equals_every_seed_combined(T):
    for start in STARTS + [(1, 1), (0, 1)]:
        assert fibonacci_segment_end(T, start) == _end_from_every_seed(T, start)
    if T <= 256:
        assert fibonacci_segment_end(T, STARTS[2]) == tuple(
            int(v) for v in fibonacci_trace_mod_p(T, STARTS[2])[-2:, 0])


@pytest.mark.parametrize("T", [64, 1000])
def test_a_second_statement_builds_no_basis(T):
    """The length's basis is made once a (length, device): the first
    witness at a length may make it, no later statement does."""
    first = fibonacci_segment_cols_device(T, STARTS[3], device="cpu")
    builds = FIB.BASIS_BUILDS
    for start in STARTS[:3] + [(1, 1)]:
        fibonacci_segment_cols_device(T, start, device="cpu")
    assert fibonacci_trace_cols_device(T, device="cpu").shape == (1, T)
    fibonacci_segment_end(T, STARTS[4])
    assert FIB.BASIS_BUILDS == builds
    assert torch.equal(fibonacci_segment_cols_device(T, STARTS[3], device="cpu")[0], first[0])


@pytest.mark.parametrize("form", ["straight", "table"])
def test_k11_forms_take_each_proofs_values(form):
    from test_torch_compose import host_compose, share_with_halo

    T = 64
    prover = StarkProver(FibonacciSegmentAir(), config(T, 16), device="cpu")
    prog = CO.ComposeProgram(prover.air, prover.dom.boundary, table=form == "table")
    rng = np.random.default_rng(25)
    lde = rand_field(rng, (3, 1, prover.dom.N))
    alphas, betas = (rand_field(rng, (3, prog.terms)) for _ in range(2))
    values = [prover.dom.values(p) for p in publics(T)[:3]]
    words = torch.from_numpy(prog.values(values))
    want = CO.compose_plain(prog, torch.from_numpy(lde.astype(np.int32)), prover.tables,
                            alphas, betas, 4, values=words).numpy()
    for j in range(3):  # each proof alone
        alone = CO.compose_plain(prog, torch.from_numpy(lde[j].astype(np.int32)),
                                 prover.tables, alphas[j], betas[j], 4, values=words[j:j + 1])
        np.testing.assert_array_equal(alone.numpy(), want[j])
    assert not np.array_equal(want, CO.compose_plain(
        prog, torch.from_numpy(lde.astype(np.int32)), prover.tables, alphas, betas, 4).numpy())
    np.testing.assert_array_equal(host_compose(prog, prover.tables, lde, alphas, betas, 4,
                                               values=values), want.astype(np.uint32))
    for d in range(2):
        share, tables, cut = share_with_halo(prover, lde, d, 2)
        got = host_compose(prog, tables, share, alphas, betas, 4,
                           points=cut.stop - cut.start, values=values)
        np.testing.assert_array_equal(got, want[:, cut].astype(np.uint32))


#: sha256 of each existing AIR's default statement, made with its boundary
#: values compiled into K11's source: its proof (T=64, 8 tests, the
#: model's blowup, from host rows), and K11's host build, straight-line and
#: table form alike, on a seeded (3, c, N) LDE (compose_pins).
PINNED = {
    "fib": ("e91a0d5996b203c70b86c66c15721b19bb4814ea03fce7315378940e2ecbc9e4",
            "c99c3f3cb61ce55108a3dd0dd5614a28078d7f0b47281345d888a42f68d43a2d"),
    "fib2": ("3e258a5e40fafe763c74c423ac28ad3bdda624da0f232b5be205f53ae3a57582",
             "63b8e5656563da5cfeb147b9e492bc82329441a9eeb6a863f820fb8bd092850a"),
    "square": ("487d3865bfafb5afd3d74292428e3d2cf8d836e1186e9f4d5a21387821775c79",
               "f465fe2ad8505e7cf65f5882a15b97fe0f1f214387dc7b2ed1bd5880c831a368"),
    "cube": ("48fd5cce856601bca004d048733f38826a6d794c1f994c5a63ce290fb968c255",
             "6c8194224aebfd125f3ca58922284587b61eee30c30c7b2da63d6f5c8a3ddcbf"),
    "mds": ("42a2e384a82f7606f8e2357d00923bf046ef171be3ec615e4ccff4b447772a5f",
            "d9ef9f92de387be4298947271b0a9a66bc02490f489e9876f28f96b280936118"),
}


def compose_pins(prover, table: bool) -> str:
    from test_torch_compose import host_compose

    rng = np.random.default_rng(7)
    air = prover.air
    lde = rng.integers(0, P, size=(3, air.num_registers, prover.dom.N)).astype(np.uint32)
    al, be = (rng.integers(0, P, size=(3, prover.program.terms)) for _ in range(2))
    prog = CO.ComposeProgram(air, prover.program.boundary, table=table)
    out = host_compose(prog, prover.tables, lde, al, be, prover.cfg.blowup)
    return hashlib.sha256(out.tobytes()).hexdigest()


@pytest.mark.parametrize("model", MODEL_NAMES)
def test_default_statements_keep_their_bytes(model):
    assert set(PINNED) == set(MODEL_NAMES)
    air, trace_fn, blowup = get_model(model)
    cfg = StarkConfig(trace_length=64, blowup=blowup, num_colinearity_tests=8)
    prover = StarkProver(air, cfg, device="cpu")
    proof = prover.prove(trace_fn(64))
    assert hashlib.sha256(proof).hexdigest() == PINNED[model][0]
    assert prover.prove(trace_fn(64), public=None) == proof
    assert StarkVerifier(air, cfg).verify(proof)
    assert compose_pins(prover, False) == compose_pins(prover, True) == PINNED[model][1]


@pytest.mark.gpu
def test_statements_on_a_card_build_and_capture_once(cuda_device):
    """B = 4, depth 2, T = 2^10: the card's proofs of nine statements equal
    the CPU's; K11 is built at most once and each of the 3 slots captured
    once, at its second batch."""
    T, tests = 1 << 10, 16
    cfg = config(T, tests)
    pubs = [(*s, *fibonacci_segment_end(T, s)) for s in
            [(r.randrange(P), r.randrange(P)) for r in [random.Random(9)] for _ in range(36)]]
    cpu = StarkProver(FibonacciSegmentAir(), cfg, device="cpu")
    want = [cpu.prove(trace_cols=witness(T, p), public=p) for p in pubs]
    prover = BatchStarkProver(FibonacciSegmentAir(), cfg, batch=4, device=cuda_device)
    first = prover.prove_many(traces_cols=[witness(T, p, cuda_device) for p in pubs[:4]],
                              publics=pubs[:4])
    builds = dict(CO.BUILD_SECONDS)
    got = prover.prove_many(traces_cols=[witness(T, p, cuda_device) for p in pubs[4:]],
                            publics=pubs[4:])
    assert first + got == want
    assert CO.BUILD_SECONDS == builds
    slots = prover._single._slots[4]
    assert len(slots) == 3 and all(s.graph is not None for s in slots)
    graphs = [s.graph for s in slots]
    again = prover.prove_many(traces_cols=[witness(T, p, cuda_device) for p in pubs[:8]],
                              publics=pubs[:8])
    assert again == want[:8] and [s.graph for s in slots] == graphs
    prover.close()


def test_the_pipeline_fires_its_spans():
    """With torch's profiler on, after a warm batch a slot: each batch's
    statement (``stark.statement``), its stack (``batch.stack``), the wait
    for its read (``stark.fetch_wait``), its dispatch's root (``stark.prove``)
    and its finish (``batch.finish``), one each a batch, and no K11 build or
    capture."""
    from stark_tpu_torch.utils import profiling

    T, tests = SIZES[0]
    prover = BatchStarkProver(FibonacciSegmentAir(), config(T, tests), batch=2, device="cpu")
    items = [(witness(T, p), p) for p in publics(T)[:4]]
    warm = sum(prover.prove_stream(items, depth=2), [])
    profiling.reset_spans()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        assert sum(prover.prove_stream(items, depth=2), []) == warm
    got = profiling.snapshot_spans()
    profiling.reset_spans()
    names = ("stark.statement", "batch.stack", "batch.finish", "stark.fetch_wait",
             "stark.prove")
    assert {name: got[name][1] for name in names} == dict.fromkeys(names, 2)
    assert "compose.build" not in got and "cuda.capture" not in got
    assert warm == [reference(T, tests, p) for _, p in items]
