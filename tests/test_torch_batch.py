"""The port's batched prover (stark_tpu_torch.BatchStarkProver) and the FRI
commit as a device chain, against stark_tpu and against the port's own
single proves.

On the CPU every kernel runs its plain version: the batch's proofs at B=2,
T=64 equal stark_tpu.batch.BatchStarkProver's byte for byte (one stark_tpu
batch prove, in a module fixture: it takes over a minute here) and the
port's single proves (Fibonacci from host rows, MdsSquareAir from column
tensors, prove_many with a padded last batch); the single prove gives the
same bytes with and without the device chain; a sponge that draws a wrong
challenge makes the replay raise; a prove reads from the device once on
the single-fetch path (twice where the FRI is not chainable) and three
times with ``Fri.fused_round`` False, one proof or a batch.  On a card (marker ``gpu``): the same proofs
through the kernels.  Tolerance zero: proofs are bytes."""

import hashlib

import numpy as np
import pytest
import torch

from stark_tpu_torch import BatchStarkProver, StarkConfig, StarkProver, StarkVerifier
from stark_tpu_torch.models import FibonacciAir, fibonacci_trace_mod_p
from stark_tpu_torch.models.air import BoundaryConstraint
from stark_tpu_torch.models.examples import MdsSquareAir, mds_square_trace_cols_device
from stark_tpu_torch.ops import cuda
from stark_tpu_torch.ops import gather as G
from stark_tpu_torch.ops import hash_batch as HB
from stark_tpu_torch.ops.fieldops import P
from torch_port_support import cuda_device  # noqa: F401

B, T = 2, 64
CFG = dict(trace_length=T, blowup=4, num_colinearity_tests=4)


class VariantFibAir(FibonacciAir):
    """Fibonacci with only row 1 pinned, so that traces with other first
    values satisfy it too (stark_tpu's tests/test_batch.py)."""

    def boundary_constraints(self, trace_length: int):
        return [BoundaryConstraint(row=1, register=0, value=1)]


def _traces(count: int, length: int = T) -> list:
    """Fibonacci-like rows from first values 1, 2, ... (stark_tpu's
    tests/test_batch.py:_traces)."""
    out = []
    for b in range(count):
        a, c, rows = 1 + b, 1, []
        for _ in range(length):
            rows.append([a])
            a, c = c, (a + c) % P
        out.append(rows)
    return out


def _single(air, cfg=CFG, device="cpu"):
    return StarkProver(air, StarkConfig(**cfg), device=device)


@pytest.fixture(scope="module")
def reference():
    """stark_tpu's batch proofs of _traces(B) (its classic path)."""
    from stark_tpu import StarkConfig as JConfig
    from stark_tpu.batch import BatchStarkProver as JBatch
    from stark_tpu.models.air import BoundaryConstraint as JBoundary
    from stark_tpu.models.fibonacci import FibonacciAir as JFib

    class JVariant(JFib):
        def boundary_constraints(self, trace_length: int):
            return [JBoundary(row=1, register=0, value=1)]

    return JBatch(JVariant(), JConfig(**CFG), B).prove_batch(_traces(B))


@pytest.fixture(scope="module")
def ours():
    return BatchStarkProver(VariantFibAir(), StarkConfig(**CFG), B, device="cpu") \
        .prove_batch(_traces(B))


@pytest.mark.parametrize("b", range(B))
def test_prove_batch_equals_stark_tpu(reference, ours, b):
    assert ours[b] == reference[b]


@pytest.mark.parametrize("b", range(B))
def test_prove_batch_equals_single_proves(ours, b):
    assert ours[b] == _single(VariantFibAir()).prove(_traces(B)[b])


def test_batch_proofs_verify_and_a_flipped_byte_is_rejected(ours):
    verifier = StarkVerifier(VariantFibAir(), StarkConfig(**CFG))
    assert verifier.verify_batch(ours) == [True] * B
    bad = bytearray(ours[1])
    bad[100] ^= 1
    assert verifier.verify_batch([ours[0], bytes(bad)]) == [True, False]


def _mds_cols() -> list:
    cols = mds_square_trace_cols_device(T, device="cpu")
    return [cols, (cols.long() * 3 + 1).remainder(P).to(torch.int32)]


def test_mds_batch_from_columns_equals_single_proves():
    # Column tensors on the prover's device (the device witness), the
    # second another witness: proofs need not verify to be held equal.
    cols = _mds_cols()
    got = BatchStarkProver(MdsSquareAir(), StarkConfig(**CFG), B, device="cpu") \
        .prove_batch(traces_cols=cols)
    single = _single(MdsSquareAir())
    assert got == [single.prove(trace_cols=c) for c in cols]
    assert StarkVerifier(MdsSquareAir(), StarkConfig(**CFG)).verify(got[0])


def test_prove_many_pads_the_last_batch_and_drops_its_pad():
    traces = _traces(3)
    prover = BatchStarkProver(VariantFibAir(), StarkConfig(**CFG), B, device="cpu")
    got = prover.prove_many(traces, depth=2)
    single = _single(VariantFibAir())
    assert got == [single.prove(t) for t in traces]
    assert prover.prove_many([]) == []


@pytest.mark.parametrize("air", [FibonacciAir(), MdsSquareAir()], ids=["fib", "mds"])
def test_device_chain_on_and_off_give_the_same_bytes(air, monkeypatch):
    from stark_tpu_torch.fri import Fri
    from stark_tpu_torch.models import get_model

    trace = get_model("fib" if isinstance(air, FibonacciAir) else "mds")[1](T)
    chained = _single(air).prove(trace)
    monkeypatch.setattr(Fri, "device_chain", False)
    calls = []
    absorb = HB.Sponge.absorb
    monkeypatch.setattr(HB.Sponge, "absorb", lambda *a, **k: calls.append(1) or absorb(*a, **k))
    assert _single(air).prove(trace) == chained
    assert not calls  # the host path draws no challenge on the device


def test_host_path_takes_one_proof_at_a_time(monkeypatch):
    from stark_tpu_torch.fri import Fri

    monkeypatch.setattr(Fri, "device_chain", False)
    with pytest.raises(ValueError, match="one codeword at a time"):
        BatchStarkProver(VariantFibAir(), StarkConfig(**CFG), B, device="cpu") \
            .prove_batch(_traces(B))


def test_a_diverging_challenge_raises(monkeypatch):
    # The card's alpha must be the transcript's: a sponge whose plain
    # version draws a wrong one stops the prove, one proof or a batch.
    plain = HB.sponge_absorb_plain

    def wrong(*args, **kwargs):
        state, pending, alpha = plain(*args, **kwargs)
        return state, pending, (alpha + 1) % P

    monkeypatch.setattr(HB, "sponge_absorb_plain", wrong)
    with pytest.raises(RuntimeError, match="device/host transcript divergence"):
        _single(FibonacciAir()).prove(_traces(1)[0])
    with pytest.raises(RuntimeError, match="device/host transcript divergence"):
        BatchStarkProver(VariantFibAir(), StarkConfig(**CFG), B, device="cpu") \
            .prove_batch(_traces(B))


@pytest.mark.parametrize("fused_round", [False, True])
@pytest.mark.parametrize("count", [1, B])
def test_three_reads_from_the_device_per_prove(monkeypatch, count, fused_round):
    # fused_round False: the trace roots, the FRI chain's one fetch, the
    # query phase's one gather, the same three for one proof and for a
    # batch.  True (the default): the single-fetch prove's one read, its
    # words the chain's, the trace roots and challenge bytes, the indices
    # and counts and the gather's; two where the FRI is not chainable (a
    # config with no FRI round: the codewords' read, then the gather).
    from stark_tpu_torch.fri import Fri

    reads = []
    to_host = G.to_host
    monkeypatch.setattr(G, "to_host",
                        lambda t, **kw: reads.append(t.numel()) or to_host(t, **kw))
    monkeypatch.setattr(Fri, "fused_round", fused_round)
    prover = BatchStarkProver(VariantFibAir(), StarkConfig(**CFG), count, device="cpu")
    prover.prove_batch(_traces(count))
    rounds = prover.fri.num_rounds()
    n_last = 4 * T >> (rounds - 1)
    chain = count * (8 * rounds + rounds - 1 + n_last)
    if not fused_round:
        assert len(reads) == 3
        assert reads[0] == 8 * count                                # the roots
        assert reads[1] == chain                                    # the chain
        return
    terms = prover._single.program.terms
    tests = CFG["num_colinearity_tests"]
    plan = prover._single._rule_plan(count)[0]
    assert reads == [chain + count * (8 + 4 * terms + tests + 1) + plan.words]
    reads.clear()
    zero = StarkConfig(**ZERO_ROUND_CFGS[0])
    BatchStarkProver(VariantFibAir(), zero, count, device="cpu").prove_batch(
        _traces(count, zero.trace_length))
    assert len(reads) == 2


def test_batch_input_is_checked():
    prover = BatchStarkProver(VariantFibAir(), StarkConfig(**CFG), B, device="cpu")
    with pytest.raises(ValueError):
        prover.prove_batch(_traces(1))
    with pytest.raises(ValueError):
        prover.prove_batch(_traces(B), traces_cols=[np.zeros((1, T))] * B)
    with pytest.raises(ValueError):
        prover.prove_batch(traces_cols=[torch.zeros((2, T), dtype=torch.int32)] * B)
    with pytest.raises(ValueError):
        BatchStarkProver(VariantFibAir(), StarkConfig(**CFG), 0, device="cpu")


def test_default_device_requires_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        BatchStarkProver(FibonacciAir(), StarkConfig(**CFG), B)


@pytest.mark.gpu
@pytest.mark.parametrize("model", ["fib", "mds"])
def test_card_batch_equals_single_proves(cuda_device, model):
    cfg = dict(trace_length=256, blowup=4, num_colinearity_tests=8)
    if model == "fib":
        air, items, kw = VariantFibAir(), _traces(4, 256), "traces"
    else:
        air = MdsSquareAir()
        cols = mds_square_trace_cols_device(256, device=cuda_device)
        items = [cols, (cols.long() * 5 + 2).remainder(P).to(torch.int32)] * 2
        kw = "traces_cols"
    cuda.reset_launches()
    got = BatchStarkProver(air, StarkConfig(**cfg), 4, cuda_device).prove_batch(**{kw: items})
    counts = cuda.launch_counts()
    assert all(counts[k] > 0 for k in ("merkle_forest", "sponge_absorb", "fri_fold_dyn"))
    assert counts["fri_fold"] == 0 and counts["query_gather"] == 1
    assert counts["compose"] == 1  # one K11 launch for the batch
    single = _single(air, cfg, "cpu")
    for proof, item in zip(got, items):
        want = single.prove(item) if kw == "traces" else single.prove(trace_cols=item.cpu())
        assert hashlib.sha256(proof).hexdigest() == hashlib.sha256(want).hexdigest()


@pytest.mark.gpu
def test_card_device_chain_off_launches_the_host_alpha_fold(cuda_device, monkeypatch):
    from stark_tpu_torch.fri import Fri

    trace = _traces(1, 256)[0]
    cfg = dict(trace_length=256, blowup=4, num_colinearity_tests=8)
    chained = _single(VariantFibAir(), cfg, cuda_device).prove(trace)
    monkeypatch.setattr(Fri, "device_chain", False)
    cuda.reset_launches()
    assert _single(VariantFibAir(), cfg, cuda_device).prove(trace) == chained
    counts = cuda.launch_counts()
    assert counts["fri_fold"] > 0 and counts["sponge_absorb"] == 0


# -- zero FRI rounds: 4 tests or more a point of the last codeword -----------
# FibonacciAir at T=8 / 8 tests and T=16 / 16 tests, blowup 4: N = 4 x tests,
# so the FRI commit has no round and the proof carries the codeword itself.
# The batch's traces are _traces(b, T): the first is the honest witness,
# the others start from 2, 3 (their proofs differ; none verifies).

ZERO_ROUND_CFGS = [dict(trace_length=8, blowup=4, num_colinearity_tests=8),
                   dict(trace_length=16, blowup=4, num_colinearity_tests=16)]


@pytest.fixture(scope="module")
def zero_round_reference():
    """stark_tpu's batch proofs at each zero-round config and B in {2, 3}."""
    from stark_tpu import StarkConfig as JConfig
    from stark_tpu.batch import BatchStarkProver as JBatch
    from stark_tpu.models.fibonacci import FibonacciAir as JFib

    return {(cfg["trace_length"], b): JBatch(JFib(), JConfig(**cfg), b).prove_batch(
        _traces(b, cfg["trace_length"])) for cfg in ZERO_ROUND_CFGS for b in (2, 3)}


@pytest.mark.parametrize("b", [2, 3])
@pytest.mark.parametrize("cfg", ZERO_ROUND_CFGS, ids=["T8", "T16"])
def test_zero_round_batch_equals_stark_tpu_and_single_proves(zero_round_reference, cfg, b):
    t = cfg["trace_length"]
    prover = BatchStarkProver(FibonacciAir(), StarkConfig(**cfg), b, device="cpu")
    assert prover.fri.num_rounds() == 0
    traces = _traces(b, t)
    got = prover.prove_batch(traces)
    assert got == zero_round_reference[(t, b)]
    single = _single(FibonacciAir(), cfg)
    assert got == [single.prove(trace) for trace in traces]
    assert len(set(got)) == b


@pytest.mark.parametrize("cfg", ZERO_ROUND_CFGS, ids=["T8", "T16"])
def test_zero_round_proofs_are_rejected_by_both_verifiers(zero_round_reference, cfg):
    # Reference behaviour, not a fault: a proof with no FRI root is
    # rejected ("No FRI roots extracted") by stark_tpu and by the port.
    from stark_tpu import StarkConfig as JConfig
    from stark_tpu import StarkVerifier as JVerifier
    from stark_tpu.models.fibonacci import FibonacciAir as JFib

    proofs = zero_round_reference[(cfg["trace_length"], 2)]
    assert proofs[0] == _single(FibonacciAir(), cfg).prove(
        fibonacci_trace_mod_p(cfg["trace_length"]))  # the honest witness
    ours = StarkVerifier(FibonacciAir(), StarkConfig(**cfg))
    theirs = JVerifier(JFib(), JConfig(**cfg))
    assert [theirs.verify(p) for p in proofs] == [False, False]
    assert [ours.verify(p) for p in proofs] == [False, False]
    assert ours.verify_batch(proofs) == [False, False]


@pytest.mark.gpu
@pytest.mark.parametrize("cfg", ZERO_ROUND_CFGS, ids=["T8", "T16"])
def test_card_zero_round_batch_equals_single_proves(cuda_device, cfg):
    traces = _traces(3, cfg["trace_length"])
    got = BatchStarkProver(FibonacciAir(), StarkConfig(**cfg), 3, cuda_device) \
        .prove_batch(traces)
    single = _single(FibonacciAir(), cfg)
    assert got == [single.prove(trace) for trace in traces]
