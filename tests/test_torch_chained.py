"""The single-fetch prove of the port (stark_tpu's default path,
stark_tpu/fri.py:_prove_chained and stark_tpu/batch.py:_prove_batch_mega):
the constraint challenges (K15) and the FRI query indices (K10) made on the
device, the query gather from device indices (K13's rule slots), one read
from the device a prove or a batch.

On the CPU every kernel runs its plain version.  The plain K15 equals
stark_tpu's _device_challenges_fn, the plain K10 its sample_indices_core and
_sample_indices_batched (a small candidate count that falls short too), on
the same numpy-seeded bytes; K13's rule slots gather what the host-index
plan (Fri._round_dispatch, StarkProver._open_dispatch) gathers; proofs
equal stark_tpu's (the sha256 pinned from it, every AIR at T=1024, one
proof and a batch of 3) and the three-read path's; a forced shortfall gives
the same bytes through a second read; a tampered card value raises; and
prove_many at depth 1, 2 and 3 equals sequential prove_batch calls.  On a
card (marker ``gpu``): the kernels against their plain versions and the
proofs.  Tolerance zero throughout: integers and bytes."""

import hashlib

import numpy as np
import pytest
import torch

from stark_tpu_torch import BatchStarkProver, StarkConfig, StarkProver
from stark_tpu_torch import fri as FRI
from stark_tpu_torch.fri import Fri
from stark_tpu_torch.models import MODEL_NAMES, get_model
from stark_tpu_torch.ops import cuda
from stark_tpu_torch.ops import gather as G
from stark_tpu_torch.ops import hash_batch as HB
from stark_tpu_torch.ops.fieldops import P
from torch_port_support import cuda_device  # noqa: F401

# sha256 of stark_tpu's proofs at T=1024, blowup 4 (cube 8), 16 tests
# (tests/test_torch_examples.py, test_torch_mds.py, test_torch_stark.py and
# chip_smoke.py pin the same).
PINNED_1024 = {
    "fib": "db5758edd257e895c25f040e3952b6aaebc8e3c5d25ef1408713b3710d2d5559",
    "fib2": "8aa084f58d892fecc475421ff3a70b103680b3ba9d6ac8504c7deaf898367411",
    "square": "f6ba13984ae58983cbdc11555d66a17c20136ea2a746bdd86221b254aca69084",
    "cube": "50c33d4c401ba5bbf71b2139e08aea70001fc0d1254ec111490f150525b7758e",
    "mds": "97cf6cf94a41c0df3c285c34e497c315a14e4083e3897632b1d76e39109f61a6",
}
SMALL = dict(trace_length=64, blowup=4, num_colinearity_tests=4)


def _rand_bytes(seed: int, shape) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, size=shape, dtype=np.uint8)


def _sponge(prefix: np.ndarray) -> HB.Sponge:
    """A CPU sponge of B lanes that has absorbed (B, L) prefix bytes."""
    sp = HB.Sponge(prefix.shape[0], "cpu")
    sp.absorb(torch.from_numpy(prefix.copy()))
    return sp


def _config(model: str, trace_length: int = 1024, tests: int = 16) -> StarkConfig:
    return StarkConfig(trace_length=trace_length, blowup=get_model(model)[2],
                       num_colinearity_tests=tests)


def _sha(proof: bytes) -> str:
    return hashlib.sha256(proof).hexdigest()


# -- K15: the constraint challenges ------------------------------------------------


@pytest.mark.parametrize("challenges", [4, 6])
def test_plain_challenges_equal_stark_tpu(challenges):
    # Square's 2 terms and Fibonacci's 3: 2 challenges a term.
    import jax.numpy as jnp
    from stark_tpu.stark import _device_challenges_fn

    roots = _rand_bytes(challenges, (3, 32))
    state, pending, digests, words = HB.constraint_challenges_plain(
        torch.from_numpy(roots), challenges)
    q = 8 * challenges % 32
    for b in range(3):
        digs, alphas, j_state, j_pending = (
            np.asarray(x) for x in _device_challenges_fn(challenges)(jnp.asarray(roots[b])))
        np.testing.assert_array_equal(digests[b].numpy(), digs)
        np.testing.assert_array_equal(state[b].numpy(), j_state.reshape(32))
        np.testing.assert_array_equal(pending[b, :q].numpy(), j_pending.reshape(-1))
        # K11's words: per pair (alpha, beta) a R^2, its companion, b R, its.
        a, bt = alphas[0::2].astype(np.int64), alphas[1::2].astype(np.int64)
        r1 = (1 << 32) % P
        wa, wb = a * (r1 * r1 % P) % P, bt * r1 % P
        want = np.stack([wa, (wa << 32) // P, wb, (wb << 32) // P], axis=1).reshape(-1)
        assert want.size == 2 * challenges
        np.testing.assert_array_equal(words[b].numpy().view(np.uint32), want)


def test_challenges_wrapper_writes_every_output():
    roots = torch.from_numpy(_rand_bytes(7, (2, 32)))
    sp = HB.Sponge(2, "cpu")
    copy = torch.empty((2, 32), dtype=torch.uint8)
    digests = torch.empty((2, 6, 8), dtype=torch.uint8)
    weights = torch.empty((2, 12), dtype=torch.int32)
    HB.constraint_challenges(roots, 6, sp, copy, digests, weights)
    state, pending, digs, words = HB.constraint_challenges_plain(roots, 6)
    assert torch.equal(copy, roots) and torch.equal(digests, digs)
    assert torch.equal(weights, words) and torch.equal(sp.state, state)
    assert (sp.q, sp.fresh) == (16, False)
    with pytest.raises(ValueError):
        HB.constraint_challenges(roots, 5, sp, copy, digests, weights)


# -- K10: the FRI query indices ---------------------------------------------------

# (size, reduced, number, candidates): a Fibonacci prove's (N/2, reduced
# 128, 16 tests, M = 64) and a small M whose count falls short.
SAMPLE_CASES = [(1 << 10, 128, 16, 2 * 16 + FRI._SAMPLE_SLACK), (1 << 10, 16, 16, 20)]


@pytest.mark.parametrize("size, reduced, number, m", SAMPLE_CASES)
def test_plain_sampler_equals_stark_tpu(size, reduced, number, m):
    import jax.numpy as jnp
    from stark_tpu.batch import _sample_indices_batched
    from stark_tpu.ops import hash_batch as JHB

    prefix = _rand_bytes(m, (3, 80 + reduced % 7))
    sp = _sponge(prefix)
    idx, count = HB.sample_indices_plain(sp.state, sp.pending, sp.q, size, reduced,
                                         number, m)
    seeds = []
    for b in range(3):
        state, pending = JHB.sponge_from_bytes(jnp.asarray(prefix[b]))
        rows = JHB.seed_digest_rows_from_state(JHB.sponge_state(state, pending))
        want, want_count = JHB.sample_indices_core(rows, m, size, reduced, number)
        np.testing.assert_array_equal(idx[b].numpy().view(np.uint32), np.asarray(want))
        assert int(count[b]) == int(want_count)
        seeds.append(jnp.stack([r.reshape(()) for r in rows]))
    batched, counts = _sample_indices_batched(jnp.stack(seeds, axis=1), 3, m, size,
                                              reduced, number)
    np.testing.assert_array_equal(idx.numpy().view(np.uint32), np.asarray(batched))
    np.testing.assert_array_equal(count.numpy(), np.asarray(counts))
    if m < number:
        assert (count < number).all()


def test_sampler_equals_the_host_walk_and_falls_short():
    # The first `count` indices are the host's (native.sample_indices) in
    # order, whatever the count; a pool too small for `number` falls short.
    from stark_tpu_torch import native
    from stark_tpu_torch.hashfn import Hash

    prefix = _rand_bytes(11, (4, 96))
    sp = _sponge(prefix)
    digest = HB.sponge_state_plain(sp.state, sp.pending, sp.q)
    for size, reduced, number, m in ((1 << 12, 256, 64, 160), (1 << 8, 32, 32, 33),
                                     (1 << 6, 64, 8, 1)):
        out = torch.empty((4, number), dtype=torch.int32)
        count = torch.empty(4, dtype=torch.int32)
        HB.sample_indices(sp, size, reduced, number, m, out, count)
        for b in range(4):
            seed = Hash.from_u64(int.from_bytes(digest[b, :8].numpy().tobytes(), "little"))
            want = native.sample_indices(seed.data, size, reduced, number)
            c = int(count[b])
            assert out[b, :c].tolist() == want[:c]
            assert (out[b, c:] == 0).all() and (c == number or m < 2 * number)
    with pytest.raises(ValueError):
        HB.sample_indices(sp, 1 << 8, 1 << 15, 8, 64, out[:, :8], count)


# -- K13's rule slots ----------------------------------------------------------------


@pytest.mark.parametrize("model, b", [("fib", 1), ("mds", 3), ("cube", 2)])
def test_rule_slots_gather_what_host_indices_gather(model, b):
    prover = StarkProver(get_model(model)[0], _config(model, 64, 4), device="cpu")
    plan, round_slots, open_slots = prover._rule_plan(b)
    rng = np.random.default_rng(b)
    sources = [torch.from_numpy(rng.integers(0, 256, size=shape, dtype=np.uint8))
               if dtype == torch.uint8 else
               torch.from_numpy(rng.integers(0, P, size=shape).astype(np.int32))
               for shape, dtype in plan.specs]
    k, fri = prover.cfg.num_colinearity_tests, prover.fri
    idx = rng.integers(0, 1 << 30, size=(b, k))
    out = torch.empty(plan.words, dtype=torch.int32)
    got = plan.run(sources, torch.from_numpy(idx.astype(np.int32)), out).numpy()
    # The same reads with host indices, in the prover's host-index order.
    host = G.GatherPlan()
    rounds = fri.num_rounds()
    reduced = idx.astype(np.int64)
    for i in range(rounds - 1):
        reduced = reduced % ((fri.domain_length >> i) // 2)
        fri._round_dispatch(sources[2 * i], sources[2 * i + 2], reduced, sources[2 * i + 1],
                            sources[2 * i + 3], host)
    lde, stack = sources[2 * rounds:]
    forest = type("F", (), {})()
    forest.stack, forest.depth = stack, prover.dom.N.bit_length() - 1
    forest.global_index = lambda ix: np.asarray(ix).reshape(b, -1) + prover.dom.N * np.arange(
        b)[:, None]
    prover._open_dispatch(lde, forest)([list(r) for r in idx], host)
    np.testing.assert_array_equal(got, G.gather_plain(host).numpy())
    assert plan.words == host.words and len(round_slots) == rounds - 1
    # The encoding carries no index: the same words for other indices.
    assert plan.encode(sources, 0, 0)[0].size * 4 in G.PARAM_BYTES


def test_rule_plan_checks_what_it_is_bound_to():
    prover = StarkProver(get_model("fib")[0], _config("fib", 64, 4), device="cpu")
    plan, _, _ = prover._rule_plan(1)
    sources = [torch.zeros(shape, dtype=dtype) for shape, dtype in plan.specs]
    idx = torch.zeros((1, 4), dtype=torch.int32)
    out = torch.empty(plan.words, dtype=torch.int32)
    with pytest.raises(ValueError):
        plan.run(sources[:-1], idx, out)
    with pytest.raises(ValueError):
        plan.run(sources[:-1] + [sources[-1][:-1]], idx, out)
    with pytest.raises(ValueError):
        plan.run(sources, idx[:, :2], out)
    with pytest.raises(ValueError):
        G.Rule(1, 4, 6)  # half not a power of two


# -- the single-fetch prove ------------------------------------------------------------


@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("model", MODEL_NAMES)
def test_single_fetch_proofs_equal_stark_tpu(model, b, monkeypatch):
    reads = []
    to_host = G.to_host
    monkeypatch.setattr(G, "to_host", lambda t, **kw: reads.append(1) or to_host(t, **kw))
    air, trace_fn, _ = get_model(model)
    prover = BatchStarkProver(air, _config(model), b, device="cpu")
    assert prover.fri._chainable()
    proofs = prover.prove_batch([trace_fn(1024)] * b)
    assert [_sha(p) for p in proofs] == [PINNED_1024[model]] * b
    assert len(reads) == 1


@pytest.mark.parametrize("model", ["fib", "mds"])
def test_single_fetch_equals_three_reads_on_distinct_traces(model, monkeypatch):
    air = get_model(model)[0]
    cfg = StarkConfig(**SMALL)
    rng = np.random.default_rng(5)
    cols = [torch.from_numpy(rng.integers(0, P, size=(air.num_registers, 64)).astype(np.int32))
            for _ in range(3)]
    chained = BatchStarkProver(air, cfg, 3, device="cpu").prove_batch(traces_cols=cols)
    monkeypatch.setattr(Fri, "fused_round", False)
    assert BatchStarkProver(air, cfg, 3, device="cpu").prove_batch(traces_cols=cols) == chained


def test_a_forced_shortfall_gives_the_same_bytes(monkeypatch):
    # One candidate a proof: every count falls short, and the host's
    # indices go through the same rule slots in a second read.
    air, trace_fn, _ = get_model("fib")
    want = [PINNED_1024["fib"]] * 2
    monkeypatch.setattr(FRI, "_SAMPLE_SLACK", 1 - 2 * 16)
    reads = []
    to_host = G.to_host
    monkeypatch.setattr(G, "to_host", lambda t, **kw: reads.append(1) or to_host(t, **kw))
    prover = BatchStarkProver(air, _config("fib"), 2, device="cpu")
    assert [_sha(p) for p in prover.prove_batch([trace_fn(1024)] * 2)] == want
    assert len(reads) == 2 and prover.fri.shortfalls == 1


def test_a_low_count_alone_gives_the_same_bytes(monkeypatch):
    # The card's count patched low (its indices right): the re-run.
    plain = HB.sample_indices_plain

    def low(*args, **kwargs):
        idx, count = plain(*args, **kwargs)
        return idx, count - 1

    monkeypatch.setattr(HB, "sample_indices_plain", low)
    air, trace_fn, _ = get_model("mds")
    prover = StarkProver(air, _config("mds"), device="cpu")
    assert _sha(prover.prove(trace_fn(1024))) == PINNED_1024["mds"]
    assert prover.fri.shortfalls == 1


def test_a_tampered_challenge_byte_raises(monkeypatch):
    plain = HB.constraint_challenges_plain

    def tampered(roots, challenges):
        state, pending, digests, words = plain(roots, challenges)
        digests[0, 1, 3] ^= 1
        return state, pending, digests, words

    monkeypatch.setattr(HB, "constraint_challenges_plain", tampered)
    with pytest.raises(RuntimeError, match="constraint challenges"):
        StarkProver(get_model("fib")[0], StarkConfig(**SMALL), device="cpu").prove(
            get_model("fib")[1](64))


def test_a_tampered_index_raises(monkeypatch):
    plain = HB.sample_indices_plain

    def tampered(*args, **kwargs):
        idx, count = plain(*args, **kwargs)
        idx[-1, 0] ^= 1
        return idx, count

    monkeypatch.setattr(HB, "sample_indices_plain", tampered)
    with pytest.raises(RuntimeError, match="query indices"):
        BatchStarkProver(get_model("fib")[0], StarkConfig(**SMALL), 2, device="cpu") \
            .prove_batch([get_model("fib")[1](64)] * 2)


def test_not_chainable_reads_twice_with_the_same_bytes(monkeypatch):
    # 32 tests at N = 256: one FRI round, no single fetch; the indices
    # sampled on the host, the trace root and the challenges' bytes riding
    # the chain's fetch, the query gather a second read.
    air, trace_fn, _ = get_model("fib")
    cfg = StarkConfig(trace_length=64, blowup=4, num_colinearity_tests=32)
    reads = []
    to_host = G.to_host
    monkeypatch.setattr(G, "to_host", lambda t, **kw: reads.append(1) or to_host(t, **kw))
    prover = StarkProver(air, cfg, device="cpu")
    assert prover.fri.num_rounds() >= 1 and not prover.fri._chainable()
    proof = prover.prove(trace_fn(64))
    assert len(reads) == 2
    monkeypatch.setattr(Fri, "fused_round", False)
    assert StarkProver(air, cfg, device="cpu").prove(trace_fn(64)) == proof


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_prove_many_equals_sequential_batches(depth, monkeypatch):
    # 7 distinct traces in batches of 3: the last batch padded.
    air = get_model("fib")[0]
    cfg = StarkConfig(**SMALL)
    rng = np.random.default_rng(depth)
    items = [torch.from_numpy(rng.integers(0, P, size=(1, 64)).astype(np.int32))
             for _ in range(7)]
    prover = BatchStarkProver(air, cfg, 3, device="cpu")
    want = []
    for i in range(0, 7, 3):
        chunk = items[i : i + 3]
        want += prover.prove_batch(traces_cols=chunk + [chunk[-1]] * (3 - len(chunk)))[
            : len(chunk)]
    finished = []
    finish = BatchStarkProver._finish
    monkeypatch.setattr(BatchStarkProver, "_finish",
                        lambda self, f: finished.append(1) or finish(self, f))
    dispatched = []
    dispatch = BatchStarkProver._dispatch
    monkeypatch.setattr(BatchStarkProver, "_dispatch", lambda self, *a, **k: (
        dispatched.append(len(finished)), dispatch(self, *a, **k))[1])
    assert prover.prove_many(traces_cols=items, depth=depth) == want
    # Batch k + depth goes out before batch k is finished.
    assert dispatched == [min(i, max(0, i - depth)) for i in range(3)]


# -- on a card ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("b, challenges", [(1, 6), (8, 6), (32, 6), (1, 32), (3, 0), (3, 6),
                                           (5, 6), (5, 64), (1, 64), (1, 7266), (5, 7266),
                                           (3, 2 * HB.CHALLENGE_WINDOW + 6)])
def test_card_challenges_equal_plain(cuda_device, b, challenges):
    # Past one window of raw draws too (3,633 terms; two windows and three
    # pairs).
    roots = torch.from_numpy(_rand_bytes(b + challenges, (b, 32)))
    sp = HB.Sponge(b, cuda_device)
    copy = torch.empty((b, 32), dtype=torch.uint8, device=cuda_device)
    digests = torch.empty((b, challenges, 8), dtype=torch.uint8, device=cuda_device)
    weights = torch.empty((b, 2 * challenges), dtype=torch.int32, device=cuda_device)
    HB.constraint_challenges(roots.to(cuda_device), challenges, sp, copy, digests, weights)
    state, pending, digs, words = HB.constraint_challenges_plain(roots, challenges)
    q = sp.q
    for got, want in ((sp.state, state), (sp.pending[:, :q], pending[:, :q]),
                      (digests, digs), (weights, words), (copy, roots)):
        assert torch.equal(got.cpu(), want)


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 8, 32])
@pytest.mark.parametrize("size, reduced, number, m",
                         [(1 << 21, 128, 16, 64), (1 << 15, 128, 16, 64), (1 << 10, 16, 16, 20),
                          (1 << 12, 1 << 14, 200, 432), (1 << 12, 1 << 14, 300, 632)])
def test_card_sampler_equals_plain(cuda_device, b, size, reduced, number, m):
    prefix = _rand_bytes(b + m, (b, 70))
    sp = HB.Sponge(b, cuda_device)
    sp.absorb(torch.from_numpy(prefix).to(cuda_device))
    out = torch.empty((b, number), dtype=torch.int32, device=cuda_device)
    count = torch.empty(b, dtype=torch.int32, device=cuda_device)
    HB.sample_indices(sp, size, reduced, number, m, out, count)
    want, want_count = HB.sample_indices_plain(sp.state.cpu(), sp.pending.cpu(), sp.q, size,
                                               reduced, number, m)
    assert torch.equal(out.cpu(), want) and torch.equal(count.cpu(), want_count)


@pytest.mark.gpu
@pytest.mark.parametrize("model, b", [("fib", 1), ("mds", 3), ("cube", 8)])
def test_card_rule_gather_equals_plain(cuda_device, model, b):
    prover = StarkProver(get_model(model)[0], _config(model, 256, 8), cuda_device)
    plan, _, _ = prover._rule_plan(b)
    rng = np.random.default_rng(b)
    sources = [torch.from_numpy(rng.integers(0, 256, size=shape, dtype=np.uint8)).to(cuda_device)
               if dtype == torch.uint8 else
               torch.from_numpy(rng.integers(0, P, size=shape).astype(np.int32)).to(cuda_device)
               for shape, dtype in plan.specs]
    idx = torch.from_numpy(rng.integers(0, 1 << 30, size=(b, 8)).astype(np.int32)).to(cuda_device)
    out = torch.empty(plan.words, dtype=torch.int32, device=cuda_device)
    assert torch.equal(plan.run(sources, idx, out), G.rules_plain(plan, sources, idx))


@pytest.mark.gpu
@pytest.mark.parametrize("model", MODEL_NAMES)
def test_card_single_fetch_proofs(cuda_device, model, monkeypatch):
    reads = []
    to_host = G.to_host
    monkeypatch.setattr(G, "to_host", lambda t, **kw: reads.append(1) or to_host(t, **kw))
    air, trace_fn, _ = get_model(model)
    cuda.reset_launches()
    proofs = BatchStarkProver(air, _config(model), 3, cuda_device).prove_batch(
        [trace_fn(1024)] * 3)
    counts = cuda.launch_counts()
    assert [_sha(p) for p in proofs] == [PINNED_1024[model]] * 3 and len(reads) == 1
    assert counts["constraint_challenges"] == 1 and counts["sample_indices"] == 1
    assert counts["compose"] == 1 and counts["query_gather"] >= 1


@pytest.mark.gpu
def test_card_shortfall_and_pipeline(cuda_device, monkeypatch):
    air, trace_fn, _ = get_model("fib")
    monkeypatch.setattr(FRI, "_SAMPLE_SLACK", 1 - 2 * 16)
    prover = BatchStarkProver(air, _config("fib"), 2, cuda_device)
    assert [_sha(p) for p in prover.prove_many([trace_fn(1024)] * 5, depth=2)] == \
        [PINNED_1024["fib"]] * 5
    assert prover.fri.shortfalls == 3
