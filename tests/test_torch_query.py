"""The query phase as stark_tpu runs it: one gather (kernel K13,
ops/gather.py) and one fetch for every FRI round and the trace openings,
copied into the proof's wire layout (tests/test_torch_layout.py holds the
layout to the object path and stark_tpu's raw helpers); the prover's
trace_cols entry; the verifier's path sink and verify_batch.  Against
stark_tpu on the CPU: a raw segment serializes verbatim; the plain gather
equals per-round open_batch and value reads; proofs from
device columns, numpy columns and host rows are byte-identical to
stark_tpu's; verify_batch and the sunk paths agree with stark_tpu's.  On a
card, K13 equals its plain version and a prove launches it once.
Tolerance zero: bytes."""

import hashlib

import numpy as np
import pytest
import torch

from stark_tpu_torch import StarkConfig, StarkProver, StarkVerifier
from stark_tpu_torch.fri import Fri
from stark_tpu_torch.hashfn import Hash
from stark_tpu_torch.merkle import MerkleTree, path_rows
from stark_tpu_torch.models import FibonacciAir, fibonacci_trace_mod_p
from stark_tpu_torch.models.fibonacci import fibonacci_trace_cols_device
from stark_tpu_torch.ops import cuda
from stark_tpu_torch.ops import gather as G
from stark_tpu_torch.ops.fieldops import P
from stark_tpu_torch.stream import VALUES, FieldElements, MerklePath, ProofLayout, ProofStream
from torch_port_support import cuda_device, rand_field, to_torch  # noqa: F401

CFG_256 = dict(trace_length=256, blowup=4, num_colinearity_tests=4)
CFG_1024 = dict(trace_length=1024, blowup=4, num_colinearity_tests=16)
# sha256 of stark_tpu's prove(trace_cols=fibonacci_trace_cols_device(1024))
# on the CPU, CFG_1024 (the trace-rows proof has the same bytes).
FIB_1024 = "db5758edd257e895c25f040e3952b6aaebc8e3c5d25ef1408713b3710d2d5559"


def _objects_bytes(objs) -> bytes:
    return ProofStream(objs).serialize()


# -- raw wire segments -----------------------------------------------------------


def test_push_raw_serializes_verbatim():
    layout = ProofLayout(1)
    layout.add("v", 1, (VALUES, 2))
    segment = layout.buffer()
    layout.views(segment)["v"][0][...] = [3, P - 1]
    stream = ProofStream()
    stream.push(FieldElements((1, 2)))
    stream.push_raw(segment[0].tobytes())
    stream.push(FieldElements((4,)))
    want = _objects_bytes([FieldElements((1, 2)), FieldElements((3, P - 1)),
                           FieldElements((4,))])
    assert stream.serialize() == want
    parsed = ProofStream.deserialize(want, None)
    assert [o.values_ints() for o in parsed.objects] == [[1, 2], [3, P - 1], [4]]


# -- the gather's plain version ---------------------------------------------------


@pytest.mark.parametrize("n", [2, 4, 64, 1024])
def test_plain_gather_equals_open_batch_and_reads(n):
    """A plan over two trees, a codeword and a (3, n) array, with repeated
    and reversed indices: each slot equals open_batch and the direct
    reads, and one plan's buffer equals the requests' concatenation."""
    rng = np.random.default_rng(n)
    cw = to_torch(rand_field(rng, n))
    lde = to_torch(rand_field(rng, (3, n)))
    t_cw, t_lde = MerkleTree.from_leaf_values(cw), MerkleTree.from_rows(lde)
    idx = rng.integers(0, n, size=9)
    plan = G.GatherPlan()
    slots = [plan.values(cw, idx), plan.paths(t_cw._stack, idx),
             plan.values(lde, idx[::-1]), plan.paths(t_lde._stack, idx[:4]),
             plan.values(cw, idx[:2])]
    assert len(plan.sources) == 4          # cw appears once
    host = G.fetch(plan)
    assert host.dtype == np.uint32 and host.shape == (plan.words,)
    got = [s.take(host) for s in slots]
    np.testing.assert_array_equal(got[0][:, 0], cw.numpy()[idx])
    np.testing.assert_array_equal(got[2], lde.numpy()[:, idx[::-1]].T)
    np.testing.assert_array_equal(got[4][:, 0], cw.numpy()[idx[:2]])
    for tree, sib, ix in ((t_cw, got[1], idx), (t_lde, got[3], idx[:4])):
        want = tree.open_batch(list(ix))
        assert [[Hash(d.tobytes()) for d in p] for p in sib] == want


def test_path_rows_walk_the_stack():
    assert path_rows(8, [0, 5]).tolist() == [[1, 9, 13], [4, 11, 12]]
    assert path_rows(1, [0]).shape == (1, 0)


def test_gather_plan_rejects_bad_requests():
    cw = torch.zeros(8, dtype=torch.int32)
    plan = G.GatherPlan()
    with pytest.raises(IndexError):
        plan.values(cw, [8])
    with pytest.raises(ValueError):
        plan.values(cw.long(), [0])
    with pytest.raises(ValueError):
        plan.paths(torch.zeros((6, 32), dtype=torch.uint8), [0])
    with pytest.raises(ValueError):
        G.gather(G.GatherPlan())


# -- K13's parameter encoding, decoded as csrc/gather.cu reads it ----------------


def decode_launch(params: np.ndarray, memory: dict, out: np.ndarray) -> None:
    """One launch of csrc/gather.cu's kernel in numpy: every warp (task) and
    lane, addressing exactly as the kernel does.  ``memory``: source address
    -> that tensor's storage as a flat uint32 array (and the index buffer's,
    for rule slots); ``out``: the output words, at the address in the
    header."""
    w = params.astype(np.uint64)
    assert params.nbytes in G.PARAM_BYTES
    n_src, n_slot, n_task = (int(v) for v in w[:3])
    slots = G.HEADER_WORDS + 4 * n_src
    tasks = slots + 4 * n_slot
    if not int(w[tasks - 4]) >> 31:  # the last slot an index slot: its indices end the table
        assert int(w[3]) == int(w[slots + 3 : tasks : 4][-1] + w[slots + 1 : tasks : 4][-1])
    idx = memory.get(int(w[6]) | int(w[7]) << 32)
    for task in range(n_task):
        t_word = int(w[tasks + task])
        slot = slots + 4 * (t_word & 0xFFFF)
        j0 = t_word >> 16
        rule = int(w[slot]) >> 31
        src = G.HEADER_WORDS + 4 * (int(w[slot]) & 0x7FFFFFFF)
        base = memory[int(w[src]) | int(w[src + 1]) << 32]
        a, path, b = int(w[src + 2]), int(w[src + 3]) >> 31, int(w[src + 3]) & 0x7FFFFFFF
        width = 8 * b if path else b
        per_warp = 32 // width if width <= 32 else 1
        count = min(per_warp, int(w[slot + 1]) - j0)
        payload = tasks + n_task + int(w[slot + 3])
        step = int(w[payload + 8]) if rule else width
        for lane in range(32):
            for t in range(lane, count * width, 32):
                q = 0 if count == 1 else t // width
                word = t - q * width
                mine = True
                if rule:
                    j = int(w[payload]) + j0 + q
                    number, shape = int(w[payload + 1]), int(w[payload + 2])
                    h, f = shape & 0xFF, (shape >> 8) & 0xFF
                    u, j = j % f, j // f
                    if shape >> 16:
                        e, j = j % h, j // h
                        k, row = j % number, j // number
                    else:
                        k, j = j % number, j // number
                        e, row = j % h, j // h
                    mask = int(w[payload + 3])
                    x = ((int(idx[row * number + k]) & mask) + e * (mask + 1)
                         + int(w[payload + 9 + u])) & int(w[payload + 4])
                    own = int(w[payload + 6])
                    mine = (x << ((own >> 8) & 0xFF)) >> ((own >> 16) & 0xFF) == own & 0xFF
                    i = ((x - int(w[payload + 7])) % (1 << 32) >> (own >> 24)) \
                        + row * int(w[payload + 5])
                else:
                    i = int(w[payload + j0 + q])
                if path:
                    lv = word >> 3
                    at = 8 * ((2 * a - ((2 * a) >> lv)) + ((i >> lv) ^ 1)) + (word & 7)
                else:
                    at = word * a + i
                out[int(w[slot + 2]) + (j0 + q) * step + word] = base[at] if mine else 0


def decode_plan(plan: G.GatherPlan) -> tuple[np.ndarray, int]:
    """(the words every launch of ``plan.encode`` writes, the launches)."""
    memory = {t.data_ptr(): t.numpy().view(np.uint32).reshape(-1) for t in plan.sources}
    out = np.full(plan.words, 0xDEADBEEF, dtype=np.uint32)
    launches = plan.encode(out_address=(1 << 40) + 12)
    for params in launches:
        assert int(params[4]) | int(params[5]) << 32 == (1 << 40) + 12
        decode_launch(params, memory, out)
    return out, len(launches)


@pytest.fixture
def recorded_plans(monkeypatch):
    """Every GatherPlan the prover hands ops.gather.gather meanwhile."""
    plans, launch = [], G.gather

    def recording(plan):
        plans.append(plan)
        return launch(plan)

    monkeypatch.setattr(G, "gather", recording)
    return plans


@pytest.mark.parametrize("cfg", [CFG_256, CFG_1024], ids=["T=256", "T=1024"])
def test_encoding_decodes_to_plain_gather_on_prove_plans(recorded_plans, cfg, monkeypatch):
    # The three-read path's plan (host indices; Fri.fused_round False), then
    # the single-fetch path's rule plan on its sources and device indices.
    from stark_tpu_torch.fri import Fri

    monkeypatch.setattr(Fri, "fused_round", False)
    _prover(cfg).prove(fibonacci_trace_mod_p(cfg["trace_length"]))
    (plan,) = recorded_plans
    got, launches = decode_plan(plan)
    assert launches == 1
    np.testing.assert_array_equal(got, G.gather_plain(plan).numpy().view(np.uint32))

    monkeypatch.setattr(Fri, "fused_round", True)
    runs, run = [], G.RulePlan.run
    monkeypatch.setattr(G.RulePlan, "run", lambda self, src, idx, out: (
        runs.append((self, list(src), idx.clone())), run(self, src, idx, out))[1])
    _prover(cfg).prove(fibonacci_trace_mod_p(cfg["trace_length"]))
    ((rules, sources, idx),) = runs
    memory = {t.data_ptr(): t.numpy().view(np.uint32).reshape(-1) for t in sources + [idx]}
    got = np.full(rules.words, 0xDEADBEEF, dtype=np.uint32)
    launches = rules.encode(sources, idx.data_ptr(), (1 << 40) + 12)
    for params in launches:
        decode_launch(params, memory, got)
    assert len(launches) == 1 and not recorded_plans[1:]
    np.testing.assert_array_equal(got, G.rules_plain(rules, sources, idx).numpy().view(np.uint32))


def _synthetic_plan(rng, k: int, device="cpu") -> G.GatherPlan:
    """Value requests of 1, 3 and 40 words and paths of depth 1 to 10 in
    ``k`` requests of each kind, with zero-width paths (W = 1) between."""
    plan = G.GatherPlan()
    n = 1 << 10
    cw, lde3, lde40 = (to_torch(rand_field(rng, shape), device)
                       for shape in (n, (3, n), (40, n)))
    stacks = [MerkleTree.from_leaf_values(cw[: 1 << d])._stack for d in (1, 4, 10)]
    one = MerkleTree.from_leaf_values(cw[:1])._stack
    for src in (cw, lde3, lde40):
        plan.values(src, rng.integers(0, n, size=k))
    for stack in stacks:
        plan.paths(stack, rng.integers(0, (stack.shape[0] + 1) // 2, size=k))
        plan.paths(one, [0, 0])
    plan.values(cw, [n - 1])
    return plan


@pytest.mark.parametrize("k,launches", [(7, 1), (300, 1), (4000, 5)])
def test_encoding_decodes_to_plain_gather_when_split(k, launches):
    plan = _synthetic_plan(np.random.default_rng(k), k)
    got, made = decode_plan(plan)
    assert made == launches
    np.testing.assert_array_equal(got, G.gather_plain(plan).numpy().view(np.uint32))


def test_rule_encoding_decodes_to_plain_gather_when_split():
    # A rule plan whose tasks outgrow one launch: each piece of a slot
    # carries its rule with the piece's first request.
    rng = np.random.default_rng(3)
    rows, number, n, depth = 48, 64, 1 << 10, 4
    plan = G.RulePlan()
    vals = plan.values_source((rows, 3, n), n, 3)
    stack = plan.stack_source(rows << depth, depth)
    rule = G.Rule(rows, number, 1 << (depth - 1), h=2, offsets=(0, 3, 5), wrap=1 << depth,
                  stride=1 << depth, order=1)
    plan.values(vals, G.Rule(rows, number, n // 2, h=2, stride=3 * n))
    plan.paths(stack, rule)
    plan.values(vals, G.Rule(rows, number, n // 2, offsets=(1, 2), wrap=n, stride=3 * n))
    sources = [to_torch(rand_field(rng, (rows, 3, n))),
               torch.from_numpy(rng.integers(0, 256, size=plan.specs[1][0], dtype=np.uint8))]
    idx = torch.from_numpy(rng.integers(0, 1 << 30, size=(rows, number)).astype(np.int32))
    memory = {t.data_ptr(): t.numpy().view(np.uint32).reshape(-1) for t in sources + [idx]}
    got = np.full(plan.words, 0xDEADBEEF, dtype=np.uint32)
    launches = plan.encode(sources, idx.data_ptr(), 0)
    for params in launches:
        decode_launch(params, memory, got)
    assert len(launches) >= 2
    np.testing.assert_array_equal(got, G.rules_plain(plan, sources, idx).numpy().view(np.uint32))
    # The same structure, other tensors: only the addresses change.
    again = plan.encode([t.clone() for t in sources], 4, 8)
    assert all((a[G.HEADER_WORDS + 4 * 2:] == b[G.HEADER_WORDS + 4 * 2:]).all()
               for a, b in zip(launches, again))


def test_encoding_sizes_and_bounds():
    rng = np.random.default_rng(5)
    plan = _synthetic_plan(rng, 7)
    (params,) = plan.encode(0)
    assert params.dtype == np.uint32 and params.nbytes == G.PARAM_BYTES[0]
    # 4,000 requests of each kind: every launch within the largest struct.
    big = _synthetic_plan(rng, 4000).encode(0)
    assert {p.nbytes for p in big} <= set(G.PARAM_BYTES)
    assert big[0].nbytes == G.PARAM_BYTES[-1]
    # The table of the launch before: 32 bytes a source, 24 a request.
    n_req = sum(idx.size for _, idx, _ in plan.requests)
    used = int(params[0]) * 4 + int(params[1]) * 4 + int(params[2]) + int(params[3])
    assert 4 * (G.HEADER_WORDS + used) < 32 * len(plan.sources) + 24 * n_req


def test_encoding_raises_on_what_it_cannot_hold():
    plan = G.GatherPlan()
    cw = torch.zeros(8, dtype=torch.int32)
    plan.values(cw, [1, 2])
    src, idx, slot = plan.requests[0]
    plan.requests[0] = (src, np.array([1, 1 << 32]), slot)   # past 32 bits
    with pytest.raises(ValueError, match="index"):
        plan.encode(0)
    many = G.GatherPlan()
    keep = [torch.zeros(1, dtype=torch.int32) for _ in range(2100)]
    for t in keep:
        many.values(t, [0])
    with pytest.raises(ValueError, match="sources"):
        many.encode(0)
    fewer = G.GatherPlan()
    for t in keep[:2000]:
        fewer.values(t, [0])
    assert len(fewer.encode(0)) >= 1


def test_fri_single_round_query_equals_object_path():
    """Fri.query (one round: dispatch, fetch, emit) against the objects
    built from open_batch and direct reads, stream order of fri.rs:215-248."""
    rng = np.random.default_rng(11)
    fri = Fri(omega=1, offset=3, domain_length=64, expansion_factor=4,
              num_colinearity_tests=4)
    cur, nxt = to_torch(rand_field(rng, 64)), to_torch(rand_field(rng, 32))
    t_cur, t_nxt = MerkleTree.from_leaf_values(cur), MerkleTree.from_leaf_values(nxt)
    c = [3, 31, 0, 17]
    stream = ProofStream()
    ab = fri.query(cur, nxt, c, stream, t_cur, t_nxt)
    assert ab == c + [i + 32 for i in c]
    cur_paths, nxt_paths = t_cur.open_batch(ab), t_nxt.open_batch(c)
    objs = [FieldElements((int(cur[a]), int(cur[a + 32]), int(nxt[a]))) for a in c]
    for s in range(4):
        objs += [MerklePath(tuple(cur_paths[s])), MerklePath(tuple(cur_paths[4 + s])),
                 MerklePath(tuple(nxt_paths[s]))]
    assert stream.serialize() == _objects_bytes(objs)


# -- whole proofs ---------------------------------------------------------------------


def _prover(cfg, device="cpu"):
    return StarkProver(FibonacciAir(), StarkConfig(**cfg), device=device)


def _verifier(cfg):
    return StarkVerifier(FibonacciAir(), StarkConfig(**cfg))


@pytest.fixture(scope="module")
def proofs_256():
    """stark_tpu's prove(trace_cols=device columns) at CFG_256 and the
    port's proofs from device columns, numpy columns and host rows."""
    from stark_tpu import StarkConfig as JConfig
    from stark_tpu import StarkProver as JProver
    from stark_tpu.models.fibonacci import FibonacciAir as JAir
    from stark_tpu.models.fibonacci import fibonacci_trace_cols_device as j_cols

    reference = JProver(JAir(), JConfig(**CFG_256)).prove(trace_cols=j_cols(256))
    prover = _prover(CFG_256)
    cols = fibonacci_trace_cols_device(256, device="cpu")
    return reference, {
        "device cols": prover.prove(trace_cols=cols),
        "numpy cols": prover.prove(trace_cols=cols.numpy().view(np.uint32)),
        "rows": prover.prove(fibonacci_trace_mod_p(256)),
    }


@pytest.mark.parametrize("entry", ["device cols", "numpy cols", "rows"])
def test_proof_256_equals_stark_tpu(proofs_256, entry):
    reference, port = proofs_256
    assert port[entry] == reference


@pytest.mark.parametrize("entry", ["device cols", "rows"])
def test_proof_1024_equals_stark_tpu(entry):
    prover = _prover(CFG_1024)
    proof = (prover.prove(trace_cols=fibonacci_trace_cols_device(1024, device="cpu"))
             if entry == "device cols" else prover.prove(fibonacci_trace_mod_p(1024)))
    assert hashlib.sha256(proof).hexdigest() == FIB_1024


def test_prove_takes_one_witness_on_its_device():
    prover = _prover(CFG_256)
    cols = fibonacci_trace_cols_device(256, device="cpu")
    with pytest.raises(ValueError):
        prover.prove(fibonacci_trace_mod_p(256), trace_cols=cols)
    with pytest.raises(ValueError):
        prover.prove(trace_cols=cols.long())
    with pytest.raises(ValueError):
        prover.prove(trace_cols=cols.to("meta"))


def _tampered(proof: bytes, where: int) -> bytes:
    bad = bytearray(proof)
    bad[where] ^= 1
    return bytes(bad)


@pytest.mark.parametrize("where", [100, 5000, -3])
def test_verify_batch_agrees_with_stark_tpu(proofs_256, where):
    from stark_tpu import StarkConfig as JConfig
    from stark_tpu import StarkVerifier as JVerifier
    from stark_tpu.models.fibonacci import FibonacciAir as JAir

    good = proofs_256[1]["device cols"]
    batch = [good, _tampered(good, where), good]
    got = _verifier(CFG_256).verify_batch(batch)
    assert got == [True, False, True]
    assert got == JVerifier(JAir(), JConfig(**CFG_256)).verify_batch(batch)
    assert _verifier(CFG_256).verify_batch([]) == []


def test_verify_batch_finds_a_bad_path_alone():
    """A proof whose only fault is one sibling digest passes every check
    but the paths: the batch call fails, and the per-proof pass finds it."""
    cfg = CFG_256
    good = _prover(cfg).prove(fibonacci_trace_mod_p(256))
    sink: list = []
    assert _verifier(cfg).verify(good, path_sink=sink)
    # The last sunk path is a trace opening's; flip its first sibling byte.
    path_obj = sink[-1][4]
    raw = path_obj.raw_bytes()
    pos = good.rindex(raw)
    bad = _tampered(good, pos)
    assert _verifier(cfg).verify(bad, path_sink=[])       # paths not checked
    assert not _verifier(cfg).verify(bad)
    assert _verifier(cfg).verify_batch([good, bad, good]) == [True, False, True]


def test_path_sink_equals_stark_tpu(proofs_256):
    from stark_tpu import StarkConfig as JConfig
    from stark_tpu import StarkVerifier as JVerifier
    from stark_tpu.models.fibonacci import FibonacciAir as JAir

    proof = proofs_256[0]
    sink, jsink = [], []
    assert _verifier(CFG_256).verify(proof, path_sink=sink)
    assert JVerifier(JAir(), JConfig(**CFG_256)).verify(proof, path_sink=jsink)

    def flat(triples):
        return [(label, idx, val, root.data, path.raw_bytes())
                for label, idx, val, root, path in triples]

    assert flat(sink) == flat(jsink)
    # FRI's rounds, 3 paths per test each, then one per trace opening.
    n_rounds = _verifier(CFG_256).fri.num_rounds() - 1
    n_open = 2 * CFG_256["num_colinearity_tests"] * len(FibonacciAir.frame_offsets)
    assert len(sink) == 3 * CFG_256["num_colinearity_tests"] * n_rounds + n_open


# -- on the card ------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("n", [2, 64, 1024, 1 << 16])
def test_card_query_gather(cuda_device, n):
    rng = np.random.default_rng(n)
    cw = to_torch(rand_field(rng, n), cuda_device)
    lde = to_torch(rand_field(rng, (3, n)), cuda_device)
    idx = rng.integers(0, n, size=33)
    plan = G.GatherPlan()
    plan.values(cw, idx)
    plan.paths(MerkleTree.from_leaf_values(cw)._stack, idx)
    plan.values(lde, idx[::-1])
    plan.paths(MerkleTree.from_rows(lde)._stack, idx[:5])
    want = G.gather_plain(plan)
    cuda.reset_launches()
    for _ in range(2):
        assert torch.equal(G.gather(plan), want)
    assert cuda.launch_counts()["query_gather"] == 2
    np.testing.assert_array_equal(G.fetch(plan), want.cpu().numpy().view(np.uint32))


@pytest.mark.gpu
@pytest.mark.parametrize("k,launches", [(7, 1), (300, 1), (4000, 5)])
def test_card_query_gather_split(cuda_device, k, launches):
    """The synthetic plans of the encoding's tests, on the card: a plan
    too large for one launch's parameters goes out in several."""
    plan = _synthetic_plan(np.random.default_rng(k), k, cuda_device)
    want = G.gather_plain(plan)
    cuda.reset_launches()
    assert torch.equal(G.gather(plan), want)
    assert cuda.launch_counts()["query_gather"] == launches


@pytest.mark.gpu
@pytest.mark.parametrize("entry", ["device cols", "rows"])
def test_card_prove_launches_one_gather(cuda_device, entry):
    prover = _prover(CFG_1024, cuda_device)
    cuda.reset_launches()
    proof = (prover.prove(trace_cols=fibonacci_trace_cols_device(1024))
             if entry == "device cols" else prover.prove(fibonacci_trace_mod_p(1024)))
    counts = cuda.launch_counts()
    assert counts["query_gather"] == 1
    assert counts["fib_expand"] == (1 if entry == "device cols" else 0)
    assert hashlib.sha256(proof).hexdigest() == FIB_1024
    assert _verifier(CFG_1024).verify(proof)
