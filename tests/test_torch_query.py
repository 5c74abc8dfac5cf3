"""The query phase as stark_tpu runs it: one gather (kernel K13,
ops/gather.py) and one fetch for every FRI round and the trace openings,
emitted as raw wire segments; the prover's trace_cols entry; the
verifier's path sink and verify_batch.  Against stark_tpu on the CPU: the
raw segments equal the object path's bytes and stark_tpu's raw helpers;
the plain gather equals per-round open_batch and value reads; proofs from
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
from stark_tpu_torch.stream import (
    FieldElements,
    MerklePath,
    ProofStream,
    raw_field_elements,
    raw_merkle_path,
    wire_field_elements,
    wire_merkle_paths,
)
from torch_port_support import cuda_device, rand_field, to_torch  # noqa: F401

CFG_256 = dict(trace_length=256, blowup=4, num_colinearity_tests=4)
CFG_1024 = dict(trace_length=1024, blowup=4, num_colinearity_tests=16)
# sha256 of stark_tpu's prove(trace_cols=fibonacci_trace_cols_device(1024))
# on the CPU, CFG_1024 (the trace-rows proof has the same bytes).
FIB_1024 = "db5758edd257e895c25f040e3952b6aaebc8e3c5d25ef1408713b3710d2d5559"


def _objects_bytes(objs) -> bytes:
    return ProofStream(objs).serialize()


def _random_sib(rng, k, L):
    return rng.integers(0, 256, size=(k, L, 32), dtype=np.uint8)


# -- raw wire segments -----------------------------------------------------------


@pytest.mark.parametrize("k,m", [(1, 1), (3, 3), (16, 3), (5, 8)])
def test_wire_field_elements_equal_objects(k, m):
    rows = rand_field(np.random.default_rng(k * m), (k, m))
    want = _objects_bytes([FieldElements(tuple(int(v) for v in r)) for r in rows])
    assert wire_field_elements(rows).tobytes() == want
    assert wire_field_elements(rows.astype(np.int32)).tobytes() == want
    assert b"".join(raw_field_elements(r) for r in rows) == want


@pytest.mark.parametrize("k,L", [(1, 0), (1, 1), (4, 6), (7, 22)])
def test_wire_merkle_paths_equal_objects(k, L):
    sib = _random_sib(np.random.default_rng(k + L), k, L)
    want = _objects_bytes(
        [MerklePath(tuple(Hash(d.tobytes()) for d in path)) for path in sib])
    assert wire_merkle_paths(sib).tobytes() == want
    assert b"".join(raw_merkle_path(path) for path in sib) == want


def test_raw_helpers_equal_stark_tpu():
    from stark_tpu import stream as jstream

    rng = np.random.default_rng(3)
    vals = rand_field(rng, 5)
    assert raw_field_elements(vals) == jstream.raw_field_elements(vals)
    sib = _random_sib(rng, 4, 9)                      # (k, L, 32), query-major
    level_major = np.ascontiguousarray(sib.transpose(1, 0, 2))
    for q in range(4):
        assert raw_merkle_path(sib[q]) == jstream.raw_merkle_path(level_major, q)


def test_push_raw_serializes_verbatim():
    stream = ProofStream()
    stream.push(FieldElements((1, 2)))
    stream.push_raw(raw_field_elements([3, P - 1]))
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
