"""A proof's bytes written in place (stream.ProofLayout): the single-fetch
prove fills the payloads of a wire layout that its shape fixes, straight
from the fetched words, and copies each proof out once.

On the CPU: a layout's objects equal ProofStream's object path and
stark_tpu's raw helpers, headers written once and payloads in place; every
single-fetch proof equals the object path (the proof parsed and written
again object by object), the three-read path (which pushes objects), the
plain reference (benchmark/reference, independent of the program) and the
golden pins, at T = 64 to 2048, for B = 1, a batch of 4 through
``prove_many(depth=2)`` (its ring's slots in turn), the sampler's shortfall
(the second read) and a gloo mesh of two ranks; the not-chainable path's
two reads the same.  A returned proof never aliases its slot's buffer,
which keeps its address from prove to prove; ``stream.SERIALIZED`` counts
one layout proof a single-fetch proof and no object serialization.
Tolerance zero: bytes."""

from __future__ import annotations

import hashlib
import queue as queue_mod
import socket
import traceback

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from benchmark.reference import prover as R
from benchmark.reference.airs import fibonacci as RF
from stark_tpu_torch import BatchStarkProver, StarkConfig, StarkProver
from stark_tpu_torch import fri as FRI
from stark_tpu_torch import stream as S
from stark_tpu_torch.field import FiniteField
from stark_tpu_torch.hashfn import Hash
from stark_tpu_torch.models import get_model
from stark_tpu_torch.ops.fieldops import P
from stark_tpu_torch.stream import (
    PATH,
    ROOT,
    VALUES,
    FieldElements,
    MerklePath,
    MerkleRoot,
    ProofLayout,
    ProofStream,
)
from torch_port_support import rand_field

#: (T, tests) -> sha256 of stark_tpu's proof of the Fibonacci trace at
#: blowup 4 (tests/test_golden.py, tests/test_torch_query.py).
GOLDEN = {
    (64, 4): "0fbe172505bfeaaefa39b0fe788e0e84c845958ff92fdc1330338bfc4d31335c",
    (1024, 16): "db5758edd257e895c25f040e3952b6aaebc8e3c5d25ef1408713b3710d2d5559",
}
SHAPES = [(64, 4), (256, 64), (1024, 16), (2048, 64)]
TIMEOUT_S = 300


def _cfg(T: int, tests: int) -> StarkConfig:
    return StarkConfig(trace_length=T, blowup=4, num_colinearity_tests=tests)


def _reference(T: int, tests: int, cols=None) -> bytes:
    cols = RF.trace(T).astype(np.int64) if cols is None else np.asarray(cols, np.int64)
    return R.prove(R.Statement(RF, T, 4, tests), torch.from_numpy(cols))


def _object_path(proof: bytes) -> bytes:
    """The proof parsed and written again object by object."""
    objs = []
    for obj in ProofStream.deserialize(proof, FiniteField()).objects:
        if isinstance(obj, FieldElements):
            obj = FieldElements(obj.values_ints())
        elif isinstance(obj, MerklePath):
            obj = MerklePath(obj.path)
        objs.append(obj)
    return ProofStream(objs).serialize()


def _witnesses(T: int, count: int) -> list[np.ndarray]:
    """(1, T) columns: the Fibonacci trace, then random field values (a
    prove holds no witness to its AIR)."""
    rng = np.random.default_rng(count)
    return [RF.trace(T).astype(np.int64)] + [
        rng.integers(0, P, size=(1, T), dtype=np.int64) for _ in range(count - 1)]


def _sha(b: bytes) -> str:
    return hashlib.sha256(b).hexdigest()


# -- the layout's objects ----------------------------------------------------------


def _filled(layout: ProofLayout, fill) -> np.ndarray:
    buf = layout.buffer()
    fill(layout.views(buf))
    return buf


@pytest.mark.parametrize("k,m", [(1, 1), (3, 3), (16, 3), (5, 8)])
def test_layout_values_equal_objects(k, m):
    rows = rand_field(np.random.default_rng(k * m), (2, k, m))
    layout = ProofLayout(2)
    layout.add("v", k, (VALUES, m))

    def fill(views):
        views["v"][0][...] = rows

    buf = _filled(layout, fill)
    for j in range(2):
        want = ProofStream([FieldElements(tuple(int(v) for v in r)) for r in rows[j]])
        assert buf[j].tobytes() == want.serialize()


@pytest.mark.parametrize("k,L", [(1, 0), (1, 1), (4, 6), (7, 22)])
def test_layout_paths_equal_objects(k, L):
    sib = np.random.default_rng(k + L).integers(0, 256, size=(k, L, 32), dtype=np.uint8)
    layout = ProofLayout(1)
    layout.add("p", k, (PATH, L))

    def fill(views):
        views["p"][0][0] = sib.reshape(k, 32 * L)

    want = ProofStream([MerklePath(tuple(Hash(d.tobytes()) for d in path)) for path in sib])
    assert _filled(layout, fill)[0].tobytes() == want.serialize()


def test_layout_equals_stark_tpu_raw_helpers():
    from stark_tpu import stream as jstream

    rng = np.random.default_rng(3)
    vals = rand_field(rng, 5)
    sib = rng.integers(0, 256, size=(4, 9, 32), dtype=np.uint8)   # (k, L, 32)
    layout = ProofLayout(1)
    layout.add("v", 1, (VALUES, 5))
    layout.add("p", 4, (PATH, 9))

    def fill(views):
        views["v"][0][0, 0] = vals
        views["p"][0][0] = sib.reshape(4, -1)

    level_major = np.ascontiguousarray(sib.transpose(1, 0, 2))
    want = jstream.raw_field_elements(vals) + b"".join(
        jstream.raw_merkle_path(level_major, q) for q in range(4))
    assert _filled(layout, fill)[0].tobytes() == want


def test_records_of_mixed_objects_equal_objects():
    """Records interleave their objects; each proof's row is its own; the
    headers are written by ``buffer`` and no fill touches them."""
    rng = np.random.default_rng(7)
    b, count = 3, 5
    roots = rng.integers(0, 256, size=(b, 2, 32), dtype=np.uint8)
    vals = rand_field(rng, (b, count, 4))
    sib = rng.integers(0, 256, size=(b, count, 3, 32), dtype=np.uint8)
    layout = ProofLayout(b)
    layout.add("roots", 2, (ROOT,))
    layout.add("rows", count, (VALUES, 4), (PATH, 3))
    empty = layout.buffer()
    assert layout.nbytes == 2 * 33 + count * (9 + 32 + 9 + 96)

    def fill(views):
        views["roots"][0][...] = roots
        values, paths = views["rows"]
        values[...] = vals
        paths[...] = sib.reshape(b, count, -1)

    buf = _filled(layout, fill)
    for j in range(b):
        objs = [MerkleRoot(Hash(r.tobytes())) for r in roots[j]]
        for q in range(count):
            objs += [FieldElements(tuple(int(v) for v in vals[j, q])),
                     MerklePath(tuple(Hash(d.tobytes()) for d in sib[j, q]))]
        assert buf[j].tobytes() == ProofStream(objs).serialize()
    # A fill changes payload bytes only.
    headers = empty != 0
    assert (buf[headers] == empty[headers]).all()
    with pytest.raises(ValueError):
        layout.add("rows", 1, (ROOT,))
    with pytest.raises(ValueError):
        layout.views(np.zeros((b, layout.nbytes + 1), dtype=np.uint8))


def test_a_written_stream_serializes_a_copy():
    row = np.arange(40, dtype=np.uint8)
    before = dict(S.SERIALIZED)
    out = ProofStream.written(row).serialize()
    row[0] = 99
    assert type(out) is bytes and out == bytes(range(40))
    assert S.SERIALIZED == {**before, "layout": before["layout"] + 1}


# -- the single-fetch prove through the layout ------------------------------------------


@pytest.mark.parametrize("T,tests", SHAPES)
def test_single_prove_equals_objects_reference_and_pins(T, tests):
    air = get_model("fib")[0]
    prover = StarkProver(air, _cfg(T, tests), device="cpu")
    assert prover.fri._chainable()
    before = dict(S.SERIALIZED)
    proof = prover.prove(trace_cols=RF.trace(T))
    assert S.SERIALIZED == {**before, "layout": before["layout"] + 1}
    assert len(proof) == prover._proof_layout(1).nbytes
    three = StarkProver(air, _cfg(T, tests), device="cpu")
    three.fri.fused_round = False
    assert proof == _object_path(proof) == three.prove(trace_cols=RF.trace(T))
    assert proof == _reference(T, tests)
    if (T, tests) in GOLDEN:
        assert _sha(proof) == GOLDEN[(T, tests)]


def test_two_reads_path_equals_reference():
    """The FRI not chainable (one round at 32 tests): two reads, the
    objects pushed, the query phase's as raw segments written through a
    layout."""
    prover = StarkProver(get_model("fib")[0], _cfg(64, 32), device="cpu")
    assert not prover.fri._chainable()
    before = dict(S.SERIALIZED)
    proof = prover.prove(trace_cols=RF.trace(64))
    assert S.SERIALIZED == {**before, "objects": before["objects"] + 1}
    assert proof == _reference(64, 32)


def test_prove_many_through_a_ring_of_slots():
    """Five batches of 4 at depth 2 (the last padded): the ring's three
    slots take batches in turn, each its own layout buffer at one address,
    and every proof is the reference's of its witness."""
    T, tests, b = 64, 4, 4
    cols = _witnesses(T, 18)
    prover = BatchStarkProver(get_model("fib")[0], _cfg(T, tests), b, device="cpu")
    before = dict(S.SERIALIZED)
    got = prover.prove_many(traces_cols=cols, depth=2)
    assert S.SERIALIZED == {**before, "layout": before["layout"] + 20}
    slots = prover._single._slots[b]
    assert len(slots) == 3 and len({s.proofs.ctypes.data for s in slots}) == 3
    addresses = [s.proofs.ctypes.data for s in slots]
    assert got == [_reference(T, tests, c) for c in cols]
    assert prover.prove_many(traces_cols=cols[:8], depth=2) == got[:8]
    assert [s.proofs.ctypes.data for s in slots] == addresses


def test_a_returned_proof_never_aliases_the_slot():
    T, tests = 256, 16
    prover = StarkProver(get_model("fib")[0], _cfg(T, tests), device="cpu")
    cols = _witnesses(T, 2)
    first = prover.prove(trace_cols=cols[0])
    slot = prover._slots[1][0]
    buf, address, sha = slot.proofs, slot.proofs.ctypes.data, _sha(first)
    second = prover.prove(trace_cols=cols[1])
    assert type(first) is bytes and _sha(first) == sha and second != first
    assert slot.proofs is buf and slot.proofs.ctypes.data == address
    assert second == _reference(T, tests, cols[1])
    assert first == _reference(T, tests, cols[0])


def test_the_shortfall_fills_the_layout_from_the_second_read(monkeypatch):
    # One candidate a proof: every count falls short, and the host's
    # indices go through the query gather in a second read.
    T, tests = 256, 16
    cols = _witnesses(T, 2)
    monkeypatch.setattr(FRI, "_SAMPLE_SLACK", 1 - 2 * tests)
    prover = BatchStarkProver(get_model("fib")[0], _cfg(T, tests), 2, device="cpu")
    got = prover.prove_batch(traces_cols=cols)
    assert prover.fri.shortfalls == 1
    assert got == [_reference(T, tests, c) for c in cols]


# -- a gloo mesh ---------------------------------------------------------------------------


MESH_T, MESH_TESTS = 512, 8


def _mesh_rank(rank: int, size: int, port: int, results) -> None:
    try:
        from stark_tpu_torch.parallel import (DistributedStarkProver, initialize_distributed,
                                              make_mesh)

        torch.set_num_threads(1)
        initialize_distributed(f"127.0.0.1:{port}", size, rank, backend="gloo")
        mesh = make_mesh(device="cpu")
        prover = DistributedStarkProver(get_model("fib")[0], _cfg(MESH_T, MESH_TESTS), mesh)
        before = dict(S.SERIALIZED)
        proofs = [prover.prove(trace_cols=c) for c in _witnesses(MESH_T, 2)]
        counted = {k: S.SERIALIZED[k] - before[k] for k in before}
        results.put((rank, (proofs, counted)))
        mesh.barrier()
        torch.distributed.destroy_process_group()
    except Exception:  # the parent reports it
        results.put((rank, traceback.format_exc()))


def test_a_gloo_mesh_writes_the_same_bytes():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_mesh_rank, args=(rank, 2, port, results), daemon=True)
             for rank in range(2)]
    for p in procs:
        p.start()
    got = {}
    try:
        for _ in procs:
            rank, res = results.get(timeout=TIMEOUT_S)
            assert not isinstance(res, str), f"rank {rank} failed:\n{res}"
            got[rank] = res
    except queue_mod.Empty:
        raise AssertionError(f"the gloo world gave no result in {TIMEOUT_S} s") from None
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
    want = [_reference(MESH_T, MESH_TESTS, c) for c in _witnesses(MESH_T, 2)]
    for rank in range(2):
        proofs, counted = got[rank]
        assert proofs == want, rank
        assert counted == {"layout": 2, "objects": 0}, rank
