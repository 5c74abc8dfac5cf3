"""The single-fetch prove on a slot (StarkProver._dispatch, _Slot, _body):
the port's counterpart of stark_tpu/batch.py:_batch_mega_fn and
stark_tpu/fri.py:_mega_prove_fn, one device program a batch.

On a card the body is one CUDA graph a (B, slot), captured at the slot's
second prove and replayed; on the CPU the same body runs eagerly on the
same slot, every kernel's plain version.  Here: back-to-back proves of two
different witnesses on one prover, so on one reused slot, each byte-equal
to stark_tpu's prove of its witness (Fibonacci T=64, MdsSquareAir T=32,
TwoRegisterFibonacciAir T=128: the sha256 of stark_tpu's proofs of the same
seeded rows, pinned in tests/torch_port_support.py, since its JAX
compiles of the three configurations take over a minute here); prove_many at depth 1, 2 and 3 with B = 2 and 3
over 7 traces (the ring of max(1, depth) + 1 slots rotates and the last
batch is a partial one) equal to sequential prove_batch calls and to
stark_tpu's proofs of the 7 traces, computed here (its BatchStarkProver's
proofs are its single proves' bytes, stark_tpu's tests/test_batch.py, and
tests/test_torch_batch.py holds the port's batches to its BatchStarkProver
directly); close() releases every slot and its graph, and the next
prove makes them anew; a slot reused before its finish() raises;
the forced sampler shortfall through a reused slot keeps its bytes; a
capture's bookkeeping (ops/cuda.taken_back, add_back) takes back what its
body counted, launches and a mesh's collectives (a mesh of one, no group),
and each replay adds it again in order.  On a
card (marker ``gpu``): the graph's replays give the eager body's bytes, one
capture a (B, slot), and the launches counted at capture equal one eager
prove's.  Tolerance zero throughout: proofs are bytes."""

import hashlib

import pytest
import torch

from stark_tpu_torch import BatchStarkProver, StarkConfig, StarkProver
from stark_tpu_torch import fri as FRI
from stark_tpu_torch.models import get_model
from stark_tpu_torch.ops import cuda
from stark_tpu_torch.ops import gather as G
from torch_port_support import PINNED_PAIRS, cuda_device, witnesses  # noqa: F401

TESTS = 4
# sha256 of stark_tpu's Fibonacci proof at T=1024, blowup 4, 16 tests
# (tests/test_torch_chained.py pins the same).
PINNED_FIB_1024 = "db5758edd257e895c25f040e3952b6aaebc8e3c5d25ef1408713b3710d2d5559"


def _config(model: str, trace_length: int) -> StarkConfig:
    return StarkConfig(trace_length=trace_length, blowup=get_model(model)[2],
                       num_colinearity_tests=TESTS)


def _stark_tpu_fib(cfg: StarkConfig, rows: list) -> list:
    """stark_tpu's Fibonacci proofs of ``rows``, one StarkProver prove each."""
    from stark_tpu import StarkConfig as JConfig
    from stark_tpu import StarkProver as JProver
    from stark_tpu.models.fibonacci import FibonacciAir as JFib

    prover = JProver(JFib(), JConfig(trace_length=cfg.trace_length, blowup=cfg.blowup,
                                     num_colinearity_tests=cfg.num_colinearity_tests))
    return [prover.prove(r.tolist()) for r in rows]


@pytest.mark.parametrize("model, trace_length", [("fib", 64), ("mds", 32), ("fib2", 128)])
def test_back_to_back_proves_on_one_slot_equal_stark_tpu(model, trace_length):
    cfg = _config(model, trace_length)
    rows = witnesses(model, trace_length, 2, seed=trace_length)
    prover = StarkProver(get_model(model)[0], cfg, device="cpu")
    # Each witness twice, alternating: a slot that kept anything of the
    # prove before would change the next one's bytes.
    got = [hashlib.sha256(prover.prove(rows[i % 2])).hexdigest() for i in range(4)]
    assert list(prover._slots) == [1] and len(prover._slots[1]) == 1
    want = PINNED_PAIRS[model, trace_length]
    assert got == [want[0], want[1], want[0], want[1]]


@pytest.fixture(scope="module")
def many():
    """7 Fibonacci witnesses at T=64 (the honest trace, then random rows)
    and stark_tpu's proofs of them."""
    cfg = _config("fib", 64)
    rows = witnesses("fib", 64, 7, seed=7)
    return cfg, rows, _stark_tpu_fib(cfg, rows)


@pytest.mark.parametrize("depth", [1, 2, 3])
@pytest.mark.parametrize("b", [2, 3])
def test_prove_many_rotates_the_ring(many, b, depth):
    cfg, rows, want = many
    prover = BatchStarkProver(get_model("fib")[0], cfg, b, device="cpu")
    sequential = []
    for i in range(0, len(rows), b):
        chunk = rows[i : i + b]
        sequential += prover.prove_batch(chunk + [chunk[-1]] * (b - len(chunk)))[: len(chunk)]
    assert sequential == want
    assert prover.prove_many(rows, depth=depth) == want
    # Every batch in flight had a slot of its own: the ring holds
    # min(batches, depth + 1) of them, and prove_batch took the first.
    batches = -(-len(rows) // b)
    assert len(prover._single._slots[b]) == min(batches, max(1, depth) + 1)
    assert not any(slot.busy for slot in prover._single._slots[b])
    assert prover.prove_many(rows, depth=depth) == want


def test_close_releases_every_slot_and_graph(many):
    # A batch prover's ring of three slots, each given a stand-in for its
    # graph: close() releases each once and drops the slots; the next
    # prove_many makes them anew and gives the same bytes.
    cfg, rows, want = many
    prover = BatchStarkProver(get_model("fib")[0], cfg, 2, device="cpu")
    assert prover.prove_many(rows, depth=2) == want
    slots = prover._single._slots[2]
    closed = []

    class Held:
        def close(self):
            closed.append(self)

    graphs = [Held() for _ in slots]
    for slot, graph in zip(slots, graphs):
        slot.graph = graph
    prover.close()
    assert closed == graphs and not prover._single._slots
    assert all(slot.graph is None for slot in slots)
    assert prover.prove_many(rows, depth=2) == want
    assert len(prover._single._slots[2]) == 3


def test_a_slot_reused_before_its_finish_raises():
    model, t = "fib", 64
    cfg = _config(model, t)
    rows = witnesses(model, t, 3, seed=3)
    prover = StarkProver(get_model(model)[0], cfg, device="cpu")
    cols = [prover._witness(r, None)[None] for r in rows]
    want = [prover.prove(r) for r in rows]
    first = prover._dispatch(cols[0])
    with pytest.raises(RuntimeError, match="finish"):
        prover._dispatch(cols[1])
    # A ring of two: a second slot, then none left.
    second = prover._dispatch(cols[1], ring=2)
    with pytest.raises(RuntimeError, match="finish"):
        prover._dispatch(cols[2], ring=2)
    assert first() == [want[0]] and second() == [want[1]]
    assert prover._dispatch(cols[2])() == [want[2]]
    assert len(prover._slots[1]) == 2


def test_a_forced_shortfall_through_a_reused_slot_keeps_its_bytes(monkeypatch):
    # tests/test_torch_chained.py's forced shortfall (one candidate a
    # proof: every count falls short, the host's indices go through the
    # same rule slots in a second read), twice on one slot.
    air, trace_fn, _ = get_model("fib")
    cfg = StarkConfig(trace_length=1024, blowup=4, num_colinearity_tests=16)
    monkeypatch.setattr(FRI, "_SAMPLE_SLACK", 1 - 2 * 16)
    reads = []
    to_host = G.to_host
    monkeypatch.setattr(G, "to_host", lambda t, **kw: reads.append(1) or to_host(t, **kw))
    prover = BatchStarkProver(air, cfg, 2, device="cpu")
    for _ in range(2):
        proofs = prover.prove_batch([trace_fn(1024)] * 2)
        assert [hashlib.sha256(p).hexdigest() for p in proofs] == [PINNED_FIB_1024] * 2
    assert len(reads) == 4 and prover.fri.shortfalls == 2
    assert len(prover._single._slots[2]) == 1


def test_a_capture_takes_its_counts_back_and_each_replay_adds_them():
    # ops/cuda.Graph's bookkeeping (taken_back at its capture, add_back at
    # each replay) over the launch counts and a mesh's collectives (a mesh
    # of one, no process group: its collectives are copies, counted all
    # the same), as the sharded prover's graph holds them.
    from stark_tpu_torch.parallel import make_mesh

    mesh = make_mesh(device="cpu")
    x = torch.arange(8, dtype=torch.int32)
    cuda.reset_launches()
    mesh.all_to_all(x)
    before = (dict(mesh.counts), list(mesh.log), cuda.launch_counts())
    with cuda.taken_back((cuda.LAUNCHES, mesh)) as held:
        mesh.all_to_all(x[:4])
        mesh.exchange(x[:2], [2], [2])
        mesh.all_reduce(x[:1].clone())
        cuda.KERNELS["compose"].launches += 1
        cuda.KERNELS["query_gather"].launches += 2
    # The capture ran nothing: every count is as it was before it.
    assert {k: n for k, n in mesh.counts.items() if n} == before[0]
    assert (mesh.log, cuda.launch_counts()) == before[1:]
    assert held == [(cuda.LAUNCHES, {"compose": 1, "query_gather": 2}),
                    (mesh, [("all_to_all", 4), ("exchange", 2), ("all_reduce", 1)])]
    for _ in range(2):
        cuda.add_back(held)
    assert mesh.log == [("all_to_all", 8)] + [("all_to_all", 4), ("exchange", 2),
                                             ("all_reduce", 1)] * 2
    assert mesh.counts == {"all_to_all": 3, "all_to_all_words": 16, "exchange": 2,
                           "exchange_words": 4, "all_reduce": 2, "all_reduce_words": 2}
    counts = cuda.launch_counts()
    assert (counts["compose"], counts["query_gather"]) == (2, 4)
    assert sum(counts.values()) == 6
    # A body that raises is taken back all the same.
    with pytest.raises(RuntimeError, match="refused"):
        with cuda.taken_back((cuda.LAUNCHES, mesh)):
            mesh.all_gather(x)
            raise RuntimeError("capture refused")
    assert len(mesh.log) == 7 and "all_gather" not in {op for op, _ in mesh.log}
    cuda.reset_launches()


# -- on a card ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 3])
def test_card_graph_replays_equal_the_eager_body(cuda_device, b, monkeypatch):
    air, trace_fn, _ = get_model("fib")
    cfg = StarkConfig(trace_length=1024, blowup=4, num_colinearity_tests=16)
    prover = BatchStarkProver(air, cfg, b, cuda_device)
    single = prover._single
    rows = witnesses("fib", 1024, 7, seed=b)
    captures = []
    graph = cuda.Graph
    monkeypatch.setattr(cuda, "Graph", lambda *a: captures.append(1) or graph(*a))
    with single._eager():
        cuda.reset_launches()
        eager = prover.prove_batch(rows[:b])
        eager_counts = {k: n for k, n in cuda.launch_counts().items() if n}
        eager_many = prover.prove_many(rows, depth=2)
    assert not captures and hashlib.sha256(eager[0]).hexdigest() == PINNED_FIB_1024
    # The slot is warm: the first prove captures it, the later ones replay.
    got = [prover.prove_batch(rows[:b]) for _ in range(3)]
    assert got == [eager] * 3 and len(captures) == 1
    slot = single._slots[b][0]
    assert slot.graph.launches == eager_counts
    cuda.reset_launches()
    assert prover.prove_batch(rows[:b]) == eager
    assert {k: n for k, n in cuda.launch_counts().items() if n} == eager_counts
    # prove_many at depth 2: a ring of 3 slots (the eager run warmed them),
    # one capture each, then replays only.
    for _ in range(2):
        assert prover.prove_many(rows, depth=2) == eager_many
    assert len(captures) == 3 and len(single._slots[b]) == 3
    assert all(s.graph is not None and not s.busy for s in single._slots[b])
