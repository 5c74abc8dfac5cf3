"""The port's sharded prover (stark_tpu_torch.parallel) against stark_tpu.

One module fixture spawns gloo worlds of D = 1, 2 and 4 ranks on the CPU
(torch.multiprocessing, every world at once; D = 1 has no process group);
each rank computes everything below and sends it back, and the tests hold
every rank's results against stark_tpu's single-device functions:

* sharded_ntt / intt / coset_eval / coset_interp / lde shares equal
  stark_tpu.ops.ntt's values at every overlap in {1, 2, 4}; an overlap of
  3 raises; a transform makes exactly three all-to-alls of n/D words a
  rank (stark_tpu's tests/test_parallel.py:207);
* sharded value and row trees equal stark_tpu.merkle's (root, levels,
  paths) above and below the floor (pmerkle.MIN_LOCAL);
* the sharded fold (the exchange of halves, then K4's and K4-dyn's plain
  versions) equals stark_tpu.fri._fold_kernel;
* DistributedStarkProver's proofs equal stark_tpu.StarkProver's, made in
  a module fixture here, on every rank (FibonacciAir T=512 and 1024,
  MdsSquareAir T=128, the two-register Fibonacci T=64: the configurations
  that stark_tpu's own tests prove, so that their compiles are shared):
  on the single-fetch path (the default, with FRI rounds cut down to the
  trees' floor, so that cut codewords and ShardedForest paths go through
  the windowed gather), on the three-read path (``fused_round`` False),
  on the host path, with a forced sampler shortfall and where the FRI is
  not chainable; the port's verifier accepts them and rejects a flipped
  byte; the sha256 pins below are a second check of stark_tpu's proofs; a
  share narrower than the frame's reach is refused;
* the reads from the card a prove on every rank (ops.gather.to_host): one
  on the single-fetch path, with one combine (Mesh.all_reduce) and no
  host-index gather (pmerkle.ShardedGather); two on a shortfall and where
  the FRI is not chainable; three with ``fused_round`` False; every
  rank's fetched words the same;
* the windowed rule plan (pmerkle.ShardedRulePlan, K13's plain version
  and the combine) gathers what ShardedGather gathers with host indices
  on the same sources: a cut and a whole codeword, a ShardedForest's and
  a whole forest's paths, trace openings whose frame offset crosses a
  share's end and wraps mod N;
* BatchStarkProver(mesh=) equals stark_tpu's single proves at B = 4 (D |
  B, the batch cut) and B = 3 (the domain cut where D does not divide B),
  one read a batch, and prove_many at B = 3 with two batches in flight;
  prove_many over three batches at depth 1 and 2 rotates its ring of
  max(1, depth) + 1 slots, every proof stark_tpu's;
* the sharded single-fetch body (StarkProver._body on the mesh) takes
  nothing but its slot: two witnesses proved in turn twice on one slot
  equal stark_tpu's proofs of them, made in this run (and its pins,
  tests/torch_port_support.PINNED_PAIRS), and no read from the card
  happens inside it;
* the graph rule (parallel/pstark.graphs_allowed): a CUDA graph a slot on
  a card with NCCL or no group, never for gloo or on the CPU, the backend
  read from the mesh's group; the gloo and CPU worlds' proves made no
  graph; a capture that fails on rank 0 raises
  on every rank (a stand-in for ops/cuda.Graph; the ranks agree through
  Mesh.agree), and one that succeeds is thread-local with a group.

Tolerance zero: field values and proofs are bytes.  On a card (marker
``gpu``): a mesh of one rank through the kernels equals the CPU, on the
single-fetch path (one read) and the three-read path; its single-fetch
body is captured at the slot's second prove and replayed from the third,
each proof the pin, the launches and collectives those of the eager
body; an NCCL world of one that has captured, its prover closed, tears
its process group down."""

import hashlib
import queue as queue_mod
import socket
import traceback
from concurrent.futures import ProcessPoolExecutor

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from stark_tpu_torch import BatchStarkProver, StarkConfig, StarkVerifier
from stark_tpu_torch.models import FibonacciAir, get_model
from stark_tpu_torch.models.air import BoundaryConstraint
from stark_tpu_torch.ops import hash_batch as HB
from stark_tpu_torch.ops.fieldops import P, primitive_nth_root
from stark_tpu_torch.parallel import (
    DistributedStarkProver,
    DistributedStarkVerifier,
    ShardedFri,
    ShardedGather,
    Shard,
    initialize_distributed,
    make_mesh,
    sharded_coset_eval,
    sharded_coset_interp,
    sharded_intt,
    sharded_lde,
    sharded_ntt,
    sharded_tree_from_rows,
    sharded_tree_from_values,
)
from stark_tpu_torch import fri as FRI
from stark_tpu_torch.merkle import Forest
from stark_tpu_torch.ops import fold as FOLD
from stark_tpu_torch.ops import gather as G
from stark_tpu_torch.parallel import pmerkle
from stark_tpu_torch.ops import cuda
from stark_tpu_torch.parallel.mesh import replicated
from stark_tpu_torch.parallel import pstark
from stark_tpu_torch.parallel.mesh import Mesh
from stark_tpu_torch.parallel.pstark import graphs_allowed
from torch_port_support import PINNED_PAIRS, cuda_device, rand_field, to_torch, witnesses  # noqa: F401

SIZES = (1, 2, 4)
NTT_N, OFFSET, BLOWUP = 256, 3, 4
OVERLAPS = (1, 2, 4)
KINDS = ("ntt", "intt", "coset_eval", "coset_interp", "lde")
TREE_N = 64
PATH_IDX = [0, 1, 5, 31, 32, 63]
FOLD_N, FOLD_ALPHA = 128, (1 << 64) - 5
#: stark_tpu.StarkProver's proofs at blowup 4: (model, T, tests) -> sha256.
PINNED = {
    ("fib", 512, 8): "7f3a6410010bf58c65e8557e5d5442b15453cb31bd48fa2a4e6bf91bdaf2300f",
    ("fib", 1024, 4): "6e753f2093811e582a2d6f99ad4faf4ba85e66a7b6d43ef9edc69a40f37f68aa",
    ("mds", 128, 8): "a77dea7f5bfc25fb6d626df54c277f35c2b0b72c486194310e25fec3c9e695f3",
    ("fib2", 64, 8): "3e258a5e40fafe763c74c423ac28ad3bdda624da0f232b5be205f53ae3a57582",
}
#: A trace too short for four ranks: a share of 4 T / 4 = 4 points, the
#: Fibonacci frame's reach 2 x 4 = 8.
NARROW_T = 4
BATCH_T, BATCHES = 64, (4, 3)
TIMEOUT_S = 600
#: The proves whose reads a prove and fetched words every rank records:
#: (case, reads from the card, combines, host-index gathers, shortfalls).
#: "chain": the single-fetch path (the default) with FRI rounds cut down
#: to the trees' floor; "three": fused_round False; "short": one sampler
#: candidate a proof, the host's indices through the same rule plan;
#: "unchained": a last codeword too wide for K10's seen-mask.
READS = {**{(*c, "chain"): (1, 1, 0, 0) for c in PINNED},
         **{(*c, "three"): (3, 0, 1, 0) for c in PINNED},
         ("fib", 512, 8, "default"): (1, 1, 0, 0),
         ("fib2", 64, 8, "short"): (2, 2, 0, 1),
         ("fib2", 64, 8, "unchained"): (2, 0, 1, 0)}
PROOF_CASES = [*READS, ("fib", 512, 8, "host")]
#: The windowed gather's sources: B codewords of n points and B trace LDEs
#: of c registers, k indices each, the frame offsets of the openings.
WIN_B, WIN_N, WIN_C, WIN_K, WIN_OFFS = 2, 64, 3, 5, (0, 4, 12)
WINDOW_KINDS = ("cut values", "whole values", "cut paths", "whole paths",
                "opening values", "opening paths")
#: Back-to-back proves of two witnesses on one slot (the sharded body's
#: state is its slot's alone): PINNED_PAIRS' configurations, 4 tests.
SLOT_CASES, SLOT_TESTS = (("fib", 64), ("mds", 32)), 4
#: prove_many over 7 batch traces (3 batches of BATCHES[-1] = 3, the last
#: padded) at these depths: a ring of max(1, depth) + 1 slots.
MANY_DEPTHS, MANY_COUNT = (1, 2), 7


class VariantFibAir(FibonacciAir):
    """Fibonacci with only row 1 pinned (tests/test_torch_batch.py)."""

    def boundary_constraints(self, trace_length: int):
        return [BoundaryConstraint(row=1, register=0, value=1)]


def _traces(count: int, length: int = BATCH_T) -> list:
    out = []
    for b in range(count):
        a, c, rows = 1 + b, 1, []
        for _ in range(length):
            rows.append([a])
            a, c = c, (a + c) % P
        out.append(rows)
    return out


def _cfg(T: int, tests: int = 8) -> StarkConfig:
    return StarkConfig(trace_length=T, blowup=BLOWUP, num_colinearity_tests=tests)


def _ntt_input() -> np.ndarray:
    return rand_field(np.random.default_rng(5), (3, NTT_N))


def _tree_input(n: int, rows: bool) -> np.ndarray:
    return rand_field(np.random.default_rng(n + rows), (3, n) if rows else n)


def _fold_input() -> tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(9)
    return rand_field(rng, (2, FOLD_N)), rng.integers(0, 256, size=(2, 32), dtype=np.uint8)


def _fri(mesh=None):
    kw = dict(omega=primitive_nth_root(FOLD_N), offset=OFFSET, domain_length=FOLD_N,
              expansion_factor=4, num_colinearity_tests=4)
    if mesh is None:
        return kw
    return ShardedFri(**kw, mesh=mesh)


def _counted_prove(mesh, prove) -> tuple:
    """(``prove()``'s result, what it read: the reads from the card
    (ops.gather.to_host calls), the sha256 of the words they fetched, the
    combines (Mesh.all_reduce) and the host-index gathers
    (pmerkle.ShardedGather.fetch))."""
    reads, fetches = [], []
    to_host, fetch = G.to_host, pmerkle.ShardedGather.fetch

    def counted(t, **kw):
        got = to_host(t, **kw)
        reads.append(got)
        return got

    G.to_host = counted
    pmerkle.ShardedGather.fetch = lambda self: fetches.append(1) or fetch(self)
    mesh.reset_counts()
    try:
        proof = prove()
    finally:
        G.to_host, pmerkle.ShardedGather.fetch = to_host, fetch
    words = [r.wait() if isinstance(r, G.Pending) else r for r in reads]
    return proof, {"reads": len(reads),
                   "fetched": hashlib.sha256(b"".join(w.tobytes() for w in words)).hexdigest(),
                   "combines": mesh.counts.get("all_reduce", 0), "host_plans": len(fetches)}


def _window_inputs() -> tuple:
    """The windowed gather's whole sources and indices, from a seed: (B, n)
    codewords, (B, c, N) trace LDEs (N = n), (B, k) indices among which
    some put an opening's frame across a share's end or past N."""
    rng = np.random.default_rng(11)
    cw = rand_field(rng, (WIN_B, WIN_N))
    lde = rand_field(rng, (WIN_B, WIN_C, WIN_N))
    idx = rng.integers(0, 1 << 30, size=(WIN_B, WIN_K)).astype(np.int64)
    idx[0, :3] = (WIN_N // 4 - 2, WIN_N // 2 - 1, WIN_N // 8 - 5)
    idx[1, :2] = (WIN_N // 2 - 3, 3 * WIN_N // 8 - 1)
    return cw, lde, idx


def _window(mesh) -> dict:
    """{kind: (the rule plan's words after the combine, ShardedGather's
    words of the same reads with host indices)}: the same sources, cut
    over the mesh (the trees at MIN_LOCAL leaves a share and more) and
    whole."""
    cw_np, lde_np, idx_np = _window_inputs()
    b, n, c, k = WIN_B, WIN_N, WIN_C, WIN_K
    lo, hi = mesh.bounds(n)
    cut = Shard(mesh, to_torch(cw_np)[:, lo:hi].contiguous(), n)
    whole = replicated(mesh, to_torch(cw_np))
    lde = Shard(mesh, to_torch(lde_np)[..., lo:hi].contiguous(), n)
    cut_tree = pmerkle.sharded_forest(Shard(mesh, cut.local[:, None, :], n))
    whole_tree = Forest.from_values(whole.local)
    lde_tree = pmerkle.sharded_forest(lde)
    depth = n.bit_length() - 1
    ab = G.Rule(b, k, n // 2, h=2, stride=n)
    opening = dict(rows=b, number=k, half=n // 2, h=2, offsets=WIN_OFFS, wrap=n, order=1)
    plan = pmerkle.ShardedRulePlan(mesh)
    src = [plan.values_source((b, n), b * n, split=True),
           plan.values_source((b, n), b * n),
           plan.stack_source(b * n, depth, split=True),
           plan.stack_source(b * n, depth),
           plan.values_source((b, c, n), n, c, split=True),
           plan.stack_source(b * n, depth, split=True)]
    slots = [plan.values(src[0], ab), plan.values(src[1], ab), plan.paths(src[2], ab),
             plan.paths(src[3], ab), plan.values(src[4], G.Rule(stride=c * n, **opening)),
             plan.paths(src[5], G.Rule(stride=n, **opening))]
    idx = torch.from_numpy(idx_np.astype(np.int32))
    out = torch.empty(plan.words, dtype=torch.int32)
    words = plan.run([cut, whole, cut_tree, whole_tree.stack, lde, lde_tree], idx, out).numpy()
    # The same reads with host indices.
    rows = np.arange(b, dtype=np.int64)[:, None]
    a = idx_np % (n // 2)
    flat = np.concatenate([a, a + n // 2], axis=1) + n * rows
    q = np.stack([a, a + n // 2], axis=2).reshape(b, -1, 1)
    cols = ((q + np.asarray(WIN_OFFS)) % n).reshape(b, -1)
    host = ShardedGather(mesh)
    hslots = [host.values(cut.reshape(-1), flat), host.values(whole.reshape(-1), flat),
              host.paths(cut_tree.stack, flat), host.paths(whole_tree.stack, flat, depth),
              [host.values(lde[j], cols[j]) for j in range(b)],
              host.paths(lde_tree.stack, lde_tree.global_index(cols), depth)]
    fetched = host.fetch()
    out_words = words.view(np.uint32)
    got = {}
    for kind, slot, hslot in zip(WINDOW_KINDS, slots, hslots):
        want = (np.concatenate([s.take(fetched) for s in hslot]) if isinstance(hslot, list)
                else hslot.take(fetched))
        got[kind] = (slot.take(out_words), want,
                     isinstance(lde_tree if "opening" in kind else cut_tree,
                                pmerkle.ShardedForest))
    return got


def _slot_proves(mesh) -> dict:
    """Per SLOT_CASES configuration, on one DistributedStarkProver (FRI
    rounds cut down to the trees' floor): the two witnesses proved in turn
    twice on its one slot (sha256s), the depth of the body
    (StarkProver._body) at each read from the card (ops.gather.to_host),
    the slots, whether graphs are on and the slot holds one; then the
    capture of that slot through a stand-in for ops/cuda.Graph that fails
    on rank 0 (the message each rank raises) and one that succeeds (the
    capture mode it was given)."""
    out = {}
    to_host = G.to_host
    for model, T in SLOT_CASES:
        air, _, blowup = get_model(model)
        cfg = StarkConfig(trace_length=T, blowup=blowup, num_colinearity_tests=SLOT_TESTS)
        prover = DistributedStarkProver(air, cfg, mesh)
        prover.fri.min_share = pmerkle.MIN_LOCAL
        rows = witnesses(model, T, 2, seed=T)
        body, depth, reads = prover._body, [0], []

        def in_body(*args, body=body, depth=depth):
            depth[0] += 1
            try:
                return body(*args)
            finally:
                depth[0] -= 1

        prover._body = in_body
        G.to_host = lambda t, depth=depth, **kw: reads.append(depth[0]) or to_host(t, **kw)
        try:
            shas = [hashlib.sha256(prover.prove(rows[i % 2])).hexdigest() for i in range(4)]
        finally:
            G.to_host = to_host
        slots = prover._slots[1]
        out[(model, T)] = {"shas": shas, "reads": reads, "slots": len(slots),
                           "graphs": prover._graphs, "graph": slots[0].graph is not None}
    # The rule reads the backend from the group, not from the mesh's label
    # (a Mesh made with a group and no backend).
    rule, seen = pstark.graphs_allowed, []
    pstark.graphs_allowed = lambda *args: seen.append(args) or rule(*args)
    try:
        DistributedStarkProver(air, cfg, Mesh(mesh.group, mesh.rank, mesh.size, "cpu"))
    finally:
        pstark.graphs_allowed = rule
    out["rule"] = seen
    graph = cuda.Graph

    def refusing(body, device, ledgers=(), mode="global"):
        if mesh.rank == 0:
            raise RuntimeError("capture refused")
        return ("captured", mode, ledgers == (mesh,))

    cuda.Graph = refusing
    try:
        try:
            prover._capture(slots[0])
            out["refused"] = ""
        except RuntimeError as e:
            out["refused"] = str(e)
        cuda.Graph = lambda body, device, ledgers=(), mode="global": (
            "captured", mode, ledgers == (mesh,))
        out["captured"] = prover._capture(slots[0])
    finally:
        cuda.Graph = graph
    return out


def _prove_many(mesh) -> dict:
    """{depth: (prove_many's proofs of MANY_COUNT traces at B = 3, the
    slots the batch's prover made, whether any is still busy)}."""
    b = BATCHES[-1]
    traces = (_traces(b) * 3)[:MANY_COUNT]
    out = {}
    for depth in MANY_DEPTHS:
        prover = BatchStarkProver(VariantFibAir(), _cfg(BATCH_T, 4), b, mesh=mesh)
        proofs = prover.prove_many(traces, depth=depth)
        slots = prover._single._slots[b // (mesh.size if prover._cut else 1)]
        out[depth] = (proofs, len(slots), any(s.busy or s.graph is not None for s in slots))
    return out


def _rank_results(mesh) -> dict:
    """Everything the tests compare, from this rank (numpy and bytes)."""
    size = mesh.size
    out = {"ntt": {}, "trees": {}}
    x = to_torch(_ntt_input())
    lo, hi = mesh.bounds(NTT_N)
    share = x[:, lo:hi]
    for overlap in OVERLAPS:
        out["ntt"][("ntt", overlap)] = sharded_ntt(share, mesh, overlap).numpy()
        out["ntt"][("intt", overlap)] = sharded_intt(share, mesh, overlap).numpy()
        out["ntt"][("coset_eval", overlap)] = sharded_coset_eval(
            share, OFFSET, mesh, overlap).numpy()
        out["ntt"][("coset_interp", overlap)] = sharded_coset_interp(
            share, OFFSET, mesh, overlap).numpy()
        out["ntt"][("lde", overlap)] = sharded_lde(share, BLOWUP, OFFSET, mesh,
                                                   overlap).numpy()
    counts = {}
    for overlap in (1, 2):
        mesh.reset_counts()
        sharded_ntt(x[0, lo:hi], mesh, overlap)
        counts[overlap] = list(mesh.log)
    out["counts"] = counts
    # Trees above the floor (TREE_N) and below it (2 leaves a rank).
    for n in (TREE_N, 2 * size):
        for rows in (False, True):
            v = to_torch(_tree_input(n, rows))
            tlo, thi = mesh.bounds(n)
            tree = (sharded_tree_from_rows(v[:, tlo:thi], mesh) if rows
                    else sharded_tree_from_values(v[tlo:thi], mesh))
            whole = tree.tree(0)
            plan = ShardedGather(mesh)
            idx = [i % n for i in PATH_IDX]
            slot = plan.paths(tree.stack, idx, tree.depth)
            out["trees"][(n, rows)] = {
                "sharded": isinstance(tree, pmerkle.ShardedForest),
                "root": bytes(tree.roots_dev()[0].numpy().tobytes()),
                "levels": whole.levels, "paths": slot.take(plan.fetch())}
    # The fold of a cut codeword: host path (K4's plain version) and chain
    # (K4-dyn's: the root absorbed, the challenge drawn, the fold).
    cw, roots = _fold_input()
    sf = _fri(mesh)
    flo, fhi = mesh.bounds(FOLD_N)
    shard = Shard(mesh, to_torch(cw)[:, flo:fhi], FOLD_N)
    halves, ladder = sf._halves(shard, 0)
    host = torch.stack([FOLD.fold(h, ladder, FOLD_ALPHA) for h in halves])
    sponge = HB.Sponge(2, "cpu")
    sponge.absorb(torch.from_numpy(roots.copy()))
    alpha = torch.empty(2, dtype=torch.int32)
    chain = FOLD.fold_dyn(halves, ladder, sponge, torch.from_numpy(roots.copy()),
                          copy=torch.empty((2, 32), dtype=torch.uint8), alpha=alpha)
    half = FOLD_N // 2
    out["fold"] = {
        "host": Shard(mesh, host, half).whole().numpy(),
        "chain": Shard(mesh, chain, half).whole().numpy(), "alpha": alpha.numpy()}
    # Proofs: the single-fetch and the three-read paths with the NTT in
    # chunks (overlap 2) and FRI rounds cut down to the trees' floor, the
    # host path so cut, the defaults (overlap 1; at these sizes every FRI
    # round whole), a forced shortfall and a FRI that is not chainable;
    # each prove's reads.
    proofs, reads = {}, {}
    for case in PROOF_CASES:
        model, T, tests, path = case
        air, trace_fn, _ = get_model(model)
        prover = DistributedStarkProver(air, _cfg(T, tests), mesh,
                                        overlap=2 if path in ("chain", "three") else 1)
        if path != "default":
            prover.fri.min_share = pmerkle.MIN_LOCAL
        prover.fri.fused_round = path != "three"
        prover.fri.device_chain = path != "host"
        slack, reduced = FRI._SAMPLE_SLACK, FRI._SAMPLE_MAX_REDUCED
        if path == "short":
            FRI._SAMPLE_SLACK = 1 - 2 * tests  # one candidate a proof
        if path == "unchained":
            FRI._SAMPLE_MAX_REDUCED = 0
        try:
            proofs[case], reads[case] = _counted_prove(mesh, lambda: prover.prove(trace_fn(T)))
            reads[case]["chainable"] = prover.fri._chainable()
            reads[case]["graphs"] = (prover._graphs, sorted(prover._slots),
                                     [s.graph for v in prover._slots.values() for s in v])
        finally:
            FRI._SAMPLE_SLACK, FRI._SAMPLE_MAX_REDUCED = slack, reduced
        reads[case]["shortfalls"] = prover.fri.shortfalls
    out["proofs"], out["reads"] = proofs, reads
    out["window"] = _window(mesh)
    try:
        DistributedStarkProver(air, _cfg(NARROW_T), mesh)
        out["narrow"] = ""
    except ValueError as e:
        out["narrow"] = str(e)
    out["batch"], out["batch_reads"] = {}, {}
    for b in BATCHES:
        prover = BatchStarkProver(VariantFibAir(), _cfg(BATCH_T, 4), b, mesh=mesh)
        out["batch"][b], got = _counted_prove(mesh, lambda: prover.prove_batch(_traces(b)))
        out["batch_reads"][b] = got["reads"]
    # Batches in flight: two batches of 3 (the last padded), depth 2.
    out["many"] = prover.prove_many(_traces(max(BATCHES)), depth=2)
    out["ring"] = _prove_many(mesh)
    out["slot"] = _slot_proves(mesh)
    return out


def _worker(rank: int, size: int, port: int, results) -> None:
    """One rank of a world of ``size`` on the CPU (gloo; none for one)."""
    try:
        torch.set_num_threads(1)
        if size > 1:
            initialize_distributed(f"127.0.0.1:{port}", size, rank, backend="gloo")
        mesh = make_mesh(device="cpu")
        results.put((size, rank, _rank_results(mesh)))
        mesh.barrier()
        if size > 1:
            torch.distributed.destroy_process_group()
    except Exception:  # the parent reports it and stops the world
        results.put((size, rank, traceback.format_exc()))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _stark_tpu_proofs(case) -> list[bytes]:
    """stark_tpu's proofs of one case, in a process of its own: StarkProver
    with its own models at a PINNED configuration, ("slot", model, T) of
    the two witnesses of a SLOT_CASES configuration, or ("batch",) with the
    variant AIR, one proof of each batch trace."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    from stark_tpu import StarkConfig as JConfig
    from stark_tpu import StarkProver as JProver
    from stark_tpu.models import get_model as j_get_model
    from stark_tpu.models.air import BoundaryConstraint as JBoundary
    from stark_tpu.models.fibonacci import FibonacciAir as JFib
    from stark_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache(allow_cpu=True)

    class JVariant(JFib):
        def boundary_constraints(self, trace_length: int):
            return [JBoundary(row=1, register=0, value=1)]

    if case[0] == "slot":
        # The two witnesses of a SLOT_CASES configuration (blowup as its
        # model gives it).
        _, model, T = case
        air, _, blowup = j_get_model(model)
        cfg = JConfig(trace_length=T, blowup=blowup, num_colinearity_tests=SLOT_TESTS)
        return [JProver(air, cfg).prove(rows.tolist())
                for rows in witnesses(model, T, 2, seed=T)]
    if case == ("batch",):
        single = JProver(JVariant(), JConfig(trace_length=BATCH_T, blowup=BLOWUP,
                                             num_colinearity_tests=4))
        # _traces(b) is the first b of _traces(max(BATCHES)).
        return [single.prove(t) for t in _traces(max(BATCHES))]
    model, T, tests = case
    air, trace_fn, _ = j_get_model(model)
    cfg = JConfig(trace_length=T, blowup=BLOWUP, num_colinearity_tests=tests)
    return [JProver(air, cfg).prove(trace_fn(T))]


@pytest.fixture(scope="module")
def reference_jobs():
    """stark_tpu's proofs (:func:`_stark_tpu_proofs`), each case in a process
    of its own, all started at once: XLA's compiles take the most of their
    time, and they run beside the gloo worlds."""
    cases = [*PINNED, *(("slot", *c) for c in SLOT_CASES), ("batch",)]
    with ProcessPoolExecutor(len(cases), mp_context=mp.get_context("spawn")) as pool:
        yield {case: pool.submit(_stark_tpu_proofs, case) for case in cases}


@pytest.fixture(scope="module")
def reference(reference_jobs):
    """({PINNED case: stark_tpu's proof}, stark_tpu's proofs of the batch
    traces, {SLOT_CASES case: stark_tpu's proofs of its two witnesses})."""
    got = {case: job.result(timeout=TIMEOUT_S) for case, job in reference_jobs.items()}
    return ({case: got[case][0] for case in PINNED}, got[("batch",)],
            {case: got[("slot", *case)] for case in SLOT_CASES})


@pytest.fixture(scope="module")
def worlds(reference_jobs):
    """{D: [rank 0's results, ...]} for every D in SIZES, all worlds at
    once (stark_tpu's proofs start first and run meanwhile)."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_worker, args=(rank, size, port, results), daemon=True)
             for size, port in ((s, _free_port()) for s in SIZES) for rank in range(size)]
    for p in procs:
        p.start()
    got: dict = {size: [None] * size for size in SIZES}
    try:
        for _ in procs:
            size, rank, res = results.get(timeout=TIMEOUT_S)
            if isinstance(res, str):
                raise AssertionError(f"rank {rank} of {size} failed:\n{res}")
            got[size][rank] = res
    except queue_mod.Empty:
        raise AssertionError(f"the gloo worlds gave no result in {TIMEOUT_S} s") from None
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
    return got


@pytest.fixture(scope="module")
def ntt_reference():
    """stark_tpu.ops.ntt's values of the transforms' input."""
    import jax.numpy as jnp

    from stark_tpu.ops import ntt as JNTT

    x = jnp.asarray(_ntt_input())
    return {"ntt": np.asarray(JNTT.ntt(x)), "intt": np.asarray(JNTT.intt(x)),
            "coset_eval": np.asarray(JNTT.coset_eval(x, OFFSET)),
            "coset_interp": np.asarray(JNTT.coset_interp(x, OFFSET)),
            "lde": np.asarray(JNTT.lde(x, BLOWUP, OFFSET))}


def _whole(shares: list) -> np.ndarray:
    return np.concatenate(shares, axis=-1).astype(np.uint32)


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("overlap", OVERLAPS)
def test_sharded_transforms_match_stark_tpu(worlds, ntt_reference, size, kind, overlap):
    shares = [r["ntt"][(kind, overlap)] for r in worlds[size]]
    np.testing.assert_array_equal(_whole(shares), ntt_reference[kind])


def test_overlap_not_a_power_of_two_raises():
    mesh = make_mesh(device="cpu")
    x = to_torch(_ntt_input())
    with pytest.raises(ValueError, match="power of two"):
        sharded_ntt(x, mesh, overlap=3)
    with pytest.raises(ValueError, match="D\\^2"):
        sharded_ntt(x[:, :8], mesh)


@pytest.mark.parametrize("size", SIZES)
def test_transform_makes_three_all_to_alls_of_n_over_d_words(worlds, size):
    for r in worlds[size]:
        assert r["counts"][1] == [("all_to_all", NTT_N // size)] * 3
        # overlap 2: each exchange in two chunks of half the words
        assert r["counts"][2] == [("all_to_all", NTT_N // size // 2)] * 6


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("where", ["above", "below"])
@pytest.mark.parametrize("rows", [False, True], ids=["values", "rows"])
def test_sharded_tree_matches_stark_tpu(worlds, size, where, rows):
    from stark_tpu.hashfn import Hash as JHash
    from stark_tpu.merkle import MerkleTree as JTree
    from stark_tpu.ops import hash_batch as JHB

    n = TREE_N if where == "above" else 2 * size
    v = _tree_input(n, rows)
    if rows:
        jt = JTree.from_leaf_digests(JHB.digests_to_bytes(JHB.row_hash_core(np, v)))
    else:
        jt = JTree([JHash.from_field_elements([int(x)]) for x in v])
    for r in worlds[size]:
        got = r["trees"][(n, rows)]
        assert got["sharded"] == (where == "above")
        assert got["root"] == jt.root.data
        assert len(got["levels"]) == len(jt.levels)
        for a, b in zip(got["levels"], jt.levels):
            np.testing.assert_array_equal(a, b)
        for i, path in zip([i % n for i in PATH_IDX], got["paths"]):
            assert [bytes(h.tobytes()) for h in path] == [h.data for h in jt.open(i)]


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("path", ["host", "chain"])
def test_sharded_fold_matches_stark_tpu(worlds, size, path):
    import jax.numpy as jnp

    from stark_tpu.fri import _INV2, _INV2_SHOUP, Fri as JFri, _fold_kernel
    from stark_tpu.ops.fieldops import shoup_precompute

    cw, _ = _fold_input()
    ladder = JFri(**_fri())._plan.inv_x_mont(0)
    half = FOLD_N // 2
    for r in worlds[size]:
        got = r["fold"][path]
        alphas = [FOLD_ALPHA] * 2 if path == "host" else [int(a) for a in r["fold"]["alpha"]]
        for row, alpha in enumerate(alphas):
            a = alpha % P
            want = _fold_kernel(jnp.asarray(cw[row, :half]), jnp.asarray(cw[row, half:]),
                                ladder, jnp.uint32(a), jnp.uint32(int(shoup_precompute(a))),
                                jnp.uint32(_INV2), jnp.uint32(_INV2_SHOUP))
            np.testing.assert_array_equal(got[row].astype(np.uint32), np.asarray(want))
    # Every rank drew the same challenges from its replicated sponge.
    assert len({r["fold"]["alpha"].tobytes() for r in worlds[size]}) == 1


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("case", PROOF_CASES, ids=lambda c: "-".join(map(str, c)))
def test_distributed_proofs_match_stark_tpu(worlds, reference, size, case):
    model, T, tests, path = case
    air = get_model(model)[0]
    # The body eager (graphs off on the CPU, with a gloo group or none);
    # the three-read, the host and the not-chainable paths make no slot.
    on_slot = path in ("chain", "default", "short")
    for rank, r in enumerate(worlds[size]):
        assert r["proofs"][case] == reference[0][(model, T, tests)], f"rank {rank}"
        assert r["reads"][case]["graphs"] == (False, [1] if on_slot else [],
                                              [None] if on_slot else []), f"rank {rank}"
    proof = worlds[size][0]["proofs"][case]
    verifier = DistributedStarkVerifier(air, _cfg(T, tests))
    assert verifier.verify(proof)
    bad = bytearray(proof)
    bad[len(bad) // 2] ^= 1
    assert not verifier.verify(bytes(bad))


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("case", list(READS), ids=lambda c: "-".join(map(str, c)))
def test_reads_from_the_card_a_sharded_prove(worlds, size, case):
    reads, combines, host_plans, shortfalls = READS[case]
    for rank, r in enumerate(worlds[size]):
        got = r["reads"][case]
        assert (got["reads"], got["combines"], got["host_plans"], got["shortfalls"]) == (
            reads, combines, host_plans, shortfalls), f"rank {rank}: {got}"
        assert got["chainable"] == (case[3] in ("chain", "default", "short"))


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("case", list(READS), ids=lambda c: "-".join(map(str, c)))
def test_every_rank_fetches_the_same_words(worlds, size, case):
    assert len({r["reads"][case]["fetched"] for r in worlds[size]}) == 1


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("kind", WINDOW_KINDS)
def test_windowed_rule_plan_equals_host_index_gather(worlds, size, kind):
    for rank, r in enumerate(worlds[size]):
        got, want, sharded_tree = r["window"][kind]
        np.testing.assert_array_equal(got, want, err_msg=f"rank {rank}")
        # The trees are ShardedForests: their paths take the two parts.
        assert sharded_tree
    if "values" in kind:
        cw, lde, _ = _window_inputs()
        # Values of every rank's share among them: not zeros of the combine.
        assert got.size and np.isin(got, (lde if "opening" in kind else cw)).all()


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("batch", BATCHES)
def test_batch_mesh_matches_single_proves(worlds, reference, size, batch):
    want = reference[1][:batch]
    for r in worlds[size]:
        assert r["batch"][batch] == want
        assert r["batch_reads"][batch] == 1
    assert StarkVerifier(VariantFibAir(), _cfg(BATCH_T, 4)).verify_batch(want) == [True] * batch


@pytest.mark.parametrize("size", SIZES)
def test_batch_mesh_prove_many_keeps_batches_in_flight(worlds, reference, size):
    assert BATCHES[-1] == 3
    for r in worlds[size]:
        assert r["many"] == reference[1]


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("depth", MANY_DEPTHS)
def test_batch_mesh_prove_many_rotates_its_ring(worlds, reference, size, depth):
    # B = 3: the domain cut on two and four ranks (the sharded body on its
    # slots), the batch cut on one; three batches, the last padded.
    want = (reference[1][: BATCHES[-1]] * 3)[:MANY_COUNT]
    for rank, r in enumerate(worlds[size]):
        proofs, slots, held = r["ring"][depth]
        assert proofs == want, f"rank {rank}"
        assert slots == max(1, depth) + 1 and not held, f"rank {rank}"


#: parallel/pstark.graphs_allowed: (mesh device, its group's backend; None
#: for no group) -> whether the sharded body is one CUDA graph a slot.
GRAPH_RULE = {("cpu", None): False, ("cpu", "gloo"): False, ("cpu", "nccl"): False,
              ("cuda", None): True, ("cuda", "gloo"): False, ("cuda", "nccl"): True}


@pytest.mark.parametrize("device, backend", list(GRAPH_RULE), ids=str)
def test_graph_rule(device, backend):
    assert graphs_allowed(device, backend) is GRAPH_RULE[device, backend]


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("case", SLOT_CASES, ids=lambda c: "-".join(map(str, c)))
def test_sharded_body_on_one_slot_equals_stark_tpu(worlds, reference, size, case):
    # Each witness twice, alternating, on one slot: a body that kept
    # anything but its slot's state would change the next proof; one read
    # a prove, none from inside the body.  The want is stark_tpu's proofs
    # of this run; the pins (tests/test_torch_mega.py's) are those too.
    want = tuple(hashlib.sha256(p).hexdigest() for p in reference[2][case])
    assert want == PINNED_PAIRS[case]
    for rank, r in enumerate(worlds[size]):
        got = r["slot"][case]
        assert got["shas"] == [want[0], want[1], want[0], want[1]], f"rank {rank}"
        assert got["reads"] == [0] * 4, f"rank {rank}: reads at body depth {got['reads']}"
        assert (got["slots"], got["graphs"], got["graph"]) == (1, False, False)
        assert r["slot"]["rule"] == [("cpu", "gloo" if size > 1 else None)]


@pytest.mark.parametrize("size", SIZES)
def test_a_failed_capture_raises_on_every_rank(worlds, size):
    for rank, r in enumerate(worlds[size]):
        if rank == 0:
            assert r["slot"]["refused"] == "capture refused"
        else:
            assert r["slot"]["refused"] == (f"rank {rank}: the CUDA graph capture failed on "
                                            "another rank of the mesh")
        # A capture that succeeds everywhere: thread-local with a process
        # group, the mesh's collectives held with the launches.
        mode = "thread_local" if size > 1 else "global"
        assert r["slot"]["captured"] == ("captured", mode, True)


def test_pinned_proofs_are_the_single_prove(reference):
    """The pins are stark_tpu's single-device proofs of this run: the
    sharded proofs above meet both."""
    for case, want in PINNED.items():
        assert hashlib.sha256(reference[0][case]).hexdigest() == want, case


@pytest.mark.parametrize("size", SIZES)
def test_share_narrower_than_the_frame_reach_is_refused(worlds, size):
    for r in worlds[size]:
        if 4 * NARROW_T // size < 2 * 4:
            assert "narrower than the frame's reach of 8 points" in r["narrow"]
        else:
            assert r["narrow"] == ""


def test_initialize_distributed_partial_env_raises(monkeypatch):
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    for var in ("MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(RuntimeError, match="partial distributed.*MASTER_PORT, WORLD_SIZE, RANK"):
        initialize_distributed()
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="missing: MASTER_PORT, RANK"):
        initialize_distributed()


def test_initialize_distributed_absent_env_is_single_process(monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    assert initialize_distributed() is None
    assert not torch.distributed.is_initialized()
    mesh = make_mesh(device="cpu")
    assert (mesh.rank, mesh.size, mesh.group) == (0, 1, None)


def test_mesh_devices_are_explicit():
    with pytest.raises(ValueError, match="devices"):
        make_mesh(n_devices=2, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh()


@pytest.mark.gpu
def test_mesh_of_one_on_card_matches_cpu(cuda_device):
    mesh = make_mesh(device=cuda_device)
    x = to_torch(_ntt_input())
    for overlap in OVERLAPS:
        got = sharded_lde(x.to(cuda_device), BLOWUP, OFFSET, mesh, overlap).cpu()
        assert torch.equal(got, sharded_lde(x, BLOWUP, OFFSET, make_mesh(device="cpu"),
                                            overlap))
    air, trace_fn, _ = get_model("mds")
    prover = DistributedStarkProver(air, _cfg(128), mesh)
    prover.fri.min_share = pmerkle.MIN_LOCAL
    proof = prover.prove(trace_fn(128))
    assert hashlib.sha256(proof).hexdigest() == PINNED[("mds", 128, 8)]


@pytest.mark.gpu
@pytest.mark.parametrize("path", ["chain", "three"])
def test_mesh_of_one_single_fetch_on_card(cuda_device, path):
    from stark_tpu_torch.ops import cuda

    mesh = make_mesh(device=cuda_device)
    air, trace_fn, _ = get_model("fib")
    prover = DistributedStarkProver(air, _cfg(1024, 4), mesh)
    prover.fri.min_share = pmerkle.MIN_LOCAL
    prover.fri.fused_round = path == "chain"
    cuda.reset_launches()
    proof, got = _counted_prove(mesh, lambda: prover.prove(trace_fn(1024)))
    counts = cuda.launch_counts()
    assert hashlib.sha256(proof).hexdigest() == PINNED[("fib", 1024, 4)]
    single = path == "chain"
    assert got["reads"] == (1 if single else 3)
    assert got["combines"] == int(single) and got["host_plans"] == int(not single)
    for k in ("constraint_challenges", "sample_indices"):
        assert counts[k] == int(single), k
    assert counts["query_gather"] == 1


@pytest.mark.gpu
@pytest.mark.parametrize("overlap", [1, 2])
def test_mesh_of_one_graph_on_card(cuda_device, overlap, monkeypatch):
    # A mesh of one on the card (no group: its collectives are copies):
    # the slot's first prove runs the body eagerly, the second captures it
    # and replays, the third replays; every proof the pin, one read, and
    # the launches and collectives counted equal to the eager body's.
    mesh = make_mesh(device=cuda_device)
    air, trace_fn, _ = get_model("fib")
    prover = DistributedStarkProver(air, _cfg(1024, 4), mesh, overlap=overlap)
    prover.fri.min_share = pmerkle.MIN_LOCAL
    assert prover._graphs
    captures = []
    graph = cuda.Graph
    monkeypatch.setattr(cuda, "Graph", lambda *a: captures.append(a) or graph(*a))
    rows = trace_fn(1024)

    def counted():
        cuda.reset_launches()
        proof, got = _counted_prove(mesh, lambda: prover.prove(rows))
        assert hashlib.sha256(proof).hexdigest() == PINNED[("fib", 1024, 4)]
        assert (got["reads"], got["combines"], got["host_plans"]) == (1, 1, 0)
        return ({k: n for k, n in cuda.launch_counts().items() if n}, dict(mesh.counts),
                list(mesh.log))

    first = counted()
    slot = prover._slots[1][0]
    assert not captures and slot.graph is None
    second = counted()
    assert len(captures) == 1 and slot.graph is not None
    assert counted() == second == first
    assert slot.graph.launches == first[0]
    assert [e for ledger, held in slot.graph.held if ledger is mesh for e in held] == first[2]
    with prover._eager():
        assert counted() == first
    assert len(captures) == 1
    # close() releases the slot and its graph; the next prove starts anew.
    prover.close()
    assert not prover._slots
    assert counted() == first and prover._slots[1][0].graph is None


def _nccl_teardown(port: int, results) -> None:
    """An NCCL world of one rank on the card: three proves on one slot (the
    third replays the graph captured at the second, NCCL's collectives
    inside), the prover closed, the process group destroyed; puts the
    proofs' sha256s and whether a graph was held, or the traceback."""
    try:
        initialize_distributed(f"127.0.0.1:{port}", 1, 0, backend="nccl")
        mesh = make_mesh(device="cuda:0")
        air, trace_fn, _ = get_model("fib")
        prover = DistributedStarkProver(air, _cfg(1024, 4), mesh)
        prover.fri.min_share = pmerkle.MIN_LOCAL
        rows = trace_fn(1024)
        shas = [hashlib.sha256(prover.prove(rows)).hexdigest() for _ in range(3)]
        held = prover._slots[1][0].graph is not None
        # The prover stays referenced: only close() releases its graph.
        prover.close()
        torch.cuda.synchronize()
        torch.distributed.destroy_process_group()
        results.put((shas, held, prover._graphs))
    except Exception:  # the parent reports it
        results.put(traceback.format_exc())


@pytest.mark.gpu
def test_nccl_mesh_of_one_tears_down_after_a_capture(cuda_device):
    # destroy_process_group waits for every CUDA graph that holds NCCL's
    # operations: a prover that captured, then closed, lets it finish.
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    proc = ctx.Process(target=_nccl_teardown, args=(_free_port(), results), daemon=True)
    proc.start()
    try:
        got = results.get(timeout=TIMEOUT_S)
    except queue_mod.Empty:
        raise AssertionError("the NCCL world of one did not tear down") from None
    finally:
        proc.join(timeout=60)
        if proc.is_alive():
            proc.kill()
    assert not isinstance(got, str), got
    assert got == ([PINNED[("fib", 1024, 4)]] * 3, True, True)
    assert proc.exitcode == 0
