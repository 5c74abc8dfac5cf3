"""Prove on D ranks at once and hold every rank's proof to the single prove.

    python3 -m stark_tpu_torch.tools.dist_prove [--ranks D] [--backend nccl|gloo]
        [--model fib|mds] [--trace-length T] [--batch B] [--runs N] [--overlap K]
        [--host-path] [--three-reads] [--eager | --in-turn] [--time-collectives N]

Spawns D processes (torch.multiprocessing, ``spawn``), one rank each, in a
process group on localhost: with ``nccl`` rank d computes on ``cuda:d`` (D
cards), with ``gloo`` every rank on ``cuda:0`` (D ranks sharing one card;
gloo carries the exchanges through the host).  Each rank makes the model's
witness on its card and proves it with DistributedStarkProver (blowup 4,
16 tests, ``overlap`` the sharded NTT's chunks): warm-up proves (the slot's
first runs the body eagerly; where the body is a graph, NCCL, the second
captures it), then ``runs`` proves a turn, each with its phases timed
(utils/profiling.PhaseTimer, the card synchronized at the end of each) and
the device time of its body (CUDA events around the graph's replay, or
around the eager body), with the launch counts, the mesh's collectives and
the reads from the card (ops.gather.to_host calls) set to 0 just before a
turn's last prove and read just after it.  One turn on the default path
(on NCCL the graph), ``--eager`` one turn with the body run from Python
(StarkProver._eager), ``--in-turn`` four: graph, eager, eager, graph
(:attr:`World.forms`).
With ``--batch B``, then BatchStarkProver(mesh=) of B copies of the
witness in the same turns (D | B: the batch cut, each rank a
StarkProver's graph on its share; else the domain cut, the sharded
graph).  By default the single-fetch prove: K15 and K10 on every rank, the
query gather a rank's share of the rule plan and one sum over the ranks,
one read a prove.  ``--three-reads``: ``fused_round`` off (the trace
roots, the chain's fetch and the query gather with host indices).
``--host-path``: the FRI commit's host path (device_chain off: a root read
and a host challenge a round, K4 on the exchanged halves) in place of the
device chain.  Both run eagerly.  The parent proves the same witness on
one card first, builds every kernel library the ranks load, and exits 1
unless every rank's proofs equal that prove, every rank launched every
kernel of its world (:data:`KERNELS`, on the single-fetch path K15 and K10
exactly once a prove; on the host path K4 in place of K9 and K4-dyn), read
from the card once a prove on the single-fetch path and three times on
the three-read one, each sharded transform made its three all-to-alls of
n/D words, the body was captured at the slot's second prove exactly where
it should be (NCCL, the single-fetch path: parallel/pstark.graphs_allowed;
never on gloo), and a graph turn counted the launches and collectives of
an eager one.  It prints one JSON line a rank (per turn its walls and body
device times, per slot graph its capture time, the launches and
collectives inside it and the slot's memory) and a summary line.  Each
rank closes its provers (StarkProver.close: their graphs released) before
``destroy_process_group``.  ``--time-collectives N``: after the proves,
each kind of collective the sharded prove makes, called eagerly from
Python N times a kind on every rank at its size in the prove
(:func:`time_collectives`), and one eager prove's host time by torch
operator (:func:`host_ops`).
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import faulthandler
import hashlib
import json
import multiprocessing
import socket
import sys
import time
import traceback
from dataclasses import asdict, dataclass

import numpy as np
import torch

#: The kernels every rank of a sharded prove launches (K1-K3, K14, K5/K6,
#: K7, K8, K9, K4-dyn, K11, K13; on the single-fetch path K15 and K10).
KERNELS = ("ntt_pass1", "ntt_transpose", "ntt_pass2", "lde_pad_scale", "hash_rows",
           "merkle_level", "merkle_tail", "sponge_absorb", "fri_fold_dyn", "compose",
           "query_gather")
#: The device chain's kernels, and K4, which the host path runs in their place.
CHAIN_KERNELS, HOST_KERNELS = ("sponge_absorb", "fri_fold_dyn"), ("fri_fold",)
#: The single-fetch prove's own kernels (K15, K10): once a prove on every rank.
SINGLE_KERNELS = ("constraint_challenges", "sample_indices")
BLOWUP, TESTS = 4, 16
TIMEOUT_S = 600
#: The forms of the turns: in turn, and the one of ``--eager``.
IN_TURN, EAGER = ("graph", "eager", "eager", "graph"), ("eager",)


@dataclass(frozen=True)
class World:
    """D ranks proving one model's witness of ``trace_length``; ``want``:
    the sha256 every proof must have (the single-device prove's)."""

    ranks: int
    backend: str
    model: str
    trace_length: int
    want: str
    batch: int = 0
    runs: int = 1
    host_path: bool = False
    three_reads: bool = False
    #: Each turn's form: ``graph`` (the default path, the graph where the
    #: mesh allows it) or ``eager`` (StarkProver._eager).
    forms: tuple = ("graph",)
    overlap: int = 1
    #: Calls a kind of :func:`time_collectives` (0: none).
    collective_calls: int = 0

    @property
    def name(self) -> str:
        return (f"{self.backend} {self.model} T=2^{self.trace_length.bit_length() - 1} "
                f"D={self.ranks}" + (f" B={self.batch}" if self.batch else "")
                + (" host path" if self.host_path else "")
                + (" three reads" if self.three_reads else "")
                + (f" overlap {self.overlap}" if self.overlap != 1 else "")
                + ("" if self.forms == ("graph",) else f" {'/'.join(self.forms)}"))

    @property
    def single_fetch(self) -> bool:
        return not (self.host_path or self.three_reads)

    def graphs(self, cut: bool = False) -> bool:
        """Whether a graph turn replays a captured body: the sharded prove's
        on NCCL (parallel/pstark.graphs_allowed) on the single-fetch path;
        a cut batch's ranks run StarkProver, whose body is a graph on any
        backend."""
        return (cut or self.backend == "nccl") and self.single_fetch \
            and "graph" in self.forms

    @property
    def kernels(self) -> tuple:
        """The kernels each rank of this world launches."""
        if self.host_path:
            return tuple(k for k in KERNELS if k not in CHAIN_KERNELS) + HOST_KERNELS
        return KERNELS + (SINGLE_KERNELS if self.single_fetch else ())


def _witness(model: str, length: int, device):
    from stark_tpu_torch.models.examples import mds_square_trace_cols_device
    from stark_tpu_torch.models.fibonacci import fibonacci_trace_cols_device

    if model == "fib":
        return fibonacci_trace_cols_device(length, device=device)
    if model == "mds":
        return mds_square_trace_cols_device(length, device=device)
    raise ValueError(f"no device witness for {model!r}")


def _config(length: int):
    from stark_tpu_torch import StarkConfig

    return StarkConfig(trace_length=length, blowup=BLOWUP, num_colinearity_tests=TESTS)


def single_proof(model: str, length: int, device="cuda:0") -> bytes:
    """The single-device prove of the model's witness (every library the
    ranks load is built by it, or by :func:`build`)."""
    from stark_tpu_torch import StarkProver
    from stark_tpu_torch.models import get_model

    air = get_model(model)[0]
    prover = StarkProver(air, _config(length), device=device)
    return prover.prove(trace_cols=_witness(model, length, prover.device))


def _timed(fn, pairs: list):
    """``fn`` with CUDA events recorded around each call (into ``pairs``),
    but for calls made while a graph is being captured."""
    def run(*args, **kwargs):
        if torch.cuda.is_current_stream_capturing():
            return fn(*args, **kwargs)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*args, **kwargs)
        end.record()
        pairs.append((start, end))
        return out
    return run


def _graph_of(single, b: int, mesh) -> dict | None:
    """The graph of ``single``'s first slot of B proofs, as a record (None
    before its capture): its capture's host time, the launches and the
    collectives inside it, the slot's memory."""
    slots = single._slots.get(b, [])
    graph = slots[0].graph if slots else None
    if graph is None:
        return None
    log = [entry for ledger, held in graph.held if ledger is mesh for entry in held]
    return {"capture_s": graph.seconds, "launches": dict(graph.launches),
            "collectives": dict(collections.Counter(op for op, _ in log)),
            "log": log, "slot_bytes": slots[0].nbytes()}


def _turns(w: World, single, prove, b: int, mesh, device, reads: list, pairs: list) -> dict:
    """Warm-up calls of ``prove(timer)`` (B proofs on ``single``'s slots),
    the second only where a turn is to replay a graph, then ``w.runs``
    calls a turn in ``w.forms``, each synchronised and timed, the counts
    set to 0 before a turn's last call and read after it.  ``pairs``
    collects the CUDA events around each replay and each eager body.
    Returns the turns (the last one's shas, counts, collectives, log,
    reads, walls and phases also at the top; the top's shas every turn's),
    the call at which the slot's graph was captured (1-based, None if
    never) and the graph's record (:func:`_graph_of`)."""
    from stark_tpu_torch.ops import cuda
    from stark_tpu_torch.utils.profiling import PhaseTimer

    single._body = _timed(single._body, pairs)
    sync = lambda: torch.cuda.synchronize(device)  # noqa: E731
    calls, captured_at = 0, None

    def call(timer):
        nonlocal calls, captured_at
        proofs = prove(timer)
        calls += 1
        if captured_at is None and _graph_of(single, b, mesh) is not None:
            captured_at = calls
        return proofs

    for _ in range(2 if "graph" in w.forms else 1):
        call(None)
    turns = []
    for form in w.forms:
        walls, shas, phases = [], [], []
        pairs.clear()
        with single._eager() if form == "eager" else contextlib.nullcontext():
            for run in range(w.runs):
                sync()
                mesh.barrier()
                if run == w.runs - 1:
                    mesh.reset_counts()
                    cuda.reset_launches()
                    reads.clear()
                timer = PhaseTimer(sync=sync)
                t0 = time.perf_counter()
                proofs = call(timer)
                sync()
                walls.append(time.perf_counter() - t0)
                shas += [hashlib.sha256(p).hexdigest() for p in proofs]
                phases.append(timer.ms())
        turns.append({"form": form, "shas": shas, "counts": cuda.launch_counts(),
                      "collectives": dict(mesh.counts), "log": list(mesh.log),
                      "reads": len(reads), "wall_s": walls, "phases_ms": phases,
                      "body_ms": [a.elapsed_time(z) for a, z in pairs]})
    last = turns[-1]
    return {**{k: last[k] for k in ("counts", "collectives", "log", "reads", "wall_s",
                                    "phases_ms")}, "proof": proofs[0],
            "shas": [sha for turn in turns for sha in turn["shas"]], "turns": turns,
            "captured_at": captured_at, "graph": _graph_of(single, b, mesh),
            "device": str(device)}


def _rank(world: dict, rank: int, port: int, results) -> None:
    """One rank (a spawned process): puts (world name, rank, results) or
    the traceback on ``results``.  A rank still running near the parent's
    time limit prints every thread's stack."""
    w = World(**world)
    faulthandler.dump_traceback_later(TIMEOUT_S - 60)
    try:
        from stark_tpu_torch.parallel import initialize_distributed, make_mesh

        device = torch.device("cuda", rank if w.backend == "nccl" else 0)
        torch.cuda.set_device(device)
        initialize_distributed(f"127.0.0.1:{port}", w.ranks, rank, backend=w.backend)
        mesh = make_mesh(device=device)
        out = _prove(w, rank, mesh, device)
        if w.collective_calls:
            out["collectives_us"] = time_collectives(mesh, out["log"], w.collective_calls)
        torch.cuda.synchronize(device)
        mesh.barrier()
        torch.distributed.destroy_process_group()
        results.put((w.name, rank, out))
    except Exception:  # the parent raises it
        results.put((w.name, rank, traceback.format_exc()))


def _prove(w: World, rank: int, mesh, device) -> dict:
    """A rank's proves of the world (:func:`_turns`; with ``w.batch``, the
    batch's too), its provers closed on return (NCCL's teardown waits for
    every CUDA graph that holds its operations)."""
    from stark_tpu_torch import BatchStarkProver
    from stark_tpu_torch.models import get_model
    from stark_tpu_torch.ops import cuda
    from stark_tpu_torch.ops import gather as G
    from stark_tpu_torch.parallel import DistributedStarkProver

    # Every read from the card goes through ops.gather.to_host: count them.
    reads, to_host = [], G.to_host
    G.to_host = lambda t, **kw: reads.append(1) or to_host(t, **kw)
    # The device time of each replay and each eager body (CUDA events).
    pairs: list = []
    cuda.Graph.replay = _timed(cuda.Graph.replay, pairs)
    air = get_model(w.model)[0]
    prover = DistributedStarkProver(air, _config(w.trace_length), mesh, overlap=w.overlap)
    prover.fri.device_chain = not w.host_path
    prover.fri.fused_round = not w.three_reads
    witness = lambda: _witness(w.model, w.trace_length, device)  # noqa: E731

    def timer_kw(timer) -> dict:
        return {} if timer is None else {"timer": timer}

    with contextlib.closing(prover):
        out = _turns(w, prover, lambda t: [prover.prove(trace_cols=witness(), **timer_kw(t))],
                     1, mesh, device, reads, pairs)
        if w.collective_calls:
            out["host_ops"] = host_ops(lambda: prover.prove(trace_cols=witness()), prover)
    out["graphs_allowed"] = prover._graphs
    if w.batch:
        batch = BatchStarkProver(air, _config(w.trace_length), w.batch, mesh=mesh)
        cols = [witness()] * w.batch
        with contextlib.closing(batch):
            out["batch"] = _turns(
                w, batch._single, lambda t: batch.prove_batch(traces_cols=cols, **timer_kw(t)),
                w.batch // w.ranks if batch._cut else w.batch, mesh, device, reads, pairs)
        out["batch"]["cut"] = batch._cut
        del out["batch"]["proof"]
    if rank != 0:
        out["proof"] = None
    return out


def host_ops(prove, single, top: int = 12) -> dict:
    """One prove with its body run eagerly (StarkProver._eager) under
    torch.profiler's CPU activity: its wall, the host's self time summed
    over every torch operator (``ops_ms``) and the ``top`` operators by self
    time ([name, calls, ms]).  The hand kernels' launches (ctypes calls)
    and the port's own Python are no operators: they are the wall less
    ``ops_ms``."""
    from torch.profiler import ProfilerActivity, profile

    with single._eager(), profile(activities=[ProfilerActivity.CPU]) as prof:
        t0 = time.perf_counter()
        prove()
        wall = time.perf_counter() - t0
    rows = sorted(prof.key_averages(), key=lambda e: e.self_cpu_time_total, reverse=True)
    return {"wall_ms": wall * 1e3,
            "ops_ms": sum(e.self_cpu_time_total for e in rows) / 1e3,
            "ops": [[e.key, e.count, e.self_cpu_time_total / 1e3] for e in rows[:top]]}


def time_collectives(mesh, log: list, calls: int) -> dict:
    """Each kind of collective in ``log`` (the mesh's log of a prove),
    called eagerly from Python ``calls`` times on every rank at the largest
    size the prove gave it (an exchange with even splits), after three
    untimed calls: {kind: {"words", "host_us": the median host time to
    issue one call, "synced_us": the median of a call and a synchronise,
    "device_us": the median device time between CUDA events around a
    call}}; "torch_op" is one in-place add on the card for scale.  Every
    rank calls the same kinds at the same sizes."""
    device = mesh.device
    words = {}
    for op, n in log:
        words[op] = max(words.get(op, 0), n)
    # The sizes agreed over the ranks (an exchange's differs by rank).
    kinds = sorted(words)
    agreed = torch.tensor([words[k] for k in kinds], dtype=torch.int64, device=device)
    sizes = mesh.all_gather(agreed).amax(0).tolist()
    d = mesh.size
    ops = {}
    for kind, n in zip(kinds, sizes):
        n = -(-n // d) * d
        x = torch.zeros(n, dtype=torch.int32, device=device)
        ops[kind] = {"all_to_all": lambda x=x: mesh.all_to_all(x),
                     "exchange": lambda x=x, n=n: mesh.exchange(x, [n // d] * d, [n // d] * d),
                     "all_gather": lambda x=x: mesh.all_gather(x),
                     "all_reduce": lambda x=x: mesh.all_reduce(x)}[kind], n
    x = torch.zeros(1, dtype=torch.int32, device=device)
    ops["torch_op"] = (lambda: x.add_(1)), 1
    out = {}
    for kind, (fn, n) in ops.items():
        for _ in range(3):
            fn()
        torch.cuda.synchronize(device)
        mesh.barrier()
        host, synced, events = [], [], []
        for _ in range(calls):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            fn()
            end.record()
            t1 = time.perf_counter()
            torch.cuda.synchronize(device)
            host.append(t1 - t0)
            synced.append(time.perf_counter() - t0)
            events.append((start, end))
        out[kind] = {"words": n, "host_us": float(np.median(host)) * 1e6,
                     "synced_us": float(np.median(synced)) * 1e6,
                     "device_us": float(np.median([a.elapsed_time(z) for a, z in events])) * 1e3}
    mesh.reset_counts()
    return out


def _port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def build(models) -> None:
    """Build the port's library and each model's K11 library here, once,
    before the ranks start (D ranks would otherwise compile them at once)."""
    from stark_tpu_torch.models import get_model
    from stark_tpu_torch.ops import compose as CO
    from stark_tpu_torch.ops import cuda
    from stark_tpu_torch.stark import _Domain

    cuda.library()
    for model, length in models:
        air = get_model(model)[0]
        CO.library(CO.ComposeProgram(air, _Domain(_config(length), air).boundary).source)


def run(worlds: list[World]) -> dict[str, list[dict]]:
    """Every world's ranks at once; {world name: [rank 0's results, ...]}.
    Raises with the rank's traceback if one fails, or after TIMEOUT_S."""
    build({(w.model, w.trace_length) for w in worlds})
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    procs = []
    for w in worlds:
        port = _port()
        procs += [ctx.Process(target=_rank, args=(asdict(w), rank, port, results), daemon=True)
                  for rank in range(w.ranks)]
    for proc in procs:
        proc.start()
    got: dict = {w.name: [None] * w.ranks for w in worlds}
    try:
        for _ in procs:
            name, rank, out = results.get(timeout=TIMEOUT_S)
            if isinstance(out, str):
                raise RuntimeError(f"{name}: rank {rank} failed:\n{out}")
            got[name][rank] = out
    finally:
        for proc in procs:
            proc.join(timeout=60)
            if proc.is_alive():
                proc.kill()
    return got


def _all_to_alls(world: World, rows: int, length: int) -> list[int]:
    """A rank's all-to-alls (their words) of one sharded transform of
    ``rows`` rows of ``length`` points: three, each cut into the
    ``overlap`` chunks parallel/pntt.py takes."""
    from stark_tpu_torch.parallel.pntt import _split

    r, c = (x // world.ranks for x in _split(length))
    k = max(1, min(world.overlap, r, c))
    return [rows * length // world.ranks // k] * (3 * k)


def check(world: World, ranks: list[dict]) -> None:
    """Raises unless every rank's proofs equal ``world.want``, every turn of
    every rank launched every kernel of ``world.kernels`` (K7 where a share
    of the trace LDE is wider than hash_batch.TAIL_CUTOVER: narrower trees
    are K8's alone), on the single-fetch path K15 and K10 exactly once and
    read from the card once with one combine of the query gather (three
    reads with ``three_reads``), and the prove's all-to-alls were three of
    c T/D words (the trace's iNTT), then three of c N/D (its LDE), each cut
    into ``overlap`` chunks where the transform allows; a batch
    read once; the body was captured at the slot's second call where
    :meth:`World.graphs` says (and never elsewhere: gloo's sharded body runs
    eagerly); and every turn counted the launches and the collectives of
    the first (a graph's replay those of the eager body)."""
    from stark_tpu_torch.models import get_model
    from stark_tpu_torch.ops import hash_batch as HB

    c = get_model(world.model)[0].num_registers
    t, n = world.trace_length // world.ranks, BLOWUP * world.trace_length // world.ranks
    kernels = [k for k in world.kernels if k != "merkle_level" or n > HB.TAIL_CUTOVER]
    a2a_want = (_all_to_alls(world, c, world.trace_length)
                + _all_to_alls(world, c, BLOWUP * world.trace_length))
    single = world.single_fetch
    for rank, out in enumerate(ranks):
        where = f"{world.name} rank {rank}"
        shas = out["shas"] + out.get("batch", {}).get("shas", [])
        if any(sha != world.want for sha in shas):
            raise AssertionError(f"{where}: proofs {shas} != {world.want}")
        for turn in out["turns"]:
            missing = [k for k in kernels if turn["counts"][k] == 0]
            if missing:
                raise AssertionError(f"{where}: kernels not launched: {missing}")
            got = ([turn["counts"][k] for k in SINGLE_KERNELS], turn["reads"],
                   turn["collectives"].get("all_reduce", 0))
            want = ([int(single)] * 2, 1 if single else 3, int(single))
            if not world.host_path and got != want:
                raise AssertionError(f"{where}: K15, K10 launches, reads and combines "
                                     f"{got}, not {want}")
            a2a = [words for op, words in turn["log"] if op == "all_to_all"]
            if a2a != a2a_want:
                raise AssertionError(f"{where}: all-to-alls of {a2a} words, not {a2a_want}")
        records = [("prove", out, world.graphs())]
        if world.batch:
            if any(turn["reads"] != 1 for turn in out["batch"]["turns"]):
                raise AssertionError(f"{where}: reads a batch "
                                     f"{[turn['reads'] for turn in out['batch']['turns']]}")
            records.append(("batch", out["batch"], world.graphs(out["batch"]["cut"])))
        for what, rec, graphs in records:
            if (rec["captured_at"], rec["graph"] is not None) != ((2, True) if graphs
                                                                  else (None, False)):
                raise AssertionError(f"{where}: the {what}'s body captured at call "
                                     f"{rec['captured_at']}, graphs {'on' if graphs else 'off'}")
            first = rec["turns"][0]
            for turn in rec["turns"][1:]:
                for key in ("counts", "collectives", "log"):
                    if turn[key] != first[key]:
                        raise AssertionError(f"{where}: the {what}'s {turn['form']} turn "
                                             f"counted {key} {turn[key]}, the "
                                             f"{first['form']} turn {first[key]}")


def summary(world: World, ranks: list[dict]) -> str:
    """Per turn, the median wall (s) and body device time (ms) by rank; per
    rank, where its graph was captured and what it holds."""
    def turns(rec):
        return [{"form": turn["form"],
                 "wall_s": [float(np.median(o["turns"][i]["wall_s"])) for o in rec],
                 "body_ms": [float(np.median(o["turns"][i]["body_ms"]))
                             if o["turns"][i]["body_ms"] else None for o in rec]}
                for i, turn in enumerate(rec[0]["turns"])]

    def graphs(rec):
        return [None if o["graph"] is None else
                {"captured_at": o["captured_at"], "capture_s": o["graph"]["capture_s"],
                 "launches": sum(o["graph"]["launches"].values()),
                 "collectives": o["graph"]["collectives"], **o["graph"]["slot_bytes"]}
                for o in rec]

    line = {"turns": turns(ranks), "graphs": graphs(ranks)}
    if world.collective_calls:
        line["collectives_us"] = [o["collectives_us"] for o in ranks]
        line["host_ops"] = [o["host_ops"] for o in ranks]
    if world.batch:
        batch = [o["batch"] for o in ranks]
        line["batch"] = {"cut": batch[0]["cut"], "turns": turns(batch),
                         "graphs": graphs(batch)}
    return json.dumps(line)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--ranks", type=int, default=2)
    parser.add_argument("--backend", choices=("nccl", "gloo"), default="nccl")
    parser.add_argument("--model", choices=("fib", "mds"), default="fib")
    parser.add_argument("--trace-length", type=int, default=1 << 20)
    parser.add_argument("--batch", type=int, default=0)
    parser.add_argument("--runs", type=int, default=1)
    parser.add_argument("--overlap", type=int, default=1)
    parser.add_argument("--host-path", action="store_true")
    parser.add_argument("--three-reads", action="store_true")
    form = parser.add_mutually_exclusive_group()
    form.add_argument("--eager", dest="forms", action="store_const", const=EAGER,
                      default=("graph",))
    form.add_argument("--in-turn", dest="forms", action="store_const", const=IN_TURN)
    parser.add_argument("--time-collectives", type=int, default=0, metavar="N")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("dist_prove: no CUDA device visible", file=sys.stderr)
        return 2
    cards = torch.cuda.device_count()
    if args.backend == "nccl" and cards < args.ranks:
        print(f"dist_prove: nccl puts a rank on a card: {args.ranks} ranks, {cards} cards "
              "(--backend gloo shares one)", file=sys.stderr)
        return 2
    want = hashlib.sha256(single_proof(args.model, args.trace_length)).hexdigest()
    torch.cuda.empty_cache()
    world = World(args.ranks, args.backend, args.model, args.trace_length, want,
                  args.batch, args.runs, args.host_path, args.three_reads, args.forms,
                  args.overlap, args.time_collectives)
    ranks = run([world])[world.name]
    for rank, out in enumerate(ranks):
        print(json.dumps({"rank": rank, **{k: v for k, v in out.items() if k != "proof"}}))
    check(world, ranks)
    print(f"{world.name} on {cards} x {torch.cuda.get_device_name(0)}: every rank's proofs "
          f"== the single-device prove ({want[:16]}...); " + summary(world, ranks), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
