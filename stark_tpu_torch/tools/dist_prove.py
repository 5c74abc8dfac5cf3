"""Prove on D ranks at once and hold every rank's proof to the single prove.

    python3 -m stark_tpu_torch.tools.dist_prove [--ranks D] [--backend nccl|gloo]
        [--model fib|mds] [--trace-length T] [--batch B] [--runs N] [--host-path]
        [--three-reads]

Spawns D processes (torch.multiprocessing, ``spawn``), one rank each, in a
process group on localhost: with ``nccl`` rank d computes on ``cuda:d`` (D
cards), with ``gloo`` every rank on ``cuda:0`` (D ranks sharing one card;
gloo carries the exchanges through the host).  Each rank makes the model's
witness on its card and proves it with DistributedStarkProver (blowup 4,
16 tests): a warm-up, then ``runs`` proves, each with its phases timed
(utils/profiling.PhaseTimer, the card synchronized at the end of each),
with the launch counts, the mesh's collectives and the reads from the card
(ops.gather.to_host calls) set to 0 just before the last and read just
after it; with ``--batch B``, then BatchStarkProver(mesh=) of B copies of
the witness.  By default the single-fetch prove: K15 and K10 on every
rank, the query gather a rank's share of the rule plan and one sum over
the ranks, one read a prove.  ``--three-reads``: ``fused_round`` off (the
trace roots, the chain's fetch and the query gather with host indices).
``--host-path``: the FRI commit's host path (device_chain off: a root read
and a host challenge a round, K4 on the exchanged halves) in place of the
device chain.  The parent proves the same witness on one card first,
builds every kernel library the ranks load, and exits 1 unless every
rank's proofs equal that prove, every rank launched every kernel of its
world (:data:`KERNELS`, on the single-fetch path K15 and K10 exactly once
a prove; on the host path K4 in place of K9 and K4-dyn), read from the
card once a prove on the single-fetch path and three times on the
three-read one, and each sharded transform made its three all-to-alls of
n/D words.  It prints one JSON line a rank and a summary line.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import multiprocessing
import socket
import sys
import time
import traceback
from dataclasses import asdict, dataclass

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

    @property
    def name(self) -> str:
        return (f"{self.backend} {self.model} T=2^{self.trace_length.bit_length() - 1} "
                f"D={self.ranks}" + (f" B={self.batch}" if self.batch else "")
                + (" host path" if self.host_path else "")
                + (" three reads" if self.three_reads else ""))

    @property
    def single_fetch(self) -> bool:
        return not (self.host_path or self.three_reads)

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


def _rank(world: dict, rank: int, port: int, results) -> None:
    """One rank (a spawned process): puts (world name, rank, results) or
    the traceback on ``results``."""
    w = World(**world)
    try:
        from stark_tpu_torch import BatchStarkProver
        from stark_tpu_torch.models import get_model
        from stark_tpu_torch.ops import cuda
        from stark_tpu_torch.ops import gather as G
        from stark_tpu_torch.parallel import (DistributedStarkProver,
                                              initialize_distributed, make_mesh)
        from stark_tpu_torch.utils.profiling import PhaseTimer

        # Every read from the card goes through ops.gather.to_host: count them.
        reads, to_host = [], G.to_host
        G.to_host = lambda t, **kw: reads.append(1) or to_host(t, **kw)

        device = torch.device("cuda", rank if w.backend == "nccl" else 0)
        torch.cuda.set_device(device)
        initialize_distributed(f"127.0.0.1:{port}", w.ranks, rank, backend=w.backend)
        mesh = make_mesh(device=device)
        air = get_model(w.model)[0]
        prover = DistributedStarkProver(air, _config(w.trace_length), mesh)
        prover.fri.device_chain = not w.host_path
        prover.fri.fused_round = not w.three_reads
        prover.prove(trace_cols=_witness(w.model, w.trace_length, device))  # warm-up
        walls, shas, phases = [], [], []
        for run in range(w.runs):
            torch.cuda.synchronize(device)
            mesh.barrier()
            if run == w.runs - 1:
                mesh.reset_counts()
                cuda.reset_launches()
                reads.clear()
            timer = PhaseTimer(sync=lambda: torch.cuda.synchronize(device))
            t0 = time.perf_counter()
            proof = prover.prove(trace_cols=_witness(w.model, w.trace_length, device),
                                 timer=timer)
            torch.cuda.synchronize(device)
            walls.append(time.perf_counter() - t0)
            shas.append(hashlib.sha256(proof).hexdigest())
            phases.append(timer.ms())
        out = {"shas": shas, "counts": cuda.launch_counts(), "collectives": dict(mesh.counts),
               "log": list(mesh.log), "reads": len(reads), "wall_s": walls,
               "phases_ms": phases, "device": str(device),
               "proof": proof if rank == 0 else None}
        if w.batch:
            batch = BatchStarkProver(air, _config(w.trace_length), w.batch, mesh=mesh)
            cols = [_witness(w.model, w.trace_length, device)] * w.batch
            batch.prove_batch(traces_cols=cols)  # warm-up
            torch.cuda.synchronize(device)
            mesh.barrier()
            cuda.reset_launches()
            reads.clear()
            t0 = time.perf_counter()
            proofs = batch.prove_batch(traces_cols=cols)
            torch.cuda.synchronize(device)
            out["batch"] = {"shas": [hashlib.sha256(p).hexdigest() for p in proofs],
                            "counts": cuda.launch_counts(), "reads": len(reads),
                            "wall_s": time.perf_counter() - t0}
        mesh.barrier()
        torch.distributed.destroy_process_group()
        results.put((w.name, rank, out))
    except Exception:  # the parent raises it
        results.put((w.name, rank, traceback.format_exc()))


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


def check(world: World, ranks: list[dict]) -> None:
    """Raises unless every rank's proofs equal ``world.want``, every rank
    launched every kernel of ``world.kernels`` (K7 where a share of the trace LDE is
    wider than hash_batch.TAIL_CUTOVER: narrower trees are K8's alone), on
    the single-fetch path K15 and K10 exactly once and read from the card
    once with one combine of the query gather (three reads with
    ``three_reads``), and the prove's all-to-alls were three of c T/D words
    (the trace's iNTT), then three of c N/D (its LDE)."""
    from stark_tpu_torch.models import get_model
    from stark_tpu_torch.ops import hash_batch as HB

    c = get_model(world.model)[0].num_registers
    t, n = world.trace_length // world.ranks, BLOWUP * world.trace_length // world.ranks
    kernels = [k for k in world.kernels if k != "merkle_level" or n > HB.TAIL_CUTOVER]
    for rank, out in enumerate(ranks):
        shas = out["shas"] + out.get("batch", {}).get("shas", [])
        if any(sha != world.want for sha in shas):
            raise AssertionError(f"{world.name} rank {rank}: proofs {shas} != {world.want}")
        missing = [k for k in kernels if out["counts"][k] == 0]
        if missing:
            raise AssertionError(f"{world.name} rank {rank}: kernels not launched: {missing}")
        single = world.single_fetch
        got = ([out["counts"][k] for k in SINGLE_KERNELS], out["reads"],
               out["collectives"].get("all_reduce", 0))
        want = ([int(single)] * 2, 1 if single else 3, int(single))
        if not world.host_path and got != want:
            raise AssertionError(f"{world.name} rank {rank}: K15, K10 launches, reads and "
                                 f"combines {got}, not {want}")
        if world.batch and out["batch"]["reads"] != 1:
            raise AssertionError(f"{world.name} rank {rank}: {out['batch']['reads']} reads "
                                 "a batch")
        a2a = [words for op, words in out["log"] if op == "all_to_all"]
        if a2a != [c * t] * 3 + [c * n] * 3:
            raise AssertionError(f"{world.name} rank {rank}: all-to-alls of {a2a} words, not "
                                 f"three of {c * t} then three of {c * n}")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--ranks", type=int, default=2)
    parser.add_argument("--backend", choices=("nccl", "gloo"), default="nccl")
    parser.add_argument("--model", choices=("fib", "mds"), default="fib")
    parser.add_argument("--trace-length", type=int, default=1 << 20)
    parser.add_argument("--batch", type=int, default=0)
    parser.add_argument("--runs", type=int, default=1)
    parser.add_argument("--host-path", action="store_true")
    parser.add_argument("--three-reads", action="store_true")
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
                  args.batch, args.runs, args.host_path, args.three_reads)
    ranks = run([world])[world.name]
    for rank, out in enumerate(ranks):
        print(json.dumps({"rank": rank, **{k: v for k, v in out.items() if k != "proof"}}))
    check(world, ranks)
    print(f"{world.name} on {cards} x {torch.cuda.get_device_name(0)}: every rank's proofs "
          f"== the single-device prove ({want[:16]}...); walls s by rank "
          + json.dumps([[round(x, 4) for x in out["wall_s"]] for out in ranks]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
