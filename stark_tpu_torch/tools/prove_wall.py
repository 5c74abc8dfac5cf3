"""Prove wall times on one CUDA card, with Python's garbage collections
that fall inside each prove.

    python3 -m stark_tpu_torch.tools.prove_wall [--model fib|mds] [--log2-t N] [--runs N]
        [--phase-runs N] [--turn-runs N] [--batch B] [--device-witness]

Proves from host rows (``StarkProver.prove(rows)``, the entry every
version of the port has; with ``--device-witness``, from the columns
``fibonacci_trace_cols_device`` / ``mds_square_trace_cols_device`` make on
the card, each prove's witness made anew, as ``chip_smoke.py`` proves; with
``--batch`` B > 1, a call is
``BatchStarkProver.prove_batch`` of B copies of the rows, as
``chip_smoke.py``'s ``batch8`` cell proves them) ``--runs`` times after
two warm-up calls, each ending in ``torch.cuda.synchronize()``, and
records every collection through ``gc.callbacks``.  Prints one JSON
line: the card, the prove
wall-time quantiles, the collections of each generation in the runs and
inside a prove (count and ms), and every prove over twice the median with
the collections inside it; then each phase's synchronised time
(``utils.profiling.PhaseTimer``), the median of ``--phase-runs`` more
proves.  Then the prove's two forms on the same prover in turn (graph,
eager, eager, graph; ``--turn-runs`` synchronised calls a turn): the
CUDA graph a card prove replays (the default path) and its body launched
eagerly from Python (``StarkProver._eager``), each turn's median wall and
each form's phases.  To measure an earlier checkout of the port
with the same script, run it by path with that checkout's root first on
``PYTHONPATH``:

    PYTHONPATH=/path/to/checkout python3 stark_tpu_torch/tools/prove_wall.py
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import subprocess
import time

import numpy as np
import torch


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--model", default="fib", choices=("fib", "mds"))
    parser.add_argument("--log2-t", type=int, default=20)
    parser.add_argument("--runs", type=int, default=100)
    parser.add_argument("--phase-runs", type=int, default=5)
    parser.add_argument("--turn-runs", type=int, default=10)
    parser.add_argument("--batch", type=int, default=1)
    parser.add_argument("--device-witness", action="store_true")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("prove_wall: no CUDA device visible")

    import stark_tpu_torch
    from stark_tpu_torch import StarkConfig, StarkProver
    from stark_tpu_torch.models import get_model
    from stark_tpu_torch.utils.profiling import NULL_TIMER, PhaseTimer

    T = 1 << args.log2_t
    air, trace_fn, _ = get_model(args.model)
    cfg = StarkConfig(trace_length=T, blowup=4, num_colinearity_tests=16)
    rows = trace_fn(T)
    if args.batch > 1:
        from stark_tpu_torch import BatchStarkProver

        batch = BatchStarkProver(air, cfg, args.batch)
        single = batch._single

        def prove(timer=NULL_TIMER):
            batch.prove_batch([rows] * args.batch, timer=timer)
    elif args.device_witness:
        from stark_tpu_torch.models.examples import mds_square_trace_cols_device
        from stark_tpu_torch.models.fibonacci import fibonacci_trace_cols_device

        witness = {"fib": fibonacci_trace_cols_device,
                   "mds": mds_square_trace_cols_device}[args.model]
        single = StarkProver(air, cfg)

        def prove(timer=NULL_TIMER):
            single.prove(trace_cols=witness(T), timer=timer)
    else:
        single = StarkProver(air, cfg)

        def prove(timer=NULL_TIMER):
            single.prove(rows, timer=timer)

    for _ in range(2):
        prove()
    torch.cuda.synchronize()

    events: list[tuple[str, int, float]] = []

    def on_gc(phase, info):
        events.append((phase, info["generation"], time.perf_counter()))

    windows = []
    gc.callbacks.append(on_gc)
    try:
        for _ in range(args.runs):
            t0 = time.perf_counter()
            prove()
            torch.cuda.synchronize()
            windows.append((t0, time.perf_counter()))
    finally:
        gc.callbacks.remove(on_gc)

    starts = [(g, t) for phase, g, t in events if phase == "start"]
    stops = [t for phase, _, t in events if phase == "stop"]
    collections = [(g, a, b) for (g, a), b in zip(starts, stops)]
    walls = np.array([(b - a) * 1e3 for a, b in windows])
    median = float(np.median(walls))

    def inside(t0, t1):
        return [(g, (b - a) * 1e3) for g, a, b in collections if t0 <= a <= t1]

    by_gen = {}
    for g in (0, 1, 2):
        ms = [m for t0, t1 in windows for gg, m in inside(t0, t1) if gg == g]
        by_gen[f"gen{g}"] = {"in_runs": sum(1 for gg, _, _ in collections if gg == g),
                             "inside_proves": len(ms), "ms": round(sum(ms), 3),
                             "max_ms": round(max(ms), 3) if ms else 0.0}
    slow = [{"run": i, "ms": round(float(walls[i]), 3),
             "gc": [[g, round(m, 3)] for g, m in inside(*windows[i])]}
            for i in range(len(walls)) if walls[i] > 2 * median]
    def phase_medians(runs: int) -> dict:
        phases: dict[str, list[float]] = {}
        for _ in range(runs):
            timer = PhaseTimer(sync=torch.cuda.synchronize)
            prove(timer)
            for phase, ms in timer.ms().items():
                phases.setdefault(phase, []).append(ms)
        return {k: round(float(np.median(v)), 3) for k, v in phases.items()}

    phases = phase_medians(args.phase_runs)
    # An earlier checkout of the port has no eager form of the graph path.
    eager = getattr(single, "_eager", None)
    in_turn = eager_phases = None
    if eager is not None and args.turn_runs > 0:
        in_turn = []
        for form in ("graph", "eager", "eager", "graph"):
            with eager() if form == "eager" else contextlib.nullcontext():
                turn = []
                for _ in range(args.turn_runs):
                    t0 = time.perf_counter()
                    prove()
                    torch.cuda.synchronize()
                    turn.append((time.perf_counter() - t0) * 1e3)
            in_turn.append([form, round(float(np.median(turn)), 3)])
        with eager():
            eager_phases = phase_medians(args.phase_runs)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    q = np.quantile(walls, [0, 0.25, 0.5, 0.75, 0.95, 1])
    print(json.dumps({
        "card": smi, "package": stark_tpu_torch.__file__, "model": args.model,
        "T": T, "batch": args.batch, "device_witness": args.device_witness,
        "runs": args.runs,
        "prove_ms": dict(zip(("min", "q1", "median", "q3", "p95", "max"),
                             (round(float(v), 3) for v in q))),
        "proofs_per_s_median": round(args.batch * 1e3 / median, 2),
        "collections": by_gen, "over_twice_median": slow,
        "phase_ms_median": phases,
        "in_turn_median_ms": in_turn, "eager_phase_ms_median": eager_phases,
    }), flush=True)


if __name__ == "__main__":
    main()
