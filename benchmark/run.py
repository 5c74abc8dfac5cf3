"""Run one cell of the benchmark once and print its result line.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout: loads the cell's files (BENCHMARK.json,
configs/, traffic/, drivers/), sets up and warms up the program
(stark_tpu_torch) on the cell's cards, measures for ``--seconds`` (with
``--trace 1`` a shorter traced window, under torch.profiler), then frees
the program's state, proves with the plain reference (reference/: its own
AIR and witness walk) the statements of a sample of the served proofs
drawn from the seed (at most ``harness.REFERENCE_STATEMENTS``, drawn from
it too), and compares each sampled proof of those statements with its own
statement's reference proof byte for byte.  The last line of standard
output is one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``: each
number compared with its limit, also the last lines of standard error.
Exits 2 without the program or the cards the cell asks for, 3 if jax,
jaxlib, flax or stark_tpu is loaded once the window has closed, 1 on any
other failure; a failed run prints no result.
"""

from __future__ import annotations

import time

STARTED = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

from benchmark import harness as H  # noqa: E402


def measure(cell: H.Cell, seed: int, seconds: float, trace: bool, device="cuda",
            started: float | None = None) -> dict:
    """The cell's run and its comparison: the result line as a dict."""
    import torch

    from benchmark.reference import prover as R

    rec = cell.driver.run(cell, seed, seconds, trace, STARTED if started is None else started,
                          device=device)
    ref_device = torch.device(device, 0) if device == "cuda" else torch.device(device)
    t0 = time.time()
    reference = H.reference_proofs(cell, H.statements(rec, seed), ref_device)
    H.release(ref_device)
    reference_s = time.time() - t0
    checks = H.judge(rec, {public: H.sha(proof) for public, proof in reference.items()})
    st = H.reference_statement(cell)
    shape = H.shape(cell, R.Domain(st).fri_rounds(st.num_colinearity_tests))
    out = {"correct": H.holds(checks), "attempted": rec.attempted, "failed": rec.failed,
           "metrics": H.read_metrics(cell, rec, trace, {"shape": shape}),
           "device": {"platform": "gpu" if device == "cuda" else device,
                      "kind": torch.cuda.get_device_name(0) if device == "cuda" else device,
                      "count": cell.chips, "memory_peak_bytes": rec.memory_peak_bytes}}
    if trace and rec.traces:
        n = len(rec.traces)
        out["device"]["busy_s"] = sum(t["busy_s"] for t in rec.traces) / n
        out["device"]["window_s"] = sum(t["window_s"] for t in rec.traces) / n
        ops: dict = {}
        gaps: dict = {}
        for t in rec.traces:
            for k, s in t["kernels"].items():
                ops[k] = ops.get(k, 0.0) + s / n
            for k, s in t["gaps"].items():
                gaps[k] = gaps.get(k, 0.0) + s / n
        out["breakdown"] = {
            "device_ops": sorted(([k[:120], s] for k, s in ops.items()), key=lambda x: -x[1])[:10],
            "idle_gaps": sorted(([k[:120], s] for k, s in gaps.items()), key=lambda x: -x[1])[:10]}
    out["checks"] = checks
    out["_info"] = {"reference_s": reference_s, "statements": len(reference),
                    "window_s": rec.window_s,
                    "completed": rec.completed, "setup_s": rec.setup_s,
                    "setup_marks": rec.setup_marks}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m benchmark.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    H.set_cache_env()
    try:
        cell = H.load_cell(args.workload)
    except H.CellError as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    import importlib.util

    if importlib.util.find_spec("stark_tpu_torch") is None:
        print("benchmark: the program (stark_tpu_torch) is not in this checkout", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: {cell.name} needs {cell.chips} CUDA device(s), {have} visible",
              file=sys.stderr)
        return 2
    out = measure(cell, args.seed, args.seconds, bool(args.trace))
    info = out.pop("_info")
    loaded = H.forbidden_loaded()
    if loaded:
        print(f"benchmark: loaded once the window closed: {', '.join(loaded)}", file=sys.stderr)
        return 3
    print(f"benchmark: {cell.name} seed {args.seed}: {info['completed']} proofs in "
          f"{info['window_s']:.3f} s, set-up {info['setup_s']:.3f} s, reference "
          f"{info['reference_s']:.3f} s for {info['statements']} statement(s)", file=sys.stderr)
    marks = ", ".join(f"{k} {v:.3f}" for k, v in info["setup_marks"].items())
    print(f"benchmark: set-up steps (seconds from the start): {marks}", file=sys.stderr)
    for name, c in out["checks"].items():
        limit = f"<= {c['max']}" if "max" in c else f">= {c['min']}"
        print(f"check {name} {c['value']} {limit}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
