"""What every cell shares: finding its files by name, the sample of served
proofs, the traced window and its reduction, the metrics, the comparison
with the reference, and the result line.

A cell is one entry of ``workloads`` in BENCHMARK.json.  Its configuration
is ``configs/<config>.json``, its traffic ``traffic/<traffic>.json``, the
way it drives the program ``drivers/<traffic's driver>.py``; a metric
``<base>.<suffix>`` is read by ``metrics/<base>.py``; a kernel's least time
is computed by ``roofline/<kernel>.py``.  Nothing here names a cell, a
configuration or a metric: a later cell, mix, driver, metric or roofline
is a file and an entry.
"""

from __future__ import annotations

import bisect
import dataclasses
import hashlib
import importlib.util
import json
import os
import random
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: Top-level module names that may not be loaded when the result is printed.
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "stark_tpu")
#: Proofs of a run kept for the comparison, drawn from the seed over every
#: proof served in the window.
SAMPLE = 128
#: Distinct statements among a run's kept proofs that the reference proves
#: after the window, drawn from the seed; the kept proofs of the others are
#: not compared.  On an H100 the reference takes 3.6-4.4 s a statement at
#: T=2^20 (a zkVM segment): 6 keep it inside a 30 s window (PERF.md).
REFERENCE_STATEMENTS = 6
#: Proofs a driver makes before its window, so that every kernel is built
#: and every graph captured in set-up.
WARMUP_PROOFS = 4
#: The length of a ``--trace 1`` run's window: torch.profiler's records
#: grow with it, and a few hundred proofs read steady.
TRACED_SECONDS = 4.0


class CellError(RuntimeError):
    """A cell, or one of its files, is missing or malformed."""


def load_json(path: Path) -> dict:
    try:
        with open(path) as f:
            return json.load(f)
    except FileNotFoundError:
        raise CellError(f"missing file {path.relative_to(ROOT) if path.is_relative_to(ROOT) else path}")


def load_module(path: Path, name: str):
    """The module in ``path`` (a file of this folder, named after an entry)."""
    if not path.is_file():
        raise CellError(f"missing file {path.relative_to(ROOT) if path.is_relative_to(ROOT) else path}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    """A workload with its configuration and traffic, read from their files."""

    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list
    base: Path = HERE

    @property
    def driver(self):
        return load_module(self.base / "drivers" / f"{self.traffic['driver']}.py",
                           f"benchmark_driver_{self.traffic['driver']}")

    @property
    def reference_air(self):
        return load_module(self.base / "reference" / "airs" / f"{self.config['reference_air']}.py",
                           f"benchmark_air_{self.config['reference_air']}")

    @property
    def trace_length(self) -> int:
        return int(self.traffic["trace_length"])

    def metrics(self, trace: bool) -> list:
        """This cell's metrics: its end-to-end ones, or with ``trace`` its
        per-layer ones (those whose ``workloads`` name it, or have none)."""
        pool = self.per_layer if trace else self.end_to_end
        return [m for m in pool if self.name in m.get("workloads", [self.name])]


def load_cell(name: str, spec_path: Path | None = None, base: Path = HERE) -> Cell:
    """The cell ``name`` of BENCHMARK.json (``spec_path``), its files under
    ``base``; raises CellError naming what is missing."""
    spec = load_json(spec_path or ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise CellError(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    if w["config"] not in configs:
        raise CellError(f"workload {name} names config {w['config']!r}, which is not listed")
    config = load_json(spec_path.parent / configs[w["config"]]["file"] if spec_path
                       else ROOT / configs[w["config"]]["file"])
    traffic = load_json(base / "traffic" / f"{w['traffic']}.json")
    if traffic["trace_length"] > config["max_trace_length"]:
        raise CellError(f"{name}: T = {traffic['trace_length']} passes the configuration's "
                        f"{config['max_trace_length']}")
    cell = Cell(name, int(w["chips"]), config, traffic, spec["end_to_end"], spec["per_layer"],
                base)
    if config.get("chips", 1) != cell.chips:
        raise CellError(f"{name}: the workload asks {cell.chips} chips, its configuration "
                        f"{config.get('chips', 1)}")
    cell.driver  # noqa: B018 - fails here if the driver's file is missing
    cell.reference_air  # noqa: B018 - and here if the reference AIR's is
    for metric in cell.metrics(False) + cell.metrics(True):
        metric_module(metric["name"], base)
    return cell


def metric_module(name: str, base: Path = HERE):
    """The reader of metric ``name``: metrics/<name up to its first dot>.py."""
    stem = name.split(".")[0]
    return load_module(base / "metrics" / f"{stem}.py", f"benchmark_metric_{stem}")


class Sample:
    """A uniform sample of at most SAMPLE of the proofs a run serves
    (reservoir sampling, its draws from the seed), each kept with its
    statement: (public inputs, proof), None for the configuration's
    default statement."""

    def __init__(self, seed: int):
        self.rng = random.Random(seed)
        self.kept: list[tuple] = []
        self.seen = 0

    def offer(self, proof: bytes, public=None) -> None:
        """``proof`` served for the statement with the public inputs
        ``public`` (a flat sequence of integers; None: the default)."""
        item = (None if public is None else tuple(int(v) for v in public), proof)
        if len(self.kept) < SAMPLE:
            self.kept.append(item)
        else:
            j = self.rng.randrange(self.seen + 1)
            if j < SAMPLE:
                self.kept[j] = item
        self.seen += 1

    def fill(self, rec: "Record") -> None:
        """The kept proofs' sha256 and statements into ``rec``."""
        rec.proof_shas = [sha(proof) for _, proof in self.kept]
        rec.proof_publics = [public for public, _ in self.kept]


@dataclasses.dataclass
class Record:
    """What one run of a cell measured."""

    setup_s: float = 0.0
    attempted: int = 0
    failed: int = 0
    completed: int = 0
    window_s: float = 0.0
    latencies_s: list = dataclasses.field(default_factory=list)
    #: sha256 of each proof kept for the comparison
    proof_shas: list = dataclasses.field(default_factory=list)
    #: the public inputs of each kept proof's statement (a tuple; None: the
    #: configuration's default statement), one a sha
    proof_publics: list = dataclasses.field(default_factory=list)
    memory_peak_bytes: int = 0
    #: per-proof spans of the traced run: name -> seconds, one a proof
    spans: dict = dataclasses.field(default_factory=dict)
    #: seconds from the process's start at each step of set-up (stderr only)
    setup_marks: dict = dataclasses.field(default_factory=dict)
    #: the traced window of each card (Trace.summary())
    traces: list = dataclasses.field(default_factory=list)
    #: proofs in the traced window
    traced_proofs: int = 0
    #: calls that raised
    failures: int = 0


def sha(proof: bytes) -> str:
    return hashlib.sha256(proof).hexdigest()


# -- the traced window -----------------------------------------------------------------


class Trace:
    """torch.profiler over the traced window (CPU and CUDA activity): the
    union of device activity, each kernel's device seconds, and the idle
    gaps, each named by the innermost host event that covers it."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.prof = None
        self.t0 = self.t1 = None

    def __enter__(self):
        if self.enabled:
            import torch

            acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
            self.prof = torch.profiler.profile(activities=acts)
            self.prof.__enter__()
            self.span = torch.profiler.record_function("bench.window")
            self.span.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.enabled:
            import torch

            torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        if self.enabled:
            self.span.__exit__(*exc)
            self.prof.__exit__(*exc)
        return False

    def summary(self, top: int = 10) -> dict:
        """{busy_s, window_s, kernels: {name: s}, gaps: {host label: s}}."""
        import torch

        events = self.prof.profiler.kineto_results.events()
        dev, host, window = [], [], None
        for e in events:
            if e.is_user_annotation() or e.name().startswith("bench."):
                # a record_function's range: host spans, and on the device
                # a copy of the range, which is no device activity
                if e.device_type() != torch.autograd.DeviceType.CUDA:
                    if e.name() == "bench.window":
                        window = (e.start_ns(), e.end_ns())
                    else:
                        host.append((e.start_ns(), e.end_ns(), e.name()))
            elif e.device_type() == torch.autograd.DeviceType.CUDA:
                dev.append((e.start_ns(), e.end_ns(), e.name()))
            else:
                host.append((e.start_ns(), e.end_ns(), e.name()))
        if window is None:
            window = (min(s for s, _, _ in dev), max(z for _, z, _ in dev))
        lo, hi = window
        kernels: dict[str, float] = {}
        spans = []
        for s, z, name in dev:
            s, z = max(s, lo), min(z, hi)
            if z <= s:
                continue
            kernels[name] = kernels.get(name, 0.0) + (z - s) * 1e-9
            spans.append((s, z))
        spans.sort()
        busy, gaps, cur_s, cur_z = 0, [], None, None
        prev_end = lo
        for s, z in spans:
            if cur_z is None or s > cur_z:
                if cur_z is not None:
                    busy += cur_z - cur_s
                gaps.append((prev_end, s))
                cur_s, cur_z = s, z
            else:
                cur_z = max(cur_z, z)
            prev_end = cur_z
        if cur_z is not None:
            busy += cur_z - cur_s
        gaps.append((prev_end, hi))
        gaps = sorted(((z - s, s, z) for s, z in gaps if z > s), reverse=True)
        labels: dict[str, float] = {}
        host.sort()
        starts = [h[0] for h in host]
        for length, s, z in gaps:
            mid = (s + z) // 2
            label = "bench.window"
            # the latest-starting host event that still runs at the gap's
            # middle (looked for among the few thousand before it)
            j = bisect.bisect_right(starts, mid) - 1
            for j in range(j, max(-1, j - 4000), -1):
                if host[j][1] >= mid:
                    label = host[j][2]
                    break
            labels[label] = labels.get(label, 0.0) + length * 1e-9
        return {"busy_s": busy * 1e-9, "window_s": (hi - lo) * 1e-9,
                "kernels": dict(sorted(kernels.items(), key=lambda kv: -kv[1])),
                "gaps": dict(sorted(labels.items(), key=lambda kv: -kv[1])[:top])}


# -- the result --------------------------------------------------------------------------


def shape(cell: Cell, rounds: int) -> dict:
    """The sizes a roofline reads: T, N, c, the FRI's rounds, the tests, the
    frame's rows (c and the frame from the cell's reference AIR)."""
    T, air = cell.trace_length, cell.reference_air
    return {"T": T, "N": T * cell.config["blowup"], "c": air.REGISTERS, "rounds": rounds,
            "tests": cell.config["num_colinearity_tests"], "frame": len(air.FRAME_OFFSETS)}


def read_metrics(cell: Cell, rec: Record, trace: bool, context: dict) -> dict:
    out = {}
    for m in cell.metrics(trace):
        value = metric_module(m["name"], cell.base).read(rec, m, context)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def forbidden_loaded() -> list[str]:
    """Top-level names of loaded modules that the run may not hold, each
    compared whole (stark_tpu_torch is not stark_tpu)."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN_MODULES)


def statements(rec: Record, seed: int) -> list:
    """The statements the reference proves: the distinct ones among the
    kept proofs, at most REFERENCE_STATEMENTS of them, drawn from the seed."""
    distinct = sorted(set(rec.proof_publics), key=lambda p: (p is not None, p or ()))
    if len(distinct) > REFERENCE_STATEMENTS:
        distinct = random.Random(f"statements {seed}").sample(distinct, REFERENCE_STATEMENTS)
    return distinct


def reference_statement(cell: Cell, public=None, tests_less: int = 0):
    """The statement with the public inputs ``public`` (None: the default)
    at the cell's size, for the plain reference."""
    from benchmark.reference import prover as R

    return R.Statement(cell.reference_air, cell.trace_length, cell.config["blowup"],
                       cell.config["num_colinearity_tests"] - tests_less, public)


def reference_proofs(cell: Cell, publics: list, device, tests_less: int = 0) -> dict:
    """{public inputs: the plain reference's proof bytes} of each statement
    of ``publics``, proved one after the other on ``device``."""
    import torch

    from benchmark.reference import prover as R

    out = {}
    for public in publics:
        st = reference_statement(cell, public, tests_less)
        cols = torch.from_numpy(st.witness().astype("int64")).to(device)
        with torch.no_grad():
            out[public] = R.prove(st, cols)
        del cols
    return out


def judge(rec: Record, reference_shas: dict) -> dict:
    """The numbers compared, each beside its limit: every kept proof of a
    statement that the reference proved (``reference_shas``: public inputs
    -> the sha256 of its reference proof) against its own statement's."""
    compared = [(public, s) for public, s in zip(rec.proof_publics, rec.proof_shas, strict=True)
                if public in reference_shas]
    mismatched = sum(1 for public, s in compared if s != reference_shas[public])
    return {"mismatched_proofs": {"value": mismatched, "max": 0},
            "failed_proofs": {"value": rec.failed, "max": 0},
            "compared_proofs": {"value": len(compared), "min": 1},
            "compared_statements": {"value": len({public for public, _ in compared}), "min": 1}}


def holds(checks: dict) -> bool:
    return all(("max" not in c or c["value"] <= c["max"]) and
               ("min" not in c or c["value"] >= c["min"]) for c in checks.values())


def cache_dir() -> Path:
    """The benchmark's own cache, inside the checkout at a fixed path."""
    path = HERE / ".cache"
    path.mkdir(exist_ok=True)
    return path


def set_cache_env() -> None:
    """torch's extension and Triton caches inside the checkout, at fixed
    paths, should the program come to use them (its own nvcc builds go to
    stark_tpu_torch/_build/, inside the checkout too)."""
    base = cache_dir()
    os.environ["TORCH_EXTENSIONS_DIR"] = str(base / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(base / "triton")


def port_function(spec: str):
    """``module:function`` of the program, by name (a configuration's file
    names the program's witness this way)."""
    module, _, func = spec.partition(":")
    return getattr(importlib.import_module(module), func)


def stark_config(cell: Cell):
    from stark_tpu_torch import StarkConfig

    return StarkConfig(trace_length=cell.trace_length, blowup=cell.config["blowup"],
                       num_colinearity_tests=cell.config["num_colinearity_tests"])


def port_air(cell: Cell):
    from stark_tpu_torch.models import get_model

    return get_model(cell.config["air"])[0]


def release(device) -> None:
    """The program's state freed: a collection and the allocator's cache."""
    import gc

    import torch

    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


class ClosedLoop:
    """One proof of a closed loop: the witness, then ``prover.prove``; its
    latency into the record and its bytes offered to the sample, or, where
    it raises, one more failed proof.  Traced (``trace``): the witness's
    span, ended by a synchronize, and the emission's phases, from a
    synchronizing PhaseTimer."""

    def __init__(self, prover, witness, device, trace: bool):
        import torch

        self.prover, self.witness, self.trace = prover, witness, trace
        self.sync = ((lambda: torch.cuda.synchronize(device)) if device.type == "cuda"
                     else (lambda: None))
        self.spans = {"witness_s": [], "emit_s": []}

    def __call__(self, rec: Record, sample: Sample) -> None:
        import torch

        from stark_tpu_torch.utils.profiling import PhaseTimer

        t0 = time.perf_counter()
        rec.attempted += 1
        try:
            if self.trace:
                timer = PhaseTimer(sync=self.sync)
                with torch.profiler.record_function("bench.witness"):
                    cols = self.witness()
                    self.sync()
                witness_s = time.perf_counter() - t0
                with torch.profiler.record_function("bench.prove"):
                    proof = self.prover.prove(trace_cols=cols, timer=timer)
            else:
                proof = self.prover.prove(trace_cols=self.witness())
        except Exception as e:  # noqa: BLE001 - a failed proof is counted, not fatal
            note_failure(rec, e)
            return
        rec.latencies_s.append(time.perf_counter() - t0)
        sample.offer(proof)
        if self.trace:
            ph = timer.phases
            self.spans["witness_s"].append(witness_s)
            self.spans["emit_s"].append(ph.get("fri_fetch", 0.0) + ph.get("fri_emit", 0.0))


def note_failure(rec: Record, e: BaseException, proofs: int = 1) -> None:
    """``proofs`` more failed proofs; the first few failures' tracebacks on
    standard error."""
    rec.failed += proofs
    rec.failures += 1
    if rec.failures <= 3:
        import traceback

        print("benchmark: a proof failed:\n" + "".join(traceback.format_exception(e)),
              file=sys.stderr)
