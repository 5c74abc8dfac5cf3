"""BENCHMARK.json against the benchmark's contract, every file it names
found by name, a missing one named in the error, and a new configuration,
mix and metric added by files and entries alone."""

from __future__ import annotations

import json
import re
import statistics  # noqa: F401

import pytest

from benchmark import harness as H
from benchmark import run as RUN

SPEC = json.loads((H.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"] and 1 <= SPEC["run_seconds"] <= 51
    assert len(SPEC["command"]) <= 32 and all(len(w) <= 200 for w in SPEC["command"])
    assert len(json.dumps(SPEC)) <= 64 * 1024


def test_names_units_and_limits():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in SPEC[k]]
    for key in ("configs", "workloads"):
        got = [x["name"] for x in SPEC[key]]
        assert len(got) == len(set(got))
    metrics = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(metrics) == len(set(metrics))
    assert all(NAME.match(n) for n in names)
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
    for m in SPEC["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
    for x in SPEC["workloads"] + SPEC["configs"]:
        assert 1 <= len(x["why"]) <= 200 and "\n" not in x["why"] and "\t" not in x["why"]


def test_every_cell_reports_what_it_must():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    reports = {c: {m for m, v in e2e.items() if c in v.get("workloads", CELLS)} for c in CELLS}
    for c in CELLS:
        assert len(reports[c]) >= 2, c
        assert any(c in m.get("workloads", CELLS) for m in SPEC["per_layer"]), c
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        for c in m["workloads"]:
            assert m["moves"] in reports[c], (m["name"], c)
    layers = {}
    for m in SPEC["per_layer"]:
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def test_configs_and_chips():
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}
    for c in SPEC["configs"]:
        assert c["file"].startswith("benchmark/configs/")
        body = json.loads((H.ROOT / c["file"]).read_text())
        assert body["reduced"] == c["reduced"] and body["source"] == c["source"]
        assert not any(k.endswith(("_dim", "_rank")) for k in c["reduced"])
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in SPEC["workloads"])
    assert all(w["chips"] in (1, 4) for w in SPEC["workloads"])
    assert four <= max(1, len(CELLS) // 4)


def test_a_full_check_fits():
    runs = 2 + 14 * 24
    assert runs * (SPEC["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_finds_its_files(name):
    cell = H.load_cell(name)
    assert cell.driver.run and cell.reference_air.trace
    for m in cell.metrics(False) + cell.metrics(True):
        assert H.metric_module(m["name"]).read


@pytest.mark.parametrize("what", ["traffic/latency_t21.json", "drivers/single.py",
                                  "metrics/emit_ms.py", "configs/fibonacci.json",
                                  "reference/airs/fibonacci.py"])
def test_a_missing_file_is_named(tiny, what):
    spec, base = tiny
    (base / what).unlink()
    cells = [w["name"] for w in json.loads(spec.read_text())["workloads"]]
    with pytest.raises(H.CellError, match=re.escape(what.split("/")[-1])):
        for name in cells:
            H.load_cell(name, spec, base)


def test_an_unknown_cell_is_named(tiny):
    with pytest.raises(H.CellError, match="no workload 'nope'"):
        H.load_cell("nope", *tiny)


def test_a_new_config_mix_and_metric_are_files_and_entries(tiny):
    """A throwaway configuration (the two-register Fibonacci), a mix and a
    per-layer metric, each a new file and an entry: the harness runs the
    new cell and reports the new metric, with no file of it edited."""
    spec_path, base = tiny
    (base / "configs" / "fib2.json").write_text(json.dumps({
        "name": "fib2", "source": "https://github.com/0xSooki/stark-rs", "air": "fib2",
        "reference_air": "fib2", "max_trace_length": 1 << 21, "blowup": 4,
        "num_colinearity_tests": 16, "chips": 1,
        "device_witness": "benchmark.test_benchmark_spec:fib2_cols", "reduced": []}))
    (base / "reference" / "airs" / "fib2.py").write_text(
        "import numpy as np\nP = 998244353\nREGISTERS = 2\nFRAME_OFFSETS = (0, 1)\n"
        "CONSTRAINT_DEGREE = 1\nTRANSITIONS = 2\n"
        "def transition(f):\n    return [(f[1][0] - f[0][1]) % P, (f[1][1] - f[0][0] - f[0][1]) % P]\n"
        "def boundary(T):\n    return [(0, 0, 1), (0, 1, 1)]\n"
        "def trace(T):\n    out, a, b = [], 1, 1\n    for _ in range(T):\n"
        "        out.append((a, b)); a, b = b, (a + b) % P\n"
        "    return np.asarray(out, dtype=np.uint32).T.copy()\n")
    (base / "traffic" / "pairs.json").write_text(json.dumps({
        "driver": "single", "trace_length": 64}))
    (base / "metrics" / "kept_proofs.py").write_text(
        "def read(rec, metric, context):\n    return float(len(rec.proof_shas))\n")
    spec = json.loads(spec_path.read_text())
    spec["configs"].append({"name": "fib2", "source": "https://github.com/0xSooki/stark-rs",
                            "file": "benchmark/configs/fib2.json", "reduced": [],
                            "why": "two registers"})
    spec["workloads"].append({"name": "fib2.pairs", "config": "fib2", "traffic": "pairs",
                              "chips": 1, "why": "a throwaway cell"})
    for m in spec["end_to_end"]:
        if m["name"] == "prove_ms":
            m["workloads"].append("fib2.pairs")
    spec["per_layer"].append({"name": "kept_proofs.prove_ms", "unit": "proofs",
                              "better": "higher", "source": "program_counter",
                              "layer": "harness", "moves": "prove_ms",
                              "workloads": ["fib2.pairs"]})
    spec_path.write_text(json.dumps(spec))
    cell = H.load_cell("fib2.pairs", spec_path, base)
    out = RUN.measure(cell, 2**31 + 11, 0.3, True, device="cpu", started=0.0)
    assert out["correct"], out["checks"]
    assert out["metrics"]["kept_proofs.prove_ms"]["value"] >= 1
    assert set(out["metrics"]) == {"kept_proofs.prove_ms"}


def fib2_cols(length, device):
    import torch

    from stark_tpu_torch.models.examples import two_register_fibonacci_trace

    rows = two_register_fibonacci_trace(length)
    return torch.tensor(rows, dtype=torch.int32, device=device).T.contiguous()
