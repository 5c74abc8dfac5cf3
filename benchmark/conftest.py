"""Fixtures of the benchmark's own tests (run: python3 -m pytest benchmark).

``tiny``: a copy of the benchmark in a temporary directory, every traffic
mix at T=256, with a short warm-up and traced window, as a later change
would find it: files added there and entries added to its BENCHMARK.json
are what a new cell, mix, driver, metric or roofline takes."""

from __future__ import annotations

import json
import shutil

import pytest

from benchmark import harness as H

#: The least T at which the configuration's 64 colinearity tests leave the
#: FRI two rounds (N = 1024 folds to 256 = 4 * 64).
TINY_T = 256


def make_tiny(tmp_path, trace_length: int = TINY_T):
    base = tmp_path / "benchmark"
    shutil.copytree(H.HERE, base, ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    for path in (base / "traffic").glob("*.json"):
        t = json.loads(path.read_text())
        t.update(trace_length=trace_length)
        path.write_text(json.dumps(t))
    spec = json.loads((H.ROOT / "BENCHMARK.json").read_text())
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    return tmp_path / "BENCHMARK.json", base


@pytest.fixture
def tiny(tmp_path, monkeypatch):
    monkeypatch.setattr(H, "WARMUP_PROOFS", 2)
    monkeypatch.setattr(H, "TRACED_SECONDS", 0.5)
    return make_tiny(tmp_path)
