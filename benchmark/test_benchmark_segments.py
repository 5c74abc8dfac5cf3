"""The zkVM segments cell (``fib20.segments``): its configuration, traffic,
``pipelined`` driver and reference AIR found by name, a run on the CPU at
T=256 (a copy of the benchmark, ``tiny``) that reads ``correct`` over
distinct statements, the faults it has to catch, and the new metrics'
readers.

Sound, every sampled proof equals its own statement's reference proof;
handing out each batch's first proof for all of its statements, or the
control (one colinearity test fewer), reads as mismatched.  The readers of
the spans this cell added return None where the program recorded none
(a program whose statements are compiled into K11).
"""

from __future__ import annotations

import pytest

from benchmark import control
from benchmark import harness as H
from benchmark import run as RUN

CELL = "fib20.segments"
SEED = 2**31 + 2025
NEW = ("statement_ms.prove_ms", "stack_ms.prove_ms", "fetch_wait_ms.prove_ms",
       "builds.prove_ms")


def test_the_cell_finds_its_files():
    cell = H.load_cell(CELL)
    assert cell.config["air"] == "fib_segment" and cell.config["reduced"] == []
    assert cell.trace_length == cell.config["max_trace_length"] == 1 << 20
    assert cell.driver.run and cell.reference_air.PUBLIC[:2] == (1, 1)
    assert cell.traffic["batch"] == 4 and cell.traffic["depth"] == 2
    names = {m["name"] for m in cell.metrics(True)}
    assert set(NEW) <= names and "emit_ms.prove_ms" not in names
    assert {m["name"] for m in cell.metrics(False)} == {"prove_ms", "prove_ms_p95", "setup_s"}


def measure(tiny, trace=False):
    return RUN.measure(H.load_cell(CELL, *tiny), SEED, 0.5, trace, device="cpu", started=0.0)


@pytest.mark.parametrize("trace", [False, True])
def test_distinct_statements_read_correct(tiny, trace):
    out = measure(tiny, trace)
    checks = {k: v["value"] for k, v in out["checks"].items()}
    assert out["correct"], checks
    assert checks["compared_statements"] == H.REFERENCE_STATEMENTS
    assert checks["mismatched_proofs"] == 0 and out["failed"] == 0
    assert out["attempted"] >= 4 and out["attempted"] % 4 == 0
    if not trace:  # the CPU's traced runs record no spans (no profiler)
        assert {"prove_ms", "setup_s"} <= set(out["metrics"]) <= {
            "prove_ms", "prove_ms_p95", "setup_s"}


def test_a_batchs_first_proof_handed_out_for_all_fails(tiny, monkeypatch):
    from stark_tpu_torch.batch import BatchStarkProver

    finish = BatchStarkProver._finish_batch

    def first_for_all(self, *args):
        proofs = finish(self, *args)
        return [proofs[0]] * len(proofs)

    monkeypatch.setattr(BatchStarkProver, "_finish_batch", first_for_all)
    out = measure(tiny)
    checks = {k: v["value"] for k, v in out["checks"].items()}
    assert not out["correct"]
    assert checks["compared_statements"] == H.REFERENCE_STATEMENTS
    # every compared proof but those that were their batch's first
    assert 0 < checks["mismatched_proofs"] < checks["compared_proofs"]


def test_the_control_fails_at_the_cells_statement(tiny):
    got = control.reading(H.load_cell(CELL, *tiny), 5, device="cpu")
    assert not got["holds"]
    assert got["checks"]["mismatched_proofs"]["value"] == H.SAMPLE


@pytest.mark.parametrize("name", NEW)
def test_the_new_readers_read_none_without_their_spans(name, monkeypatch):
    from benchmark.metrics import _spans

    rec = H.Record(traced_proofs=10)
    monkeypatch.setattr(_spans, "totals", lambda: None)
    mod = H.metric_module(name)
    monkeypatch.setattr(mod, "totals", lambda: None, raising=False)
    assert mod.read(rec, {"name": name}, {}) is None
    other = {"stark.dispatch": (0.5, 10)}
    monkeypatch.setattr(_spans, "totals", lambda: other)
    monkeypatch.setattr(mod, "totals", lambda: other, raising=False)
    got = mod.read(rec, {"name": name}, {})
    assert got is None if name != "builds.prove_ms" else got == 0
