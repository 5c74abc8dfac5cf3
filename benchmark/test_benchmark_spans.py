"""The readers of the program's spans (metrics/_spans.py and the metrics
that read it), on a record with the recorder's totals set: a proof's
milliseconds from the totals and the traced proofs, the second reads per
1000 proofs, and None where nothing was recorded, where no proof was
traced, or where the program has no recorder."""

from __future__ import annotations

import sys
import types

import pytest

from benchmark import harness as H
from stark_tpu_torch.utils import profiling as PR

TOTALS = {
    "stark.dispatch": (0.040, 20), "witness.seeds": (0.010, 20),
    "witness.upload": (0.002, 20), "witness.expand": (0.001, 20),
    "stark.prefix_replay": (0.003, 20), "fri.chain_replay": (0.005, 20),
    "fri.sample_replay": (0.002, 20), "fri.round_emit": (0.014, 280),
    "stark.open_emit": (0.006, 20), "stream.serialize": (0.008, 20),
    "fri.second_read": (0.001, 1), "stark.fetch_wait": (0.1, 20),
}
#: metric -> its value a proof over 20 traced proofs
WANT = {
    "dispatch_ms.prove_ms": 2.0, "witness_host_ms.prove_ms": 0.6,
    "replay_ms.prove_ms": 0.5, "paths_ms.prove_ms": 1.0, "serialize_ms.prove_ms": 0.4,
    "second_reads.prove_ms": 50.0,
}


def read(name, rec):
    return H.metric_module(name).read(rec, {"name": name}, {})


@pytest.fixture
def recorded(monkeypatch):
    monkeypatch.setattr(PR, "_TOTALS", {k: list(v) for k, v in TOTALS.items()})


@pytest.mark.parametrize("name", sorted(WANT))
def test_a_proofs_mean_from_the_totals(recorded, name):
    assert read(name, H.Record(traced_proofs=20)) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", sorted(WANT))
def test_nothing_recorded_reads_none(monkeypatch, name):
    monkeypatch.setattr(PR, "_TOTALS", {})
    assert read(name, H.Record(traced_proofs=20)) is None


@pytest.mark.parametrize("name", sorted(WANT))
def test_no_traced_proof_reads_none(recorded, name):
    assert read(name, H.Record()) is None


@pytest.mark.parametrize("name", sorted(WANT))
def test_a_program_without_the_recorder_reads_none(monkeypatch, name):
    bare = types.ModuleType("stark_tpu_torch.utils.profiling")
    monkeypatch.setitem(sys.modules, "stark_tpu_torch.utils.profiling", bare)
    assert read(name, H.Record(traced_proofs=20)) is None


def test_no_second_read_among_recorded_spans_reads_zero(monkeypatch):
    monkeypatch.setattr(PR, "_TOTALS", {"stark.dispatch": [0.04, 20]})
    assert read("second_reads.prove_ms", H.Record(traced_proofs=20)) == 0.0
    assert read("paths_ms.prove_ms", H.Record(traced_proofs=20)) is None
