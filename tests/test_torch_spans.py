"""The port's spans (stark_tpu_torch.utils.profiling): named ranges of host
work on torch's profiler, in the same timeline as the card's events.

On the CPU: a Fibonacci prove at T=256 under ``torch.profiler`` records
every span of the single-fetch path's host work with its nesting, a
proof's spans carry its id, each PhaseTimer phase is a ``stark.<phase>``
span closed before the timer's synchronize, the proof's bytes do not
change, and with the profiler off nothing is recorded and no range is
made; a forced shortfall is one ``fri.second_read``; a collection is a
``python.gc`` span and a library build a ``cuda.build`` span.  On a card
(marker ``gpu``): the graph path's ``stark.dispatch`` and ``cuda.capture``.
"""

from __future__ import annotations

import gc
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from stark_tpu_torch import BatchStarkProver, StarkConfig, StarkProver
from stark_tpu_torch import fri as FRI
from stark_tpu_torch.models import get_model
from stark_tpu_torch.models import fibonacci as FIB
from stark_tpu_torch.models.examples import mds_square_trace_cols_device
from stark_tpu_torch.models.fibonacci import fibonacci_trace_cols_device
from stark_tpu_torch.utils import build
from stark_tpu_torch.utils import profiling as PR
from torch_port_support import cuda_device  # noqa: F401

T = 256
CFG = StarkConfig(trace_length=T, blowup=4, num_colinearity_tests=16)

#: Each span of the single-fetch prove's host work on the CPU, with the
#: span it opens inside (None: outside any of the program's spans).  The
#: graph path's ``stark.dispatch`` runs on a card only, ``fri.second_read``
#: where the sampler falls short, and ``witness.basis`` (inside
#: ``witness.upload``) at a length's first witness on a device.
PARENTS = {
    "witness.seeds": None, "witness.upload": None, "witness.expand": None,
    "stark.prove": None,
    "stark.lde": "stark.prove", "stark.statement": "stark.lde",
    "stark.trace_commit": "stark.prove",
    "stark.challenges": "stark.prove", "stark.compose": "stark.prove",
    "stark.fri_commit": "stark.prove", "stark.fri_sample": "stark.prove",
    "stark.fri_query": "stark.prove",
    "stark.fri_fetch": "stark.prove",
    "stark.fetch_wait": "stark.fri_fetch",
    "stark.fri_emit": "stark.prove",
    "stark.prefix_replay": "stark.fri_emit", "fri.chain_replay": "stark.fri_emit",
    "fri.sample_replay": "stark.fri_emit", "fri.round_emit": "stark.fri_emit",
    "stark.open_emit": "stark.fri_emit",
    "stream.serialize": "stark.prove",
}


def _program_spans(prof) -> list:
    """(name, parent's name) of the program's spans in a profile."""
    return [(e.name, e.cpu_parent.name if e.cpu_parent else None) for e in prof.events()
            if e.is_user_annotation and e.name.split(".")[0] in
            ("stark", "fri", "stream", "witness", "cuda", "python")]


@pytest.fixture
def ranges(monkeypatch):
    """Every record_function the spans open: (name, args)."""
    made = []
    real = torch.profiler.record_function

    def recording(name, args=None):
        made.append((name, args))
        return real(name, args)

    monkeypatch.setattr(torch.profiler, "record_function", recording)
    return made


def _prove(prover, device="cpu"):
    return prover.prove(trace_cols=fibonacci_trace_cols_device(T, device=device))


def test_a_prove_records_every_span_nested(ranges):
    prover = StarkProver(get_model("fib")[0], CFG, device="cpu")
    FIB._basis.cache_clear()  # the length's first witness: its basis made in the window
    PR.reset_spans()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _prove(prover)
    # a collection may come anywhere; the length's first witness makes its basis
    got = [(n, p) for n, p in _program_spans(prof) if n != "python.gc"]
    assert got.count(("witness.basis", "witness.upload")) == 1
    got.remove(("witness.basis", "witness.upload"))
    assert {name for name, _ in got} == set(PARENTS)
    for name, parent in got:
        assert parent == PARENTS[name], (name, parent)
    assert [n for n, _ in got].count("fri.round_emit") == prover.fri.num_rounds() - 1
    totals = PR.snapshot_spans()
    assert set(totals) - {"python.gc"} == set(PARENTS) | {"witness.basis"}
    assert all(seconds > 0 and count >= 1 for seconds, count in totals.values())


@pytest.mark.parametrize("b", [1, 3])
def test_the_in_place_fills_and_the_copy_are_spans(b):
    """The single-fetch path writes each proof in place: each FRI round's
    fill is a ``fri.round_emit``, the openings' a ``stark.open_emit``, each
    proof's one copy a ``stream.serialize``, as the paths and serialization
    metrics read them."""
    air, trace_fn, _ = get_model("fib")
    prover = BatchStarkProver(air, CFG, b, device="cpu")
    PR.reset_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        prover.prove_batch([trace_fn(T)] * b)
    totals = PR.snapshot_spans()
    for name, count in (("fri.round_emit", prover.fri.num_rounds() - 1),
                        ("stark.open_emit", 1), ("stream.serialize", b)):
        assert totals[name][1] == count and totals[name][0] > 0, name
    assert "stark.fetch_copy" not in totals


def test_a_proofs_spans_share_its_id(ranges):
    prover = StarkProver(get_model("fib")[0], CFG, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(2):
            _prove(prover)
    ids = []
    for name, args in ranges:
        if name == "stark.prove":
            ids.append(args)
        elif name == "python.gc":
            continue
        elif name.startswith("witness."):
            assert args == "0"
        else:
            assert args == ids[-1], (name, args, ids)
    assert len(ids) == 2 and ids[0] != ids[1] and "0" not in ids


@pytest.mark.parametrize("timed", [True, False])
def test_each_phase_is_a_span_closed_before_the_sync(timed):
    prover = StarkProver(get_model("fib")[0], CFG, device="cpu")
    wait = 0.005
    timer = PR.PhaseTimer(sync=lambda: time.sleep(wait)) if timed else PR.NULL_TIMER
    PR.reset_spans()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        prover.prove(trace_cols=fibonacci_trace_cols_device(T, device="cpu"), timer=timer)
    totals = PR.snapshot_spans()
    phases = {n for n, _ in _program_spans(prof) if n.startswith("stark.")}
    want = {"lde", "trace_commit", "challenges", "compose", "fri_commit", "fri_sample",
            "fri_query", "fri_fetch", "fri_emit"}
    assert {f"stark.{p}" for p in want} <= phases
    if timed:
        assert set(timer.phases) == want
        for p, seconds in timer.phases.items():
            span_s, count = totals[f"stark.{p}"]
            # the span is host work alone: each of its closes came before
            # the timer's synchronize
            assert span_s + count * wait <= seconds + 1e-6, (p, span_s, count, seconds)


def test_the_bytes_are_equal_with_the_profiler_on_and_off():
    prover = StarkProver(get_model("fib")[0], CFG, device="cpu")
    off = _prove(prover)
    with profile(activities=[ProfilerActivity.CPU]):
        on = _prove(prover)
    assert on == off == _prove(prover)


@pytest.mark.parametrize("model", ["fib", "mds"])
def test_off_the_spans_record_nothing_and_make_no_range(model, monkeypatch):
    def refused(*args, **kwargs):
        raise AssertionError("record_function made with the profiler off")

    monkeypatch.setattr(torch.profiler, "record_function", refused)
    PR.reset_spans()
    air, _, blowup = get_model(model)
    prover = StarkProver(air, StarkConfig(trace_length=64, blowup=blowup,
                                          num_colinearity_tests=4), device="cpu")
    witness = fibonacci_trace_cols_device if model == "fib" else mds_square_trace_cols_device
    timer = PR.PhaseTimer()
    for t in (PR.NULL_TIMER, timer):
        prover.prove(trace_cols=witness(64, device="cpu"), timer=t)
    gc.collect()
    assert PR.snapshot_spans() == {} and timer.phases
    assert PR.span("a") is PR.span("b") is PR.phase_span("c") is PR.proof_span()


def test_a_forced_shortfall_counts_one_second_read(monkeypatch):
    # One candidate a proof: every count falls short, and the host's
    # indices go through the query gather in a second read.
    air, trace_fn, _ = get_model("fib")
    want = BatchStarkProver(air, CFG, 2, device="cpu").prove_batch([trace_fn(T)] * 2)
    monkeypatch.setattr(FRI, "_SAMPLE_SLACK", 1 - 2 * CFG.num_colinearity_tests)
    prover = BatchStarkProver(air, CFG, 2, device="cpu")
    PR.reset_spans()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = prover.prove_batch([trace_fn(T)] * 2)
    assert got == want and prover.fri.shortfalls == 1
    assert PR.snapshot_spans()["fri.second_read"][1] == 1
    assert ("fri.second_read", "stark.fri_emit") in _program_spans(prof)


def test_a_collection_is_a_span():
    PR.reset_spans()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        gc.collect()
    gc.collect()
    assert PR.snapshot_spans()["python.gc"][1] >= 1
    assert any(e.name == "python.gc" for e in prof.events())
    PR.reset_spans()
    assert PR.snapshot_spans() == {}


def test_a_build_is_a_span(tmp_path, monkeypatch):
    src = tmp_path / "one.c"
    src.write_text("int one(void) { return 1; }\n")
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "_build"))
    PR.reset_spans()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        path = build.build_library("one", [str(src)], [], ["cc", "-shared", "-fPIC"])
        again = build.build_library("one", [str(src)], [], ["cc", "-shared", "-fPIC"])
    assert path == again
    # built once: the second call finds the library
    assert PR.snapshot_spans()["cuda.build"][1] == 1
    assert [e.name for e in prof.events()].count("cuda.build") == 1


# -- on a card ---------------------------------------------------------------------------


@pytest.mark.gpu
def test_card_spans_of_the_graph_path(cuda_device):
    prover = StarkProver(get_model("fib")[0], CFG, device=cuda_device)
    eager = _prove(prover, cuda_device)
    PR.reset_spans()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        # the slot's first graph prove captures it, the second replays
        got = [_prove(prover, cuda_device) for _ in range(2)]
    assert got == [eager] * 2
    spans = _program_spans(prof)
    assert spans.count(("stark.dispatch", "stark.prove")) == 2
    assert ("cuda.capture", "stark.dispatch") in spans
    # the eager body's phases show only inside the capture
    assert {n for n, _ in spans} >= set(PARENTS) | {"stark.dispatch"}
    totals = PR.snapshot_spans()
    assert totals["stark.prove"][1] == 2 and totals["cuda.capture"][1] == 1
    # a span is host work: no device activity is named after one
    device = {e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
              and not e.is_user_annotation}
    assert not {n for n in device if n.split(".")[0] in ("stark", "fri", "stream")}
    prover.close()
