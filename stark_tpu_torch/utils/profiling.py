"""Spans on torch's profiler, per-phase timing, structured failure reasons.

* :func:`span` — a named range of host work.  While torch's profiler runs
  it is a ``torch.profiler.record_function`` range, in the same timeline
  as the card's CUPTI events (its ``args``: the id of the proof it belongs
  to, :func:`proof_span`), and its host seconds and a count are added to
  in-memory totals by name (:func:`snapshot_spans`, :func:`reset_spans`).
  Otherwise it is one check and nothing more: no range, no string, no
  clock.  An operator sees the spans by running ``prove`` under
  ``torch.profiler.profile`` and ``export_chrome_trace``; the benchmark's
  ``--trace 1`` runs read the totals.  Python's collections show as
  ``python.gc`` spans the same way (a ``gc.callbacks`` hook).
* :class:`PhaseTimer` — wall-clock per phase (lde / trace_commit /
  challenges / compose / fri_commit / fri_sample / fri_query, the trace
  openings inside it; dispatch / fri_fetch / fri_emit on the single-fetch
  path), accumulated into a dict.  ``StarkProver.prove`` and
  ``Fri.prove`` accept ``timer=``.  Phases measure HOST wall time; CUDA
  work is asynchronous, so pass ``sync=torch.cuda.synchronize`` to charge
  each phase with the device work it enqueued instead of the phase that
  happens to wait for it.  The library default is :data:`NULL_TIMER`
  (no accumulation, no synchronisation).  Each phase, of either timer, is
  the span ``stark.<phase>``, closed before the timer's synchronize.
* :func:`reason` — the verifier's failure taxonomy: prints the same
  human-readable reasons the reference prints (fri.rs:331-494) AND records
  a machine-readable (code, message) trail in ``LAST_REASONS`` for tests
  and callers.
"""

from __future__ import annotations

import gc
import itertools
import time
from contextlib import contextmanager

import torch

LAST_REASONS: list[tuple[str, str]] = []

_MAX_REASONS = 256


def reason(code: str, message: str) -> None:
    """Record + print a verification failure reason (reference prints only).
    The trail is bounded so long-lived verifier processes cannot leak."""
    if len(LAST_REASONS) >= _MAX_REASONS:
        del LAST_REASONS[: _MAX_REASONS // 2]
    LAST_REASONS.append((code, message))
    print(message)


# -- spans -------------------------------------------------------------------------

_profiling = torch._C._autograd._profiler_enabled

#: name -> [host seconds, count] of the spans closed while the profiler ran.
_TOTALS: dict[str, list] = {}
_proof_ids = itertools.count(1)
#: The id of the proof whose spans open now (0: none).
_proof = 0


class _Off:
    """A span while the profiler is off: enters and leaves, nothing else."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, exc_type, exc, tb):
        return False


_OFF = _Off()


class _On:
    """A span while the profiler runs: a ``record_function`` range whose
    args are the proof's id, and its host seconds added to the totals."""

    __slots__ = ("name", "range", "t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.range = torch.profiler.record_function(self.name, str(_proof))
        self.range.__enter__()
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        seconds = time.perf_counter() - self.t0
        self.range.__exit__(*exc)
        total = _TOTALS.setdefault(self.name, [0.0, 0])
        total[0] += seconds
        total[1] += 1
        return False


class _Proof(_On):
    """The root span of a proof: a new id, which the spans inside carry."""

    __slots__ = ("outer",)

    def __enter__(self):
        global _proof
        self.outer, _proof = _proof, next(_proof_ids)
        super().__enter__()

    def __exit__(self, *exc):
        global _proof
        super().__exit__(*exc)
        _proof = self.outer
        return False


def span(name: str):
    """``with span(name):`` — a range of host work (see the module)."""
    return _On(name) if _profiling() else _OFF


def phase_span(phase: str):
    """The span of a :class:`PhaseTimer` phase: ``stark.<phase>``."""
    return _On("stark." + phase) if _profiling() else _OFF


def proof_span():
    """A proof's root span, ``stark.prove``: it draws the proof's id."""
    return _Proof("stark.prove") if _profiling() else _OFF


def snapshot_spans() -> dict[str, tuple[float, int]]:
    """{name: (host seconds, count)} of the spans closed while the profiler
    ran, since the process started or :func:`reset_spans`."""
    return {name: (seconds, count) for name, (seconds, count) in _TOTALS.items()}


def reset_spans() -> None:
    _TOTALS.clear()


_collection = None


def _gc_span(phase: str, info: dict) -> None:
    """``gc.callbacks`` hook: a collection is the span ``python.gc``."""
    global _collection
    if phase == "start":
        if _profiling():
            _collection = _On("python.gc")
            _collection.__enter__()
    elif _collection is not None:
        collection, _collection = _collection, None
        collection.__exit__(None, None, None)


if _gc_span not in gc.callbacks:
    gc.callbacks.append(_gc_span)


# -- phases ------------------------------------------------------------------------


class PhaseTimer:
    def __init__(self, sync=None):
        self.phases: dict[str, float] = {}
        self._sync = sync

    @contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            with phase_span(name):
                yield
        finally:
            if self._sync is not None:
                self._sync()
            dt = time.perf_counter() - t0
            self.phases[name] = self.phases.get(name, 0.0) + dt

    def ms(self) -> dict[str, float]:
        """{phase: milliseconds}."""
        return {k: v * 1e3 for k, v in self.phases.items()}


class _NullTimer(PhaseTimer):
    """Shared no-op timer: the library default when none is passed.  Its
    phases are spans only."""

    def phase(self, name: str):
        return phase_span(name)


NULL_TIMER = _NullTimer()
