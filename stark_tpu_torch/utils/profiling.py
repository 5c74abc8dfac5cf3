"""Per-phase timing + structured failure reasons.

* :class:`PhaseTimer` — wall-clock per phase (lde / trace_commit /
  challenges / compose / fri_commit / fri_sample / fri_query, the trace
  openings inside it), accumulated into a dict.  ``StarkProver.prove`` and
  ``Fri.prove`` accept ``timer=``.  Phases measure HOST wall time; CUDA
  work is asynchronous, so pass ``sync=torch.cuda.synchronize`` to charge
  each phase with the device work it enqueued instead of the phase that
  happens to wait for it.  The library default is :data:`NULL_TIMER`
  (no accumulation, no synchronisation).
* :func:`reason` — the verifier's failure taxonomy: prints the same
  human-readable reasons the reference prints (fri.rs:331-494) AND records
  a machine-readable (code, message) trail in ``LAST_REASONS`` for tests
  and callers.
"""

from __future__ import annotations

import time
from contextlib import contextmanager

LAST_REASONS: list[tuple[str, str]] = []

_MAX_REASONS = 256


def reason(code: str, message: str) -> None:
    """Record + print a verification failure reason (reference prints only).
    The trail is bounded so long-lived verifier processes cannot leak."""
    if len(LAST_REASONS) >= _MAX_REASONS:
        del LAST_REASONS[: _MAX_REASONS // 2]
    LAST_REASONS.append((code, message))
    print(message)


class PhaseTimer:
    def __init__(self, sync=None):
        self.phases: dict[str, float] = {}
        self._sync = sync

    @contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
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
    """Shared no-op timer: the library default when none is passed."""

    @contextmanager
    def phase(self, name: str):
        yield


NULL_TIMER = _NullTimer()
