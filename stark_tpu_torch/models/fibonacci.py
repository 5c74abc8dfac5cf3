"""Fibonacci AIR — the flagship workload (reference trace.rs:36-49 is the
generator; the constraint system is new, since the reference has none).

Single register t; transition t(w^2 x) = t(w x) + t(x) on rows 0..T-3;
boundary t(row 0) = 1, t(row 1) = 1.

FibonacciSegmentAir is one segment of a longer run of the same recurrence,
as a zkVM proves an execution cut into segments: its public inputs are the
state it starts from and the state it ends in, (a, b, y, z) with t(0) = a,
t(1) = b, t(T-2) = y, t(T-1) = z (rows T-2 and T-1 lie outside the
transition rows).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from stark_tpu_torch.models.air import Air, BoundaryConstraint
from stark_tpu_torch.ops import cuda
from stark_tpu_torch.ops import witness as W
from stark_tpu_torch.ops.fieldops import P
from stark_tpu_torch.utils.profiling import span


class FibonacciAir(Air):
    num_registers = 1
    frame_offsets = (0, 1, 2)
    constraint_degree = 1

    def transition_constraints(self, frame, ops):
        t0 = frame[0][0]
        t1 = frame[1][0]
        t2 = frame[2][0]
        return [ops.sub(t2, ops.add(t1, t0))]

    def boundary_constraints(self, trace_length: int):
        return [
            BoundaryConstraint(row=0, register=0, value=1),
            BoundaryConstraint(row=1, register=0, value=1),
        ]


def fibonacci_trace_mod_p(length: int, start=(1, 1)) -> "np.ndarray":
    """The Fibonacci sequence in F_p — the honest witness for FibonacciAir,
    as a (length, 1) uint32 ndarray; from the start pair ``start`` the
    witness of FibonacciSegmentAir's segment that starts there.

    (The reference generator keeps exact integers; proving needs the
    field-reduced sequence so the transition holds mod p.)
    """
    def gen():
        a, b = (int(v) % P for v in start)
        for _ in range(length):
            yield a
            a, b = b, (a + b) % P

    return np.fromiter(gen(), dtype=np.uint32, count=length).reshape(
        length, 1
    )


def fibonacci_seeds(length: int) -> tuple[np.ndarray, int]:
    """The packed seeds s0 | s1 | u0 | u1 (uint32) of the block expansion
    and their block count nb (stark_tpu/models/fibonacci.py:92-114).

    With a_i = F_{i+1} (F_1 = F_2 = 1), the addition formula F_{m+n} =
    F_m F_{n+1} + F_{m-1} F_n at m = kB + 1, n = j gives a_{kB+j} =
    F_{kB+1} F_{j+1} + F_{kB} F_j: a rank-2 outer product of the block
    seeds s0[k] = F_{kB}, s1[k] = F_{kB+1} and the in-block ladder u0[j] =
    F_j, u1[j] = F_{j+1}, B ~ sqrt(length) a power of two."""
    assert length >= 1
    B = 1 << max(0, (length.bit_length() - 1) // 2)
    nb = (length + B - 1) // B
    fj = [0, 1]
    for _ in range(B):
        fj.append((fj[-1] + fj[-2]) % P)
    fB_1, fB, fB1 = fj[B - 1], fj[B], fj[B + 1]
    s0, s1 = np.empty(nb, dtype=np.uint32), np.empty(nb, dtype=np.uint32)
    m0, m1 = 0, 1  # (F_0, F_1), stepped by the B-advance matrix
    for k in range(nb):
        s0[k], s1[k] = m0, m1
        m0, m1 = (fB * m1 + fB_1 * m0) % P, (fB1 * m1 + fB * m0) % P
    u = np.array(fj[: B + 1], dtype=np.uint32)
    return np.concatenate([s0, s1, u[:B], u[1:]]), nb


class FibonacciSegmentAir(FibonacciAir):
    """A segment of a Fibonacci run: FibonacciAir's transition from the
    start pair (a, b) to the end pair (y, z) at rows T-2, T-1, the public
    inputs (a, b, y, z).  The default statement starts from (1, 1)."""

    def boundary_constraints(self, trace_length: int, public=None):
        if public is None:
            public = (1, 1, *fibonacci_segment_end(trace_length, (1, 1)))
        a, b, y, z = (int(v) % P for v in public)
        return [
            BoundaryConstraint(row=0, register=0, value=a),
            BoundaryConstraint(row=1, register=0, value=b),
            BoundaryConstraint(row=trace_length - 2, register=0, value=y),
            BoundaryConstraint(row=trace_length - 1, register=0, value=z),
        ]


#: Bases made (:func:`_basis`), one a (length, device): a window of
#: witnesses at lengths already seen adds none.
BASIS_BUILDS = 0


@functools.lru_cache(maxsize=16)
def _basis(length: int, device: torch.device) -> tuple[torch.Tensor, np.ndarray, int]:
    """The length's basis on ``device``, made once: (words there, the same
    words on the host (uint32), nb).  The words are F_{kB-2} | F_{kB-1} |
    F_{kB} over the blocks k (F_{-1} = 1, F_{-2} = -1 mod p), then the
    ladder u0 | u1 of :func:`fibonacci_seeds`, whose default seeds F_{kB},
    F_{kB+1} they are made from; any start pair's seeds are their
    combination (:func:`fibonacci_segment_cols_device`).  To a card they go
    up from pinned memory without a wait."""
    global BASIS_BUILDS
    with span("witness.basis"):
        BASIS_BUILDS += 1
        seeds, nb = fibonacci_seeds(length)
        f0 = seeds[:nb].astype(np.int64)                  # F_{kB}
        fm1 = (seeds[nb : 2 * nb] - f0) % P               # F_{kB-1}
        fm2 = (f0 - fm1) % P                              # F_{kB-2}
        words = np.concatenate([fm2.astype(np.uint32), fm1.astype(np.uint32),
                                seeds[:nb], seeds[2 * nb :]])
        host = torch.from_numpy(words.view(np.int32))
        if device.type == "cuda":
            return host.pin_memory().to(device, non_blocking=True), words, nb
        return host.to(device), words, nb


def _end_pair(words: np.ndarray, nb: int, length: int, a: int, b: int) -> tuple[int, int]:
    """(a_{length-2}, a_{length-1}) of the run from (a, b), each from its
    block's basis words and two ladder values (a_{-1} = b - a)."""
    width = (len(words) - 3 * nb) // 2

    def value(i: int) -> int:
        if i < 0:
            return (b - a) % P
        k, j = divmod(i, width)
        fm2, fm1, f0 = (int(words[r * nb + k]) for r in range(3))
        s0, s1 = (a * fm2 + b * fm1) % P, (a * fm1 + b * f0) % P
        u0, u1 = int(words[3 * nb + j]), int(words[3 * nb + width + j])
        return (s1 * u1 + s0 * u0) % P

    return value(length - 2), value(length - 1)


def fibonacci_segment_end(length: int, start) -> tuple[int, int]:
    """The end pair (a_{length-2}, a_{length-1}) of the run from ``start``,
    in O(1) once the length's basis is made."""
    _, words, nb = _basis(length, torch.device("cpu"))
    return _end_pair(words, nb, length, *(int(v) % P for v in start))


def _run_cols(length: int, start, device: torch.device) -> tuple:
    """The run from ``start`` on ``device`` and its end pair: the length's
    basis (made on its first call), the start pair reduced, one K12 launch.
    Nothing here waits for the card."""
    with span("witness.upload"):
        basis, words, nb = _basis(length, device)
    with span("witness.seeds"):
        a, b = (int(v) % P for v in start)
        end = _end_pair(words, nb, length, a, b)
    with span("witness.expand"):
        return W.fib_expand(basis, nb, length, (a, b)), end


def fibonacci_segment_cols_device(length: int, start, device="cuda") -> tuple:
    """A segment's witness on ``device`` and its end pair: ((1, length) int32
    columns, (y, z)), the run from the start pair ``start`` made there by
    K12 from the length's basis.  The public inputs of its statement are
    (*start, y, z); feed the columns to ``StarkProver.prove(trace_cols=...,
    public=...)`` or a batch's ``traces_cols``.  No upload and no wait
    after a length's first call: a pipelined feed makes the next batch's
    witnesses while the card still runs the batches before them."""
    return _run_cols(length, start, cuda.device_or_raise(device, "fibonacci_segment_cols_device"))


def fibonacci_trace_cols_device(length: int, device="cuda") -> torch.Tensor:
    """(1, length) int32 trace columns on ``device``, equal to
    ``fibonacci_trace_mod_p(length).T``: the default statement's segment,
    the run from (1, 1) (:func:`fibonacci_segment_cols_device`), made there
    by K12 (ops/witness.fib_expand) instead of uploading the witness.  Feed
    it to ``StarkProver.prove(trace_cols=...)``."""
    return _run_cols(length, (1, 1), cuda.device_or_raise(device, "fibonacci_trace_cols_device"))[0]
