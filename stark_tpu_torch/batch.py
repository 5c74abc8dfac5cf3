"""Batched proving: B independent proofs through one device pipeline.

Counterpart of stark_tpu/batch.py (``BatchStarkProver``: its single-fetch
path ``_prove_batch_mega``, :596-940, and its classic path
``_prove_batch_classic``, :941-1149).  B same-shape proofs lie side by
side: the witness columns (B, c, T) go through the NTT as B c rows, the
trace LDEs (B, c, N) and the composition codewords (B, N) are one tensor
each, the B trace trees and each FRI round's B trees are one forest
(merkle.Forest: K5/K6, K7, K8-forest), the constraint challenges are one
launch with B lanes (K15), the FRI commit is one device chain with B
sponge lanes (K9) and B folds a launch (K4-dyn), the query indices one
launch (K10) and the query phase of every proof one gather (K13).  The
host reads from the card once for the whole batch (with
``Fri.fused_round`` False three times: the B trace roots, the commit
chain's one fetch, the query phase's one gather).

The output is **byte-identical** to B runs of StarkProver.prove: each
proof keeps its own transcript, challenges, indices and stream (the host
replays each one and checks the card's values against it).  The batched
prove is StarkProver._prove_columns itself; a single prove is its B = 1
case.

``prove_many`` keeps up to ``depth`` batches in flight on the single-fetch
path (stark_tpu's "production serving layout", :653-715): a batch's
launches and its read are issued (StarkProver._dispatch; on a card one
replay of the batch's slot's CUDA graph), and it is finished (the read
waited for, the transcripts replayed, the proofs emitted) only after later
batches' launches have gone out, so that the host's replay of batch k
overlaps the card's work on batch k + 1.

With ``mesh=`` (parallel/mesh.py, one process per device; stark_tpu's
:580-594 and :637-644): where D divides B the batch is cut, each rank
proves its B/D proofs with the single-device pipeline (the single-fetch
path, as stark_tpu's batch-sharded mega path) and an all-gather of the
proofs gives every rank all B; otherwise each proof is cut over the
domain, the sharded prover's dispatch with the B axis leading, which is
the single-fetch path too (one read a batch on every rank), so
``prove_many`` keeps such batches in flight as well (stark_tpu runs its
classic path there, :596-605: the same bytes).  Either way every rank
returns the same B proofs.
"""

from __future__ import annotations

import collections

import numpy as np
import torch

from stark_tpu_torch.stark import StarkConfig, StarkProver
from stark_tpu_torch.utils.profiling import NULL_TIMER, proof_span


class BatchStarkProver:
    """Prove B same-shape traces at once on ``device`` (default ``cuda``;
    raises without a card unless ``device="cpu"``, which runs every
    kernel's plain version).  The trace-independent tables are those of one
    StarkProver, built once."""

    def __init__(self, air, cfg: StarkConfig, batch: int, device="cuda",
                 lazy_ntt: bool = False, mesh=None):
        if batch < 1:
            raise ValueError(f"batch must be >= 1, got {batch}")
        self.air = air
        self.cfg = cfg
        self.B = batch
        self.mesh = mesh
        # Where D divides B the batch is cut over the mesh.
        self._cut = mesh is not None and batch % mesh.size == 0
        if mesh is None:
            self._single = StarkProver(air, cfg, device=device, lazy_ntt=lazy_ntt)
        elif self._cut:
            # This rank's B/D proofs on its own device.
            self._single = StarkProver(air, cfg, device=mesh.device, lazy_ntt=lazy_ntt)
        else:
            from stark_tpu_torch.parallel.pstark import DistributedStarkProver

            self._single = DistributedStarkProver(air, cfg, mesh, lazy_ntt=lazy_ntt)
        self.device = self._single.device
        self.fri = self._single.fri

    def _gather_proofs(self, mine: list[bytes]) -> list[bytes]:
        """Every rank's proofs, in rank order, on every rank: one all-gather
        of the lengths, one of the proofs' bytes padded to the longest."""
        mesh = self.mesh
        lengths = torch.tensor([len(p) for p in mine], dtype=torch.int64, device=mesh.device)
        every = mesh.all_gather(lengths).cpu().numpy()
        buf = torch.zeros(int(every.sum(axis=1).max()), dtype=torch.uint8)
        data = b"".join(mine)
        buf[: len(data)] = torch.frombuffer(bytearray(data), dtype=torch.uint8)
        got = mesh.all_gather(buf.to(mesh.device)).cpu().numpy()
        out = []
        for rank, sizes in enumerate(every):
            ends = np.cumsum(sizes)
            out += [got[rank, end - size : end].tobytes() for size, end in zip(sizes, ends)]
        return out

    def _cols_stack(self, traces, traces_cols, lo: int, hi: int) -> torch.Tensor:
        """(B, c, T) int32 columns on the prover's device from EITHER B host
        row traces (reference trace.rs:29-34 ingestion) or B (c, T) column
        arrays or tensors, which may already lie on the device (the device
        witnesses: no witness byte crosses from the host)
        (stark_tpu/batch.py:614).  ``lo``, ``hi``: only traces lo .. hi - 1
        (a rank's share of a cut batch)."""
        if (traces is None) == (traces_cols is None):
            raise ValueError("pass traces or traces_cols, one of them")
        items = traces if traces_cols is None else traces_cols
        if len(items) != self.B:
            raise ValueError(f"the batch holds {self.B} traces, got {len(items)}")
        rows = traces_cols is None
        return torch.stack([self._single._witness(t if rows else None, None if rows else t)
                            for t in items[lo:hi]])

    def prove_batch(self, traces=None, *, traces_cols=None,
                    timer=NULL_TIMER) -> list[bytes]:
        """B proofs, each byte-identical to StarkProver.prove of its trace.
        ``traces``: B host row traces; or ``traces_cols``: B (c, T) column
        arrays or int32 tensors on the prover's device."""
        with proof_span():
            return self._finish(self._dispatch(traces, traces_cols, timer))

    def _dispatch(self, traces=None, traces_cols=None, timer=NULL_TIMER, ring: int = 1):
        """A batch's launches and read, issued (stark_tpu's _mega_dispatch)
        on one of ``ring`` slots (StarkProver._dispatch): the state
        :meth:`_finish` takes."""
        lo, hi = self.mesh.bounds(self.B) if self._cut else (0, self.B)
        with timer.phase("lde"):
            cols = self._cols_stack(traces, traces_cols, lo, hi)
        return self._single._dispatch(cols, timer, ring)

    def _finish(self, finish) -> list[bytes]:
        """A dispatched batch's proofs (stark_tpu's _mega_finish): the read
        waited for, the transcripts replayed, the proofs emitted; on a cut
        batch every rank's, all-gathered."""
        proofs = finish()
        return self._gather_proofs(proofs) if self._cut else proofs

    def close(self) -> None:
        """Release the slots and CUDA graphs of the prover underneath
        (StarkProver.close)."""
        self._single.close()

    def prove_many(self, traces=None, depth: int = 2, *,
                   traces_cols=None) -> list[bytes]:
        """Any number of same-shape traces in batches of B, keeping up to
        ``depth`` batches in flight (stark_tpu/batch.py:653-715): batch k is
        finished only after batch k + depth's launches have gone out, so the
        host's replay and emission of one batch overlap the card's work on
        the next.  A last partial batch is padded by repeating its last
        trace and the pad proofs are dropped.  The bytes equal sequential
        :meth:`prove_batch` calls'.  Every batch in flight holds its device
        state (trace LDEs, trees, codewords, the buffer it reads) until it
        is finished: a ring of ``max(1, depth) + 1`` slots of B proofs, each
        its own CUDA graph on a card (StarkProver._dispatch)."""
        use_cols = traces_cols is not None
        items = list(traces_cols if use_cols else traces)
        out: list[bytes] = []
        inflight: collections.deque = collections.deque()
        for i in range(0, len(items), self.B):
            chunk = items[i : i + self.B]
            pad = self.B - len(chunk)
            chunk = chunk + [chunk[-1]] * pad
            kw = {"traces_cols": chunk} if use_cols else {"traces": chunk}
            inflight.append((pad, self._dispatch(**kw, ring=max(1, depth) + 1)))
            if len(inflight) > max(1, depth):
                pad0, finish = inflight.popleft()
                out.extend(self._finish(finish)[: self.B - pad0])
        while inflight:
            pad0, finish = inflight.popleft()
            out.extend(self._finish(finish)[: self.B - pad0])
        return out
