"""Batched proving: B independent proofs through one device pipeline.

Counterpart of stark_tpu/batch.py (``BatchStarkProver``, its classic path
``_prove_batch_classic``, :941-1149).  B same-shape proofs lie side by side:
the witness columns (B, c, T) go through the NTT as B c rows, the trace
LDEs (B, c, N) and the composition codewords (B, N) are one tensor each,
the B trace trees and each FRI round's B trees are one forest
(merkle.Forest: K5/K6, K7, K8-forest), the FRI commit is one device chain
with B sponge lanes (K9) and B folds a launch (K4-dyn), and the query phase
of every proof is one gather (K13).  The host reads from the card three
times for the whole batch: the B trace roots, the commit chain's one
fetch, the query phase's one gather.

The output is **byte-identical** to B runs of StarkProver.prove: each
proof keeps its own transcript, challenges, indices and stream (the host
replays each one and checks the card's challenges against it).  The
batched prove is StarkProver._prove_columns itself; a single prove is its
B = 1 case.

With ``mesh=`` (parallel/mesh.py, one process per device; stark_tpu's
:580-594 and :637-644): where D divides B the batch is cut, each rank
proves its B/D proofs with the single-device pipeline and an all-gather of
the proofs gives every rank all B; otherwise each proof is cut over the
domain, the sharded prover's ``_prove_columns`` with the B axis leading.
Either way every rank returns the same B proofs.

Not ported: the single-fetch "mega" path of stark_tpu (``_batch_mega_fn``;
its bytes are the same, and stark_tpu takes the classic path whenever its
shapes do not admit the mega one), and a pipeline of ``depth`` batches in
flight: ``prove_many`` proves its chunks one after another, as stark_tpu
does when the mega path is off.
"""

from __future__ import annotations

import numpy as np
import torch

from stark_tpu_torch.stark import StarkConfig, StarkProver
from stark_tpu_torch.utils.profiling import NULL_TIMER


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
        lo, hi = self.mesh.bounds(self.B) if self._cut else (0, self.B)
        with timer.phase("lde"):
            cols = self._cols_stack(traces, traces_cols, lo, hi)
        proofs = self._single._prove_columns(cols, timer)
        return self._gather_proofs(proofs) if self._cut else proofs

    def prove_many(self, traces=None, depth: int = 2, *,
                   traces_cols=None) -> list[bytes]:
        """Any number of same-shape traces in batches of B, one after
        another; a last partial batch is padded by repeating its last trace
        and the pad proofs are dropped (stark_tpu/batch.py:653-715).
        ``depth`` is taken for stark_tpu's signature: its pipeline of
        batches in flight is not ported, so each batch runs to its end."""
        del depth
        use_cols = traces_cols is not None
        items = list(traces_cols if use_cols else traces)
        out: list[bytes] = []
        for i in range(0, len(items), self.B):
            chunk = items[i : i + self.B]
            pad = self.B - len(chunk)
            chunk = chunk + [chunk[-1]] * pad
            kw = {"traces_cols": chunk} if use_cols else {"traces": chunk}
            out.extend(self.prove_batch(**kw)[: self.B - pad])
        return out
