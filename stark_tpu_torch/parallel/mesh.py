"""The device mesh of the sharded prover: one process per device.

Counterpart of stark_tpu/parallel/mesh.py.  JAX's ``Mesh`` and
``shard_map`` form a single-controller model; PyTorch's own idiom is one
process per device with a ``torch.distributed`` process group, and that is
this package's model.  Every rank runs the same host control plane (the
transcripts, the replays, the emission), so every rank ends with the same
proof bytes.  The evaluation-domain axis is cut contiguously: of an axis of
length n, rank d holds ``[d n/D, (d+1) n/D)`` (:meth:`Mesh.bounds`).

A :class:`Mesh` holds the process group, the rank, the size and the rank's
device, and the few collectives the sharded prover needs: an all-to-all of
equal chunks, an all-gather, an exchange of chunks of any size between
pairs of ranks (an all-to-all of uneven splits), and a sum of int32 words
(the query gather's combine).  Each raises the mesh's
counters (:attr:`Mesh.counts`: calls and words by collective, and a log of
each call's words), so that tests can count them; a CUDA graph that holds
collectives takes them back at its capture and adds them at each replay
(ops/cuda.taken_back).

A world of one rank needs no process group: its collectives are local
copies (counted all the same), as a one-device mesh is in JAX.

Backends are explicit and never chosen on failure: ``nccl`` for CUDA
tensors, ``gloo`` for CPU tensors, and gloo with CUDA tensors only when the
caller names both (several ranks sharing one card, where NCCL refuses):
the kernels run on the card, and gloo carries the exchanges through host
memory itself (its all_to_all_single, even, uneven and async, its
all_gather and its all_reduce take CUDA tensors on torch 2.11.0+cu128),
so the mesh hands it the tensors as they are.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from stark_tpu_torch.ops import cuda
from stark_tpu_torch.ops import ntt_fused as NTF

class Mesh:
    """``size`` ranks of a 1-D mesh; this process is ``rank`` and computes on
    ``device``.  ``group``: the process group (None for a world of one)."""

    def __init__(self, group=None, rank: int = 0, size: int = 1, device="cuda",
                 backend: str | None = None):
        if size < 1 or size & (size - 1):
            raise ValueError(f"a mesh of {size} ranks: the size must be a power of two")
        if not 0 <= rank < size:
            raise ValueError(f"rank {rank} of {size}")
        if size > 1 and group is None:
            raise ValueError("a mesh of several ranks needs a process group")
        self.group = group
        self.rank = rank
        self.size = size
        self.device = cuda.device_or_raise(device, "Mesh")
        self.backend = backend
        if group is not None and backend == "nccl" and self.device.type != "cuda":
            raise ValueError("nccl carries CUDA tensors: give the mesh a CUDA device")
        if self.device.type == "cuda":
            # The rank's card is the current one: NCCL's own calls (a
            # barrier) and kernels launched without a device go there.
            torch.cuda.set_device(self.device)
        self.counts: dict[str, int] = {}
        self.log: list[tuple[str, int]] = []

    def __repr__(self) -> str:
        return (f"Mesh(rank={self.rank}, size={self.size}, device={self.device}, "
                f"backend={self.backend})")

    # -- layout -------------------------------------------------------------------

    def bounds(self, n: int) -> tuple[int, int]:
        """This rank's contiguous share ``[lo, hi)`` of an axis of length n,
        D | n."""
        if n % self.size:
            raise ValueError(f"an axis of {n} does not split over {self.size} ranks")
        m = n // self.size
        return self.rank * m, (self.rank + 1) * m

    def owner(self, indices, n: int):
        """The rank that holds each index of an axis of length n (numpy)."""
        return (indices * self.size) // n

    # -- counters -----------------------------------------------------------------

    def _count(self, op: str, words: int) -> None:
        self.counts[op] = self.counts.get(op, 0) + 1
        self.counts[op + "_words"] = self.counts.get(op + "_words", 0) + words
        self.log.append((op, words))

    def reset_counts(self) -> None:
        self.counts = {}
        self.log = []

    # The counts as a ledger of ops/cuda.taken_back: a captured graph's
    # collectives are taken back at its capture and added at each replay.

    def mark(self) -> int:
        return len(self.log)

    def take_back(self, mark: int) -> list[tuple[str, int]]:
        held = self.log[mark:]
        del self.log[mark:]
        for op, words in held:
            self.counts[op] -= 1
            self.counts[op + "_words"] -= words
        return held

    def add(self, held: list[tuple[str, int]]) -> None:
        for op, words in held:
            self._count(op, words)

    # -- collectives ------------------------------------------------------------------

    def all_to_all(self, x: torch.Tensor, async_op: bool = False):
        """Equal chunks: ``x`` (D m, ...) contiguous; chunk e goes to rank e,
        and the result (D m, ...) holds the chunk from rank s at s.  With
        ``async_op``, returns a handle whose ``wait()`` gives the result."""
        if x.shape[0] % self.size:
            raise ValueError(f"{x.shape[0]} rows do not split over {self.size} ranks")
        self._count("all_to_all", x.numel())
        if self.group is None:
            out = x.clone()
            return _Done(out) if async_op else out
        x = x.contiguous()
        out = torch.empty_like(x)
        work = dist.all_to_all_single(out, x, group=self.group, async_op=async_op)
        return _Pending(work, out) if async_op else out

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """(...) on every rank -> (D, ...), rank s's at s."""
        self._count("all_gather", x.numel())
        if self.group is None:
            return x[None].clone()
        out = torch.empty((self.size,) + tuple(x.shape), dtype=x.dtype, device=x.device)
        dist.all_gather(list(out.unbind(0)), x.contiguous(), group=self.group)
        return out

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over the ranks of ``x`` (int32), in place, on every rank.
        Exact where at most one rank's word is non-zero (the windowed
        query gather's combine, pmerkle.ShardedRulePlan)."""
        if x.dtype != torch.int32 or not x.is_contiguous():
            raise ValueError(f"all_reduce sums contiguous int32, got {x.dtype}")
        self._count("all_reduce", x.numel())
        if self.group is not None:
            dist.all_reduce(x, op=dist.ReduceOp.SUM, group=self.group)
        return x

    def exchange(self, x: torch.Tensor, send: list[int], recv: list[int]) -> torch.Tensor:
        """Chunks of any size between pairs of ranks: ``x`` (sum(send), ...)
        holds, in rank order, ``send[e]`` rows for each rank e; the result
        (sum(recv), ...) holds ``recv[s]`` rows from each rank s, in rank
        order.  Every rank's ``send[e]`` must equal rank e's ``recv[rank]``."""
        if len(send) != self.size or len(recv) != self.size or sum(send) != x.shape[0]:
            raise ValueError(f"splits {send} / {recv} for {self.size} ranks and "
                             f"{x.shape[0]} rows")
        rest = tuple(x.shape[1:])
        self._count("exchange", x.numel())
        if self.group is None:
            return x.clone()
        out = torch.empty((sum(recv),) + rest, dtype=x.dtype, device=x.device)
        dist.all_to_all_single(out, x.contiguous(), recv, send, group=self.group)
        return out

    def agree(self, ok: bool) -> bool:
        """Whether ``ok`` holds on every rank: one all-reduce (the minimum)
        of one word, uncounted, outside any graph (DistributedStarkProver's
        captures: one that fails on a rank raises on every rank)."""
        if self.group is None:
            return ok
        flag = torch.full((1,), int(ok), dtype=torch.int32, device=self.device)
        dist.all_reduce(flag, op=dist.ReduceOp.MIN, group=self.group)
        return bool(flag.item())

    def barrier(self) -> None:
        if self.group is not None:
            dist.barrier(group=self.group)

    def first(self, build) -> None:
        """``build()`` on rank 0, then on the others after a barrier: the
        kernel libraries are built once, not D times at once."""
        if self.rank == 0:
            build()
        self.barrier()
        if self.rank != 0:
            build()


def swap_blocks(x: torch.Tensor, batch: int, p: int, q: int, e: int) -> torch.Tensor:
    """(batch, p, q, e) contiguous -> (batch, q, p, e): the layout moves
    around the exchanges, as transposes K3 (ops/ntt_fused.ntt_transpose):
    none where p or q is 1, one where e is 1, else two ((batch, p, q e) ->
    (batch, q e, p) -> (batch q, p, e))."""
    x = x.reshape(batch, p, q * e)
    if p == 1 or q == 1:
        return x.reshape(batch, q, p, e)
    if e == 1:
        return NTF.ntt_transpose(x).reshape(batch, q, p, 1)
    y = NTF.ntt_transpose(x).reshape(batch * q, e, p)
    return NTF.ntt_transpose(y).reshape(batch, q, p, e)


class Shard:
    """A (..., n) array over the mesh, cut on its last axis (stark_tpu's
    ``sharded`` layout): ``local`` is this rank's (..., n/D) share, or the
    whole array where ``split`` is False (stark_tpu's ``replicated``,
    :func:`replicated`).
    ``rows``: set for the flat (B n,) view of a (B, n) array
    (:meth:`reshape`), whose index g is row g // n, point g % n.

    :meth:`locate` gives, for global indices, the rank that serves each and
    its index into that rank's ``local``: the holder where the array is cut,
    and where it is whole the rank the cut would give (any rank can read
    it; so the reads spread as the cut ones do)."""

    def __init__(self, mesh: "Mesh", local: torch.Tensor, n: int, split: bool = True,
                 rows: int | None = None):
        share = n // mesh.size if split else n
        if (split and n % mesh.size) or (rows is None and local.shape[-1] != share):
            raise ValueError(f"a share of {local.shape[-1]} of an axis of {n} over "
                             f"{mesh.size} ranks (split: {split})")
        self.mesh, self.local, self.n, self.split, self.rows = mesh, local, n, split, rows

    @property
    def m(self) -> int:
        """The length of a rank's share of the cut axis."""
        return self.n // self.mesh.size if self.split else self.n

    @property
    def device(self) -> torch.device:
        return self.local.device

    @property
    def shape(self) -> tuple:
        if self.rows is not None:
            return (self.rows * self.n,)
        return tuple(self.local.shape[:-1]) + (self.n,)

    def __getitem__(self, j: int) -> "Shard":
        if self.rows is not None or self.local.dim() < 2:
            raise IndexError("a flat or 1-D shard has no rows to select")
        return Shard(self.mesh, self.local[j], self.n, self.split)

    def reshape(self, *shape) -> "Shard":
        """Only the flat view of a (B, n) array: ``reshape(-1)``."""
        if shape not in ((-1,), ((-1,),)) or self.local.dim() != 2 or self.rows is not None:
            raise ValueError(f"a shard reshapes only (B, n) -> (-1,), got {shape}")
        return Shard(self.mesh, self.local.reshape(-1), self.n, self.split,
                     rows=int(self.local.shape[0]))

    def locate(self, indices) -> tuple[np.ndarray, np.ndarray]:
        """(ranks, local indices) of global ``indices`` (numpy int64)."""
        g = np.asarray(indices, dtype=np.int64)
        row, i = (g // self.n, g % self.n) if self.rows is not None else (0, g)
        owner = self.mesh.owner(i, self.n)
        if not self.split:
            return owner, g
        return owner, row * self.m + i - owner * self.m

    def whole(self) -> torch.Tensor:
        """The whole array on every rank: an all-gather of the shares, or
        ``local`` itself where it is whole."""
        if not self.split:
            return self.local
        if self.rows is not None:
            raise ValueError("gather the (B, n) shard, not its flat view")
        lead = tuple(self.local.shape[:-1])
        b = int(np.prod(lead, dtype=np.int64))
        got = self.mesh.all_gather(self.local.contiguous())       # (D, *lead, m)
        return swap_blocks(got, 1, self.mesh.size, b, self.m).reshape(lead + (self.n,))


def replicated(mesh: "Mesh", whole: torch.Tensor) -> Shard:
    """A (..., n) array that every rank holds whole."""
    return Shard(mesh, whole, int(whole.shape[-1]), False)


class _Done:
    def __init__(self, out):
        self.out = out

    def wait(self) -> torch.Tensor:
        return self.out


class _Pending:
    def __init__(self, work, out):
        self.work, self.out = work, out

    def wait(self) -> torch.Tensor:
        self.work.wait()
        return self.out


def make_mesh(n_devices: int | None = None, device=None) -> Mesh:
    """A 1-D mesh over the initialised process group (parallel/
    distributed.initialize_distributed), or a mesh of one rank where there
    is none.  ``device``: this rank's device, by default ``cuda:<LOCAL_RANK>``
    (``cpu`` when asked; several gloo ranks that share one card name it).
    ``n_devices`` must equal the world's size when given."""
    if dist.is_available() and dist.is_initialized():
        size, rank = dist.get_world_size(), dist.get_rank()
        group, backend = dist.group.WORLD, dist.get_backend()
    else:
        size, rank, group, backend = 1, 0, None, None
    if n_devices is not None and n_devices != size:
        raise ValueError(f"requested {n_devices} devices, the world has {size} ranks")
    if device is None:
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', '0'))}"
    return Mesh(group, rank, size, device, backend)
