"""The query phase's gather: kernel K13 (csrc/gather.cu) and its plain version.

Counterpart of what stark_tpu fuses into one XLA dispatch per prove: the
FRI rounds' value and sibling-path reads (fri.py:_query_gather_fn), the
trace openings (stark.py:_trace_open_fn) and their packing into one buffer
for one fetch (fri.py:_pack_u8_core).  A :class:`GatherPlan` collects, on
the host, every read the query phase and the trace openings make:

* :meth:`GatherPlan.values` - the c values at some indices of a (c, n) or
  (n,) int32 array (a codeword, the trace LDE);
* :meth:`GatherPlan.paths` - the authentication paths of some leaves of a
  tree's (2W - 1, 32) u8 level stack (merkle.py).

:func:`fetch` runs all of them as one launch into one buffer of 32-bit
words and brings that buffer to the host in one copy; each request's
:class:`Slot` cuts its piece out.  On a CPU tensor :func:`gather` runs the
plain version, torch indexing over the same list; on CUDA tensors it
launches the kernel or raises.  Every source must stay alive and unchanged
until the fetch has landed: the plan holds a reference to each.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from stark_tpu_torch.merkle import path_rows
from stark_tpu_torch.ops import cuda

QUERY_GATHER = cuda.Kernel(
    "query_gather", "stark_query_gather",
    [cuda.ptr, cuda.i32, cuda.i32, cuda.ptr],
    source="stark_tpu_torch/csrc/gather.cu",
    replaces="stark_tpu/fri.py:307",
)

VALUES, PATHS = 0, 1


@dataclass(frozen=True)
class Slot:
    """Where one request's results lie in the gathered words: ``k`` values
    of ``width`` words (a row of c field values, or a path of depth
    digests of 8 words) from word ``first`` on."""

    kind: int
    first: int
    k: int
    width: int

    @property
    def words(self) -> int:
        return self.k * self.width

    def take(self, host: np.ndarray) -> np.ndarray:
        """From the fetched (words,) uint32 buffer: (k, c) uint32 values or
        (k, depth, 32) u8 sibling digests."""
        part = host[self.first : self.first + self.words]
        if self.kind == VALUES:
            return part.reshape(self.k, self.width)
        return part.view(np.uint8).reshape(self.k, self.width // 8, 32)


class GatherPlan:
    """Every read of one launch: the sources (tensors on one device) and,
    per request, (source, indices, first output word)."""

    def __init__(self):
        self.sources: list[torch.Tensor] = []
        self._meta: list[tuple[int, int, int]] = []   # (kind, a, b)
        self._where: dict[tuple, int] = {}
        self.requests: list[tuple[int, np.ndarray, Slot]] = []
        self.words = 0

    @property
    def device(self) -> torch.device:
        return self.sources[0].device

    def _source(self, t: torch.Tensor, kind: int, a: int, b: int) -> int:
        if self.sources and t.device != self.device:
            raise ValueError(f"gather sources on {self.device} and {t.device}")
        key = (t.data_ptr(), kind, a, b)
        if key not in self._where:
            self._where[key] = len(self.sources)
            self.sources.append(t)
            self._meta.append((kind, a, b))
        return self._where[key]

    def _add(self, src: int, kind: int, indices, width: int, bound: int) -> Slot:
        idx = np.ascontiguousarray(indices, dtype=np.int64).reshape(-1)
        if idx.size and (idx.min() < 0 or idx.max() >= bound):
            raise IndexError(f"gather index out of range [0, {bound})")
        slot = Slot(kind, self.words, int(idx.size), width)
        self.requests.append((src, idx, slot))
        self.words += slot.words
        return slot

    def values(self, src: torch.Tensor, indices) -> Slot:
        """The values at ``indices`` of a (n,) or (c, n) int32 array: a
        (k, c) slot."""
        if src.dtype != torch.int32 or src.dim() not in (1, 2):
            raise ValueError(f"values source: (n,) or (c, n) int32, got "
                             f"{src.dtype} {tuple(src.shape)}")
        c, n = (1, src.shape[0]) if src.dim() == 1 else tuple(src.shape)
        s = self._source(src, VALUES, n, c)
        return self._add(s, VALUES, indices, c, n)

    def paths(self, stack: torch.Tensor, indices) -> Slot:
        """The authentication paths of leaves ``indices`` of a (2W - 1, 32)
        u8 level stack: a (k, log2 W, 32) slot."""
        w = (int(stack.shape[0]) + 1) // 2
        if stack.dtype != torch.uint8 or tuple(stack.shape) != (2 * w - 1, 32) \
                or w & (w - 1):
            raise ValueError(f"paths source: a (2W - 1, 32) u8 level stack, got "
                             f"{stack.dtype} {tuple(stack.shape)}")
        depth = w.bit_length() - 1
        s = self._source(stack, PATHS, w, depth)
        return self._add(s, PATHS, indices, 8 * depth, w)

    def table(self) -> np.ndarray:
        """The kernel's int64 operand table (csrc/gather.cu): 4 words per
        source (address, kind, a, b), then 3 per request (source, index,
        first output word)."""
        srcs = np.array([(t.data_ptr(), *m) for t, m in zip(self.sources, self._meta)],
                        dtype=np.int64).reshape(-1, 4)
        reqs = [np.stack([np.full(idx.size, s, dtype=np.int64), idx,
                          slot.first + slot.width * np.arange(idx.size, dtype=np.int64)],
                         axis=1)
                for s, idx, slot in self.requests]
        return np.concatenate([srcs.reshape(-1)] + [r.reshape(-1) for r in reqs])


def gather_plain(plan: GatherPlan) -> torch.Tensor:
    """torch indexing over the plan's requests, concatenated: the (words,)
    int32 buffer the kernel writes."""
    parts = [torch.empty(0, dtype=torch.int32, device=plan.device)]
    for s, idx, slot in plan.requests:
        src, (kind, a, b) = plan.sources[s], plan._meta[s]
        if kind == VALUES:
            sel = torch.from_numpy(idx).to(src.device)
            parts.append(src.reshape(b, a)[:, sel].T.reshape(-1))
        else:
            rows = torch.from_numpy(path_rows(a, idx).reshape(-1)).to(src.device)
            parts.append(src.view(torch.int32)[rows].reshape(-1))
    return torch.cat(parts)


def _check_sources(plan: GatherPlan) -> None:
    for t in plan.sources:
        cuda.check_operand(t, "gather source", t.dtype)
        if t.dtype == torch.uint8 and t.data_ptr() % 4:
            raise ValueError("a level stack must start on a 4-byte boundary")


def gather(plan: GatherPlan) -> torch.Tensor:
    """All of ``plan``'s reads into one (words,) int32 tensor on the
    sources' device: one K13 launch on a card, the plain version on the
    CPU."""
    if not plan.requests:
        raise ValueError("an empty gather plan")
    dev = plan.device
    if dev.type == "cpu":
        return gather_plain(plan)
    _check_sources(plan)
    table = torch.from_numpy(plan.table()).pin_memory().to(dev, non_blocking=True)
    out = torch.empty(plan.words, dtype=torch.int32, device=dev)
    n_req = sum(idx.size for _, idx, _ in plan.requests)
    QUERY_GATHER.launch(dev, table.data_ptr(), len(plan.sources), n_req,
                        out.data_ptr())
    return out


def fetch(plan: GatherPlan) -> np.ndarray:
    """:func:`gather`, then the buffer on the host as (words,) uint32: on a
    card one copy into pinned memory, waited for with an event."""
    words = gather(plan)
    if words.device.type == "cpu":
        return words.numpy().view(np.uint32)
    host = torch.empty(words.shape, dtype=torch.int32, pin_memory=True)
    host.copy_(words, non_blocking=True)
    landed = torch.cuda.Event()
    landed.record(torch.cuda.current_stream(words.device))
    landed.synchronize()
    return host.numpy().view(np.uint32)
