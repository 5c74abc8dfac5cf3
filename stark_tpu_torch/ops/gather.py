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
:class:`Slot` cuts its piece out.  The launch takes the plan itself as
its parameters (:meth:`GatherPlan.encode`), so no table goes up to the
card first; a plan too large for one launch's parameters takes several.
On a CPU tensor :func:`gather` runs the plain version, torch indexing
over the same list; on CUDA tensors it launches the kernel or raises.  Every source must stay alive and unchanged
until the fetch has landed: the plan holds a reference to each.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from stark_tpu_torch.merkle import path_rows
from stark_tpu_torch.ops import cuda

QUERY_GATHER = cuda.Kernel(
    "query_gather", "stark_query_gather", [cuda.ptr, cuda.i32],
    source="stark_tpu_torch/csrc/gather.cu",
    replaces="stark_tpu/fri.py:307",
)

VALUES, PATHS = 0, 1

# The sizes of the parameter struct that csrc/gather.cu is built for, in
# bytes (the largest within the 32,764 bytes of parameters that CUDA 12.1
# allows a launch); a launch carries the smallest that holds its part of
# the plan.
PARAM_BYTES = (4096, 16384, 32752)
HEADER_WORDS = 8
_MAX_WORDS = PARAM_BYTES[-1] // 4
_U32 = 1 << 32


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
    """Every read of one gather: the sources (tensors on one device) and,
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

    def paths(self, stack: torch.Tensor, indices, depth: int | None = None) -> Slot:
        """The authentication paths of leaves ``indices`` of a (2W - 1, 32)
        u8 level stack: a (k, log2 W, 32) slot.  With ``depth``, the stack
        is a forest's, (2W - B, 32) for B trees of width 2^depth (merkle.py:
        Forest), and leaf i of tree b is leaf b 2^depth + i: a (k, depth,
        32) slot."""
        rows = int(stack.shape[0])
        if depth is None:
            w = (rows + 1) // 2
            depth = w.bit_length() - 1
        else:
            w = rows * (1 << depth) // ((2 << depth) - 1)
        if stack.dtype != torch.uint8 or stack.dim() != 2 or stack.shape[1] != 32 \
                or w < 1 or w % (1 << depth) or 2 * w - (w >> depth) != rows:
            raise ValueError(f"paths source: a level stack of trees of width 2^"
                             f"{depth}, got {stack.dtype} {tuple(stack.shape)}")
        s = self._source(stack, PATHS, w, depth)
        return self._add(s, PATHS, indices, 8 * depth, w)

    def fetch(self) -> np.ndarray:
        """:func:`fetch` of this plan."""
        return fetch(self)

    def encode(self, out_address: int) -> list[np.ndarray]:
        """The kernel's operands (csrc/gather.cu): one uint32 array per
        launch, each of one of the :data:`PARAM_BYTES` sizes, that writes
        into the buffer at ``out_address``.  Each holds the header, every
        source, then its pieces of the requests: a slot per piece (source,
        requests, first output word, first index), a task per warp (slot |
        first request << 16; a warp takes 32 // w requests of w <= 32 words,
        else one) and an index per request.  A plan too large for one
        launch is cut into several; both proves' plans take one.  Raises
        where a field does not fit its bits."""
        n_src = len(self.sources)
        srcs = np.zeros((n_src, 4), dtype=np.uint64)
        for i, (t, (kind, a, b)) in enumerate(zip(self.sources, self._meta)):
            if not (0 < a < _U32 and 0 <= b < 1 << 31):
                raise ValueError(f"gather source {i}: ({a}, {b}) does not fit 32 bits")
            ptr = t.data_ptr()
            srcs[i] = (ptr % _U32, ptr >> 32, a, kind << 31 | b)
        fixed = HEADER_WORDS + 4 * n_src
        if fixed + 6 > _MAX_WORDS:
            raise ValueError(f"{n_src} gather sources: a launch holds at most "
                             f"{(_MAX_WORDS - HEADER_WORDS - 6) // 4}")
        if self.words >= _U32:
            raise ValueError(f"{self.words} output words do not fit 32 bits")
        launches, pieces, room = [], [], _MAX_WORDS - fixed
        for s, idx, slot in self.requests:
            if slot.width == 0 or idx.size == 0:
                continue
            per_warp = 32 // slot.width if slot.width <= 32 else 1
            j = 0
            while j < idx.size:
                # A piece of n requests takes 4 + n + ceil(n / per_warp) words.
                n = min(idx.size - j, (room - 4) * per_warp // (per_warp + 1))
                while n > 0 and 4 + n + -(-n // per_warp) > room:
                    n -= 1
                if n < 1:
                    launches.append(pieces)
                    pieces, room = [], _MAX_WORDS - fixed
                    continue
                pieces.append((s, idx[j : j + n], slot.first + j * slot.width, per_warp))
                room -= 4 + n + -(-n // per_warp)
                j += n
        if pieces or not launches:
            launches.append(pieces)
        return [_params(srcs, pieces, out_address) for pieces in launches]


def _params(srcs: np.ndarray, pieces: list, out_address: int) -> np.ndarray:
    """One launch's parameter words (GatherPlan.encode)."""
    src, first, per_warp = (np.array([p[i] for p in pieces], dtype=np.int64).reshape(-1)
                            for i in (0, 2, 3))
    k = np.array([p[1].size for p in pieces], dtype=np.int64)
    indices = np.concatenate([p[1] for p in pieces] + [np.zeros(0, dtype=np.int64)])
    if indices.size and indices.max() >= _U32:
        raise ValueError(f"gather index {indices.max()} does not fit 32 bits")
    slots = np.stack([src, k, first, np.cumsum(k) - k], axis=1)
    warps = -(-k // per_warp)
    start = np.repeat(np.cumsum(warps) - warps, warps)
    j0 = (np.arange(warps.sum()) - start) * np.repeat(per_warp, warps)
    tasks = np.repeat(np.arange(len(pieces)), warps) | j0 << 16
    head = np.array([len(srcs), len(pieces), tasks.size, indices.size,
                     out_address % _U32, out_address >> 32, 0, 0], dtype=np.uint64)
    words = np.concatenate([head, srcs.reshape(-1), slots.reshape(-1).astype(np.uint64),
                            tasks.astype(np.uint64), indices.astype(np.uint64)])
    size = next(b for b in PARAM_BYTES if 4 * words.size <= b)
    out = np.zeros(size // 4, dtype=np.uint32)
    out[: words.size] = words
    return out


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
            rows = torch.from_numpy(path_rows(a, idx, b).reshape(-1)).to(src.device)
            parts.append(src.view(torch.int32)[rows].reshape(-1))
    return torch.cat(parts)


def _check_sources(plan: GatherPlan) -> None:
    for t in plan.sources:
        cuda.check_operand(t, "gather source", t.dtype)
        if t.dtype == torch.uint8 and t.data_ptr() % 4:
            raise ValueError("a level stack must start on a 4-byte boundary")


def gather(plan: GatherPlan) -> torch.Tensor:
    """All of ``plan``'s reads into one (words,) int32 tensor on the
    sources' device: K13 launches (one for a prove's plan) carrying the
    encoded plan in their parameters on a card, the plain version on the
    CPU."""
    if not plan.requests:
        raise ValueError("an empty gather plan")
    dev = plan.device
    if dev.type == "cpu":
        return gather_plain(plan)
    _check_sources(plan)
    out = torch.empty(plan.words, dtype=torch.int32, device=dev)
    for params in plan.encode(out.data_ptr()):
        QUERY_GATHER.launch(dev, params.ctypes.data, params.nbytes)
    return out


def to_host(words: torch.Tensor) -> np.ndarray:
    """A (words,) int32 tensor on the host as uint32: from a card, one copy
    into pinned memory, waited for with an event."""
    if words.device.type == "cpu":
        return words.numpy().view(np.uint32)
    host = torch.empty(words.shape, dtype=torch.int32, pin_memory=True)
    host.copy_(words, non_blocking=True)
    landed = torch.cuda.Event()
    landed.record(torch.cuda.current_stream(words.device))
    landed.synchronize()
    return host.numpy().view(np.uint32)


def fetch(plan: GatherPlan) -> np.ndarray:
    """:func:`gather`, then the buffer on the host as (words,) uint32
    (:func:`to_host`)."""
    return to_host(gather(plan))
