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

A :class:`RulePlan` is the same gather for indices that lie on the card:
each request's index follows a :class:`Rule` from a (rows, number) index
buffer (the FRI query indices kernel K10 writes), so the plan carries no
index and depends only on the shapes: it is built once per shape and
bound to a prove's tensors at each launch (the single-fetch prove,
stark_tpu/fri.py:_prove_chained).  :class:`Packed` is the one buffer such
a prove's kernels write into and :func:`to_host` brings back, at once or
(``wait=False``) as a copy in flight.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

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
        srcs = _source_words(self.sources, self._meta)
        if self.words >= _U32:
            raise ValueError(f"{self.words} output words do not fit 32 bits")
        return _encode(srcs, self.requests, out_address)


def _source_words(tensors, meta) -> np.ndarray:
    """The sources' words (address, a, kind << 31 | b), one row each."""
    srcs = np.zeros((len(meta), 4), dtype=np.uint64)
    for i, (t, (kind, a, b)) in enumerate(zip(tensors, meta)):
        if not (0 < a < _U32 and 0 <= b < 1 << 31):
            raise ValueError(f"gather source {i}: ({a}, {b}) does not fit 32 bits")
        ptr = 0 if t is None else t.data_ptr()
        srcs[i] = (ptr % _U32, ptr >> 32, a, kind << 31 | b)
    return srcs


def _encode(srcs: np.ndarray, requests: list, out_address: int,
            idx_address: int = 0) -> list[np.ndarray]:
    """The launches' parameter words for ``requests`` ((source, indices or
    :class:`Rule`, slot) each): GatherPlan.encode, with a rule slot's
    payload its rule's words where an index slot's is its indices."""
    n_src = len(srcs)
    fixed = HEADER_WORDS + 4 * n_src
    if fixed + 6 > _MAX_WORDS:
        raise ValueError(f"{n_src} gather sources: a launch holds at most "
                         f"{(_MAX_WORDS - HEADER_WORDS - 6) // 4}")
    launches, pieces, room = [], [], _MAX_WORDS - fixed
    for s, what, slot in requests:
        rule = isinstance(what, Rule)
        total = what.k if rule else what.size
        if slot.width == 0 or total == 0:
            continue
        per_warp = 32 // slot.width if slot.width <= 32 else 1
        j = 0
        while j < total:
            if rule:
                # A piece of n requests takes 4 + its rule's words + ceil(n / per_warp).
                n = min(total - j, max(room - 4 - what.payload_words, 0) * per_warp)
            else:
                # A piece of n requests takes 4 + n + ceil(n / per_warp) words.
                n = min(total - j, (room - 4) * per_warp // (per_warp + 1))
                while n > 0 and 4 + n + -(-n // per_warp) > room:
                    n -= 1
            n = min(n, 1 << 16)  # a task's first request has 16 bits
            if n < 1:
                launches.append(pieces)
                pieces, room = [], _MAX_WORDS - fixed
                continue
            payload = what.words(j, slot.width) if rule else what[j : j + n]
            step = (what.out_stride or slot.width) if rule else slot.width
            pieces.append((s | rule << 31, payload, slot.first + j * step, per_warp, n))
            room -= 4 + payload.size + -(-n // per_warp)
            j += n
    if pieces or not launches:
        launches.append(pieces)
    return [_params(srcs, pieces, out_address, idx_address) for pieces in launches]


def _params(srcs: np.ndarray, pieces: list, out_address: int,
            idx_address: int = 0) -> np.ndarray:
    """One launch's parameter words (GatherPlan.encode)."""
    src, first, per_warp, k = (np.array([p[i] for p in pieces], dtype=np.int64).reshape(-1)
                               for i in (0, 2, 3, 4))
    size = np.array([p[1].size for p in pieces], dtype=np.int64)
    payload = np.concatenate([p[1] for p in pieces] + [np.zeros(0, dtype=np.int64)])
    if payload.size and payload.max() >= _U32:
        raise ValueError(f"gather index {payload.max()} does not fit 32 bits")
    slots = np.stack([src, k, first, np.cumsum(size) - size], axis=1)
    warps = -(-k // per_warp)
    start = np.repeat(np.cumsum(warps) - warps, warps)
    j0 = (np.arange(warps.sum()) - start) * np.repeat(per_warp, warps)
    tasks = np.repeat(np.arange(len(pieces)), warps) | j0 << 16
    head = np.array([len(srcs), len(pieces), tasks.size, payload.size,
                     out_address % _U32, out_address >> 32,
                     idx_address % _U32, idx_address >> 32], dtype=np.uint64)
    words = np.concatenate([head, srcs.reshape(-1), slots.reshape(-1).astype(np.uint64),
                            tasks.astype(np.uint64), payload.astype(np.uint64)])
    size = next(b for b in PARAM_BYTES if 4 * words.size <= b)
    out = np.zeros(size // 4, dtype=np.uint32)
    out[: words.size] = words
    return out


def _pow2(n: int) -> bool:
    return n > 0 and n & (n - 1) == 0


@dataclass(frozen=True)
class Rule:
    """The indices of one request slot of a :class:`RulePlan`, from a
    (rows, number) index buffer: request j of the slot, j = ((row h + e)
    number + q) F + u (``order`` 0) or ((row number + q) h + e) F + u
    (``order`` 1), F = len(offsets), is at the point

        x = ((idx[row, q] mod half) + e half + offsets[u]) mod wrap

    of its row (``wrap`` 0: no wrap) and reads index

        ((x - lo) >> shift) + row stride.

    ``half`` and ``wrap`` are powers of two.  The FRI round of n points
    reads a = idx mod n/2 and a + n/2 (h = 2) of each proof's (B, n)
    codeword, stride n, and a of the next round's; a trace opening reads
    (q + k blowup) mod N for q in {a, a + N/2} (order 1),
    stark_tpu/stark.py:_dev_cols_idx.

    The rest is a rank's share (:class:`RulePlan` fills it in): of an axis
    of ``points`` points over ``ranks`` ranks, the request is served by the
    rank (x ranks) >> log2 points (parallel/mesh.Shard.locate's rule) and
    every other rank writes zeros in its words; ``lo`` and ``shift`` take x
    to the share's own index, and a request's words lie ``out_stride``
    words apart in the output (0: the width of a request's words)."""

    rows: int
    number: int
    half: int
    h: int = 1
    offsets: tuple = (0,)
    wrap: int = 0
    stride: int = 0
    order: int = 0
    rank: int = 0
    ranks: int = 1
    points: int = _U32
    lo: int = 0
    shift: int = 0
    out_stride: int = 0

    def __post_init__(self):
        if not (self.rows >= 1 and self.number >= 1 and _pow2(self.half)
                and (self.wrap == 0 or _pow2(self.wrap)) and 1 <= self.h < 256
                and 1 <= len(self.offsets) < 256 and self.order in (0, 1)
                and 0 <= self.stride < _U32 and self.half < _U32 and self.wrap <= _U32
                and all(0 <= o < _U32 for o in self.offsets)
                and _pow2(self.ranks) and self.ranks <= 128 and 0 <= self.rank < self.ranks
                and _pow2(self.points) and self.points <= _U32
                and 0 <= self.lo < _U32 and 0 <= self.shift < 32
                and 0 <= self.out_stride < _U32):
            raise ValueError(f"a rule out of range: {self}")

    @property
    def k(self) -> int:
        """The slot's requests."""
        return self.rows * self.number * self.h * len(self.offsets)

    @property
    def payload_words(self) -> int:
        return 9 + len(self.offsets)

    def words(self, j_start: int, width: int) -> np.ndarray:
        """The rule's payload words (csrc/gather.cu) for a piece of the slot
        from request ``j_start`` on, whose requests are ``width`` words."""
        shape = self.h | len(self.offsets) << 8 | self.order << 16
        wrap = self.wrap - 1 if self.wrap else _U32 - 1
        own = (self.rank | (self.ranks.bit_length() - 1) << 8
               | (self.points.bit_length() - 1) << 16 | self.shift << 24)
        return np.array([j_start, self.number, shape, self.half - 1, wrap, self.stride,
                         own, self.lo, self.out_stride or width, *self.offsets],
                        dtype=np.int64)

    def point_rows(self, idx: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(rows, number) indices -> each request's (x, row), (k,) int64
        each, in order (torch ops on ``idx``'s device: the plain
        version's)."""
        dev = idx.device
        a = idx.long().reshape(self.rows, self.number) % self.half
        e = torch.arange(self.h, dtype=torch.int64, device=dev) * self.half
        off = torch.tensor(self.offsets, dtype=torch.int64, device=dev)
        rows = torch.arange(self.rows, dtype=torch.int64, device=dev)
        if self.order == 0:
            x = a[:, None, :, None] + e[None, :, None, None] + off
        else:
            x = a[:, :, None, None] + e[None, None, :, None] + off
        if self.wrap:
            x = x % self.wrap
        return x.reshape(-1), rows[:, None, None, None].expand(x.shape).reshape(-1)

    def owned(self, x: torch.Tensor) -> torch.Tensor:
        """Whether this rank serves the requests at points ``x``."""
        return (x * self.ranks) // self.points == self.rank


class RulePlan:
    """A gather plan whose requests take their indices from an index buffer
    through :class:`Rule` s: it depends only on shapes, so a prover builds it
    once per shape.  :meth:`values_source` and :meth:`stack_source` declare
    each source by its shape (a (..., n) int32 array read as (c, n) rows,
    or a level stack of trees of width 2^depth); :meth:`values` and
    :meth:`paths` add a slot each, in the output's order; :meth:`run` binds
    tensors of those shapes and gathers into a given buffer.

    A plan of rank ``rank`` of a mesh of ``size`` (parallel/pmerkle.
    ShardedRulePlan) gathers that rank's share: a source is declared whole
    (every rank holds it) or ``split``, the rank holding the points [rank
    m, (rank + 1) m), m = points / size, of each row (parallel/mesh.Shard);
    a split stack is a tree cut so (parallel/pmerkle.ShardedForest), bound
    as the pair (the rank's forest of its shares, the top forest over the
    shares' roots), and a path through it is its owner's local levels, then
    the top.  Each request is served by one rank (:class:`Rule`), the
    others write zeros, so the sum of the ranks' outputs is the whole."""

    def __init__(self, rank: int = 0, size: int = 1):
        if not (_pow2(size) and 0 <= rank < size):
            raise ValueError(f"rank {rank} of a mesh of {size}")
        self.rank, self.size = rank, size
        self.specs: list[tuple[tuple, torch.dtype]] = []
        self._meta: list[tuple[int, int, int]] = []
        # Per declared source: (kind, points a row or tree, split, first spec).
        self._decl: list[tuple[int, int, bool, int]] = []
        self.requests: list[tuple[int, Rule, Slot]] = []
        self.words = 0
        self._templates: list[np.ndarray] | None = None

    def _spec(self, shape, dtype, meta) -> None:
        self.specs.append((tuple(shape), dtype))
        self._meta.append(meta)

    def _share(self, points: int) -> int:
        if points % self.size:
            raise ValueError(f"an axis of {points} points does not split over {self.size} ranks")
        return points // self.size

    def values_source(self, shape, n: int, c: int = 1, split: bool = False) -> int:
        """A source read as c rows of n int32 values (a request's index
        may pass n: row r of element i is word r n + i), whose points run
        along the last axis of ``shape``; ``split``: this rank's share of
        that axis.  Its id."""
        shape, points = tuple(shape), int(shape[-1])
        if split:
            m = self._share(points)
            shape, n = shape[:-1] + (m,), n // self.size
        self._decl.append((VALUES, points, split, len(self.specs)))
        self._spec(shape, torch.int32, (VALUES, n, c))
        return len(self._decl) - 1

    def stack_source(self, width: int, depth: int, split: bool = False) -> int:
        """A level stack of width / 2^depth trees of 2^depth leaves (a
        tree or a forest, merkle.py); ``split``: cut over the mesh, this
        rank's forest of its shares of the trees and the top forest.  Its
        id."""
        trees, points = width >> depth, 1 << depth
        self._decl.append((PATHS, points, split, len(self.specs)))
        if not split:
            self._spec((2 * width - trees, 32), torch.uint8, (PATHS, width, depth))
        else:
            m = self._share(points)
            top = trees * self.size
            self._spec((2 * trees * m - trees, 32), torch.uint8,
                       (PATHS, trees * m, m.bit_length() - 1))
            self._spec((2 * top - trees, 32), torch.uint8,
                       (PATHS, top, self.size.bit_length() - 1))
        return len(self._decl) - 1

    def _add(self, src: int, kind: int, rule: Rule) -> Slot:
        d_kind, points, split, spec = self._decl[src]
        if d_kind != kind:
            raise ValueError(f"source {src} is not a {('values', 'paths')[kind]} source")
        self._templates = None
        mine = dict(rank=self.rank, ranks=self.size, points=points)
        m = self._share(points) if split else points
        if split and rule.stride % self.size:
            raise ValueError(f"a row stride of {rule.stride} over {self.size} ranks")
        local = replace(rule, **mine, lo=self.rank * m, stride=rule.stride // self.size) \
            if split else replace(rule, **mine)
        if kind == VALUES or not split:
            slot = Slot(kind, self.words, rule.k, (1, 8)[kind] * self._meta[spec][2])
            self.requests.append((spec, local, slot))
        else:
            # The owner's local levels, then the top's: leaf x >> log2 m of
            # its row's trees there.
            dl, dt = self._meta[spec][2], self._meta[spec + 1][2]
            slot = Slot(kind, self.words, rule.k, 8 * (dl + dt))
            self.requests += [
                (spec, replace(local, out_stride=slot.width),
                 Slot(kind, slot.first, rule.k, 8 * dl)),
                (spec + 1, replace(rule, **mine, shift=dl, stride=rule.stride // m,
                                   out_stride=slot.width),
                 Slot(kind, slot.first + 8 * dl, rule.k, 8 * dt))]
        self.words += slot.words
        return slot

    def values(self, src: int, rule: Rule) -> Slot:
        """The values of source ``src`` at ``rule``'s indices: a (k, c) slot."""
        return self._add(src, VALUES, rule)

    def paths(self, src: int, rule: Rule) -> Slot:
        """The authentication paths of ``rule``'s leaves of stack ``src``: a
        (k, depth, 32) slot."""
        return self._add(src, PATHS, rule)

    def bind(self, sources: list) -> list:
        """The tensors of ``sources`` (bound in the order declared; a split
        stack as its pair), one a spec."""
        if len(sources) != len(self._decl):
            raise ValueError(f"{len(self._decl)} sources declared, {len(sources)} bound")
        out = []
        for t, (kind, _, split, _) in zip(sources, self._decl):
            out += list(t) if kind == PATHS and split else [t]
        return out

    def _check(self, tensors: list, idx: torch.Tensor, out: torch.Tensor) -> None:
        for i, (t, (shape, dtype)) in enumerate(zip(tensors, self.specs)):
            if tuple(t.shape) != shape or t.dtype != dtype or t.device != out.device \
                    or not t.is_contiguous():
                raise ValueError(f"source {i}: {tuple(t.shape)} {t.dtype} on {t.device}, "
                                 f"declared {shape} {dtype} on {out.device}")
        if idx.dtype != torch.int32 or idx.device != out.device or not idx.is_contiguous():
            raise ValueError(f"indices: contiguous int32 on {out.device}")
        if tuple(out.shape) != (self.words,) or out.dtype != torch.int32:
            raise ValueError(f"out must be ({self.words},) int32, got {tuple(out.shape)}")
        for _, rule, _ in self.requests:
            if idx.numel() < rule.rows * rule.number:
                raise ValueError(f"{idx.numel()} indices, a rule reads {rule.rows} rows "
                                 f"of {rule.number}")

    def encode(self, sources: list, idx_address: int, out_address: int) -> list[np.ndarray]:
        """The launches' parameter words (csrc/gather.cu), as GatherPlan.encode:
        the plan's structure is encoded once and only the addresses (the
        output, the index buffer, each source's) are written at each call.
        ``sources``: as :meth:`run` binds them."""
        if self._templates is None:
            if self.words >= _U32:
                raise ValueError(f"{self.words} output words do not fit 32 bits")
            self._templates = _encode(_source_words([None] * len(self._meta), self._meta),
                                      self.requests, 0)
        srcs = _source_words(self.bind(sources), self._meta)
        out = []
        for template in self._templates:
            params = template.copy()
            params[4:8] = (out_address % _U32, out_address >> 32,
                           idx_address % _U32, idx_address >> 32)
            params[HEADER_WORDS : HEADER_WORDS + srcs.size] = srcs.reshape(-1)
            out.append(params)
        return out

    def run(self, sources: list, idx: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
        """Gather into ``out`` ((words,) int32): ``sources`` bound in the
        order they were declared, ``idx`` the (rows, number) int32 index
        buffer.  K13 launches on a card (the rule slots read ``idx`` there),
        the plain version on the CPU."""
        tensors = self.bind(sources)
        self._check(tensors, idx, out)
        if out.device.type == "cpu":
            out.copy_(rules_plain(self, sources, idx))
            return out
        for t in (*tensors, idx, out):
            cuda.check_operand(t, "gather operand", t.dtype)
        for params in self.encode(sources, idx.data_ptr(), out.data_ptr()):
            QUERY_GATHER.launch(out.device, params.ctypes.data, params.nbytes)
        return out


def rules_plain(plan: RulePlan, sources: list, idx: torch.Tensor) -> torch.Tensor:
    """A RulePlan's plain version: each rule expanded by torch ops on
    ``idx``'s device, then torch indexing, zeros where another rank serves
    the request: the (words,) int32 buffer the kernel writes."""
    tensors = plan.bind(sources)
    out = torch.zeros(plan.words, dtype=torch.int32, device=idx.device)
    for s, rule, slot in plan.requests:
        src, (kind, a, b) = tensors[s], plan._meta[s]
        if slot.width == 0:
            continue
        x, row = rule.point_rows(idx)
        mine = rule.owned(x)
        i = torch.where(mine, ((x - rule.lo) >> rule.shift) + row * rule.stride, 0)
        lv = torch.arange(b, dtype=torch.int64, device=idx.device)
        if kind == VALUES:
            got = src.reshape(-1)[i[:, None] + a * lv]
        else:
            rows = (2 * a - ((2 * a) >> lv)) + ((i[:, None] >> lv) ^ 1)
            got = src.view(torch.int32)[rows].reshape(slot.k, slot.width)
        got = torch.where(mine[:, None], got, 0)
        step = rule.out_stride or slot.width
        at = (slot.first + step * torch.arange(slot.k, device=idx.device)[:, None]
              + torch.arange(slot.width, device=idx.device))
        out[at.reshape(-1)] = got.reshape(-1)
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


class Pending:
    """A copy to the host in flight (:func:`to_host` with ``wait=False``):
    :meth:`wait` blocks until it has landed and returns the words."""

    def __init__(self, host: torch.Tensor, landed):
        self._host, self._landed = host, landed

    def wait(self) -> np.ndarray:
        if self._landed is not None:
            self._landed.synchronize()
        return self._host.numpy().view(np.uint32)


def to_host(words: torch.Tensor, wait: bool = True, into: torch.Tensor | None = None):
    """A (words,) int32 tensor on the host as uint32: from a card, one copy
    into pinned memory of its own (or ``into``, a host tensor of the same
    shape: pinned, for a card's copy to run behind the host), waited for
    with an event.  ``wait`` False: the copy is only issued, and a
    :class:`Pending` returned (the prover's pipeline waits for it after it
    has launched more work).  The words returned are views of the host
    buffer."""
    if into is not None and (into.shape != words.shape or into.dtype != torch.int32
                             or into.device.type != "cpu"):
        raise ValueError(f"into must be a host {tuple(words.shape)} int32 tensor")
    if words.device.type == "cpu":
        if into is not None:
            words = into.copy_(words)
        pending = Pending(words, None)
    else:
        host = into if into is not None else torch.empty(words.shape, dtype=torch.int32,
                                                         pin_memory=True)
        host.copy_(words, non_blocking=True)
        landed = torch.cuda.Event()
        landed.record(torch.cuda.current_stream(words.device))
        pending = Pending(host, landed)
    return pending.wait() if wait else pending


class Packed:
    """One (words,) int32 buffer on a device, cut into named sections, for
    one read: kernels write into the sections (:attr:`dev`, views of the
    buffer), :func:`to_host` brings the whole buffer back in one copy, and
    :meth:`host` cuts the words it returns the same way."""

    def __init__(self, sizes: dict, device):
        self.sizes = {k: int(v) for k, v in sizes.items()}
        self.buf = torch.empty(sum(self.sizes.values()), dtype=torch.int32, device=device)
        self.dev = dict(zip(self.sizes, torch.split(self.buf, list(self.sizes.values()))))

    def host(self, words: np.ndarray) -> dict:
        """The sections of the fetched (words,) uint32 buffer."""
        ends = np.cumsum(list(self.sizes.values()))
        return dict(zip(self.sizes, np.split(words, ends[:-1])))


def fetch(plan: GatherPlan) -> np.ndarray:
    """:func:`gather`, then the buffer on the host as (words,) uint32
    (:func:`to_host`)."""
    return to_host(gather(plan))
