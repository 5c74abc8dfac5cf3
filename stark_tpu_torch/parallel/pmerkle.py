"""Sharded Merkle commitments and the sharded query gather.

Counterpart of stark_tpu/parallel/pmerkle.py.  With a tree's n leaves cut
contiguously over D ranks, every pair (2i, 2i + 1) below the level of
width D lies inside one rank's share: each rank hashes its leaves (K5/K6)
and builds its share's subtree (K7, K8; B trees at once, K8-forest) up to
its root with no communication.  Only the narrow top crosses ranks: one
all-gather of the D share roots (32 bytes each), and every rank builds the
top of width D (K8, K8-forest) itself, so every rank holds the root.  The
level bytes equal the single-device tree's, so roots, paths and proof
bytes do not change with D.  A path is the owning rank's local levels,
then the replicated top.

Floor: a rank's share must hold at least :data:`MIN_LOCAL` leaves; a
narrower tree is built whole on every rank from the gathered values (a
layout change: the same bytes).  (stark_tpu's floor, 2 * 128 * D, is a TPU
lane-tile fact.)

The query phase's gather over such data takes one of two forms.
:class:`ShardedRulePlan` is the single-fetch prove's (stark_tpu's mesh
prover, stark_tpu/parallel/pstark.py:64-87): an ops/gather.RulePlan of
this rank's share, its sources a round's cut or whole codeword and its
ShardedForest or whole forest, its indices the card's (K10's); K13 runs
every request on every rank, the rank that serves it reading its share and
the others writing zeros, and one sum over the ranks (Mesh.all_reduce)
leaves the whole gather, identical on every rank, in the prove's one
buffer.  :class:`ShardedGather` is the same requests with host indices
(ops/gather.GatherPlan on sharded arrays, the two- and three-read paths):
each rank runs K13 over the requests whose indices it serves, and one
all-gather of the packed results, read from the card once, gives every
rank the whole.
"""

from __future__ import annotations

import numpy as np
import torch

from stark_tpu_torch.merkle import Forest, MerkleTree
from stark_tpu_torch.ops import gather as G
from stark_tpu_torch.ops import hash_batch as HB
from stark_tpu_torch.parallel.mesh import Mesh, Shard, swap_blocks

#: Leaves a rank's share of a tree holds at the least (below: whole trees).
MIN_LOCAL = 4


class ShardedForest:
    """B trees of width n over the mesh: ``local``, this rank's share of
    each tree (leaves [d n/D, (d+1) n/D)) as a :class:`Forest` of B trees
    of width n/D, and ``top``, the B trees of width D over the shares'
    roots, which every rank holds.  The interface of Forest: ``stack``
    (this object, which :class:`ShardedGather` reads), ``roots_dev``,
    ``global_index``, ``depth``."""

    def __init__(self, mesh: Mesh, local: Forest, top: Forest):
        self.mesh, self.local, self.top = mesh, local, top
        self.B = local.B
        self.n = local.n * mesh.size
        self.depth = self.n.bit_length() - 1

    @property
    def stack(self) -> "ShardedForest":
        return self

    def roots_dev(self) -> torch.Tensor:
        """(B, 32) u8 roots on this rank's device (replicated)."""
        return self.top.roots_dev()

    def global_index(self, indices) -> np.ndarray:
        """(B, k) per-tree leaf indices -> (B, k) leaves of the forest."""
        idx = np.asarray(indices, dtype=np.int64).reshape(self.B, -1)
        return idx + self.n * np.arange(self.B, dtype=np.int64)[:, None]

    def tree(self, b: int) -> MerkleTree:
        """Tree b whole, on every rank (gathers every share: tests)."""
        m = self.local.n
        levels = []
        shares = self.mesh.all_gather(self.local.tree(b)._stack)   # (D, 2m - 1, 32)
        for lv in range(self.local.depth + 1):
            off = HB.level_offset(m, lv)
            levels.append(shares[:, off : off + (m >> lv)].reshape(-1, 32))
        top = self.top.tree(b)._stack
        return MerkleTree(_stack=torch.cat(levels + [top[self.mesh.size:]]))


def _top(mesh: Mesh, roots: torch.Tensor) -> Forest:
    """The B trees of width D over the shares' (B, 32) roots: one
    all-gather, then every rank builds them (K8 / K8-forest)."""
    b, d = int(roots.shape[0]), mesh.size
    got = mesh.all_gather(roots.contiguous().view(torch.int32))     # (D, B, 8)
    leaves = swap_blocks(got, 1, d, b, 8).reshape(b * d, 8).view(torch.uint8)
    stack = torch.empty((2 * b * d - b, 32), dtype=torch.uint8, device=roots.device)
    stack[: b * d] = leaves
    return Forest(HB.forest_build(stack, b), b)


def sharded_forest(values: Shard) -> ShardedForest | Forest:
    """Tree b's leaf j = Hash::from_field_elements(values[b, :, j]) of a
    (B, c, n) array cut over the mesh: a :class:`ShardedForest`, or below
    the floor (or for a whole array) a Forest built on every rank."""
    mesh = values.mesh
    if values.split and values.m < MIN_LOCAL:
        values = Shard(mesh, values.whole(), values.n, split=False)
    if not values.split:
        return Forest.from_rows(values.local)
    local = Forest.from_rows(values.local)
    return ShardedForest(mesh, local, _top(mesh, local.roots_dev()))


def sharded_tree_from_values(values: torch.Tensor, mesh: Mesh) -> ShardedForest | Forest:
    """Tree over leaf_i = Hash::from_field_elements([v_i]) (fri.rs:117-128):
    ``values`` is this rank's (n/D,) share."""
    n = values.shape[-1] * mesh.size
    return sharded_forest(Shard(mesh, values[None, None, :], n))


def sharded_tree_from_rows(rows: torch.Tensor, mesh: Mesh) -> ShardedForest | Forest:
    """Tree over leaf_j = Hash::from_field_elements(rows[:, j]), the trace
    commitment: ``rows`` is this rank's (c, n/D) share."""
    n = rows.shape[-1] * mesh.size
    return sharded_forest(Shard(mesh, rows[None], n))


class ShardedRulePlan(G.RulePlan):
    """ops/gather.RulePlan of this rank's share of ``mesh``: a source is
    declared whole or ``split`` (a :class:`~stark_tpu_torch.parallel.mesh.
    Shard`'s share, a :class:`ShardedForest`), and bound as the Shard or
    the ShardedForest itself (or a whole forest's stack, a tensor);
    :meth:`run` is K13 over every request (zeros where another rank serves
    it), then one :meth:`Mesh.all_reduce` that sums the ranks' outputs into
    the whole gather on every rank."""

    def __init__(self, mesh: Mesh):
        super().__init__(mesh.rank, mesh.size)
        self.mesh = mesh

    def bind(self, sources: list) -> list:
        tensors = []
        for s in sources:
            if isinstance(s, Shard):
                s = s.local
            elif isinstance(s, ShardedForest):
                s = (s.local.stack, s.top.stack)
            tensors.append(s)
        return super().bind(tensors)

    def run(self, sources: list, idx: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
        """This rank's share of the gather into ``out``, then the combine:
        ``out`` holds the whole on every rank."""
        super().run(sources, idx, out)
        return self.mesh.all_reduce(out)


class ShardedGather:
    """ops/gather.GatherPlan's requests over the mesh: :meth:`values` of a
    :class:`~stark_tpu_torch.parallel.mesh.Shard`, :meth:`paths` of a
    :class:`ShardedForest` or of a whole forest's level stack; then
    :meth:`fetch`.  Every rank builds the same requests (the control plane
    is replicated); a request's indices are served by the ranks
    ``Shard.locate`` names, each rank's own through K13, in one launch."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        # (slot, serving rank per index, parts: (source, local index per
        # index, depth, first word within an index's words, words))
        self.requests: list = []
        self.words = 0

    def _add(self, kind: int, k: int, width: int, owner: np.ndarray, parts: list) -> G.Slot:
        slot = G.Slot(kind, self.words, k, width)
        self.requests.append((slot, owner, parts))
        self.words += slot.words
        return slot

    def values(self, src: Shard, indices) -> G.Slot:
        """The values at global ``indices`` of a (c, n) or flat (B n,)
        shard: a (k, c) slot."""
        idx = np.ascontiguousarray(indices, dtype=np.int64).reshape(-1)
        if idx.size and (idx.min() < 0 or idx.max() >= src.shape[-1]):
            raise IndexError(f"gather index out of range [0, {src.shape[-1]})")
        owner, local = src.locate(idx)
        c = 1 if src.local.dim() == 1 else int(src.local.shape[0])
        return self._add(G.VALUES, idx.size, c, owner, [(src.local, local, None, 0, c)])

    def paths(self, stack, indices, depth: int | None = None) -> G.Slot:
        """The authentication paths of forest leaves ``indices`` (leaf i of
        tree b is b 2^depth + i): of a ShardedForest, the owner's local
        levels then the top; of a whole forest's (2 B n - B, 32) level
        stack, its levels.  A (k, depth, 32) slot."""
        idx = np.ascontiguousarray(indices, dtype=np.int64).reshape(-1)
        d = self.mesh.size
        if isinstance(stack, ShardedForest):
            depth = stack.depth
            n, m = stack.n, stack.local.n
            b, i = idx >> depth, idx & (n - 1)
            owner = self.mesh.owner(i, n)
            dl, dt = stack.local.depth, stack.top.depth
            parts = [(stack.local.stack, b * m + i - owner * m, dl, 0, 8 * dl),
                     (stack.top.stack, b * d + owner, dt, 8 * dl, 8 * dt)]
        else:
            if depth is None:
                depth = ((int(stack.shape[0]) + 1) // 2).bit_length() - 1
            n = 1 << depth
            owner = self.mesh.owner(idx & (n - 1), n)
            parts = [(stack, idx, depth, 0, 8 * depth)]
        return self._add(G.PATHS, idx.size, 8 * depth, owner, parts)

    def fetch(self) -> np.ndarray:
        """Every request's words on the host as (words,) uint32, on every
        rank: this rank's share through K13 (ops/gather.gather), the shares
        packed side by side by one all-gather, one read from the card."""
        mesh, me = self.mesh, self.mesh.rank
        plan = G.GatherPlan()
        maps: list[list[np.ndarray]] = [[] for _ in range(mesh.size)]
        for slot, owner, parts in self.requests:
            for e in range(mesh.size):
                sel = np.flatnonzero(owner == e)
                if not sel.size:
                    continue
                for src, local, depth, off, width in parts:
                    if not width:
                        continue
                    first = slot.first + sel * slot.width + off
                    maps[e].append((first[:, None] + np.arange(width)).reshape(-1))
                    if e != me:
                        continue
                    if slot.kind == G.VALUES:
                        plan.values(src, local[sel])
                    else:
                        plan.paths(src, local[sel], depth)
        sizes = [sum(a.size for a in part) for part in maps]
        buf = torch.zeros(max(max(sizes), 1), dtype=torch.int32, device=mesh.device)
        if sizes[me]:
            buf[: sizes[me]] = G.gather(plan)
        host = G.to_host(mesh.all_gather(buf).reshape(-1)).reshape(mesh.size, -1)
        out = np.zeros(self.words, dtype=np.uint32)
        for e, part in enumerate(maps):
            if part:
                out[np.concatenate(part)] = host[e, : sizes[e]]
        return out
