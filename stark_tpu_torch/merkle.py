"""Merkle commitment trees.  Contract: reference src/merkle.rs:4-96.

Counterpart of stark_tpu/merkle.py.  A tree is one **level stack**
(ops/hash_batch): a ``(2W - 1, 32)`` uint8 tensor with the W leaf digests
first, then each level above, the root last - level bytes equal the scalar
construction (merkle.rs:18-29: pairwise ``Hash::combine`` bottom-up, every
level kept).  Constructors:

* ``MerkleTree(leaves)`` - from a list of :class:`Hash` leaves, mirroring
  ``MerkleTree::new`` (merkle.rs:11-38).  Host engine.
* ``MerkleTree.from_leaf_values(values)`` / ``from_rows`` /
  ``from_leaf_digests`` - for a tensor of any width, the leaf hash (kernel
  K5/K6) writes straight into the stack on the tensor's device and K7/K8
  build every level to the root there; the host reads back 32 bytes.  A
  numpy input builds in the host C engine, and its stack is a CPU tensor.

A :class:`Forest` is B trees of one width side by side, as the batched
prover commits B proofs at once (stark_tpu/batch.py:BatchedTrees): one
level stack of ``2 B n - B`` rows that stops at the B roots
(ops/hash_batch).

Authentication paths are one gather over the stack and one transfer
(:meth:`open_batch`, rows from :func:`path_rows`), whichever engine built
it; the prover's query phase gathers them with its values in one launch
(ops/gather.py).
"""

from __future__ import annotations

import numpy as np
import torch

from stark_tpu_torch import native
from stark_tpu_torch.hashfn import Hash
from stark_tpu_torch.ops import hash_batch as HB

def _host_stack(leaf_bytes: np.ndarray) -> torch.Tensor:
    """(w, 32) u8 leaf digests -> the level stack, by the C engine."""
    levels = native.merkle_levels(leaf_bytes)
    return torch.from_numpy(np.concatenate(levels, axis=0))


def _to_device(values, device) -> torch.Tensor:
    if isinstance(values, np.ndarray):
        values = torch.from_numpy(values.astype(np.int64)).to(torch.int32)
    return values if device is None else values.to(device)


def path_rows(num_leaves: int, indices, depth: int | None = None) -> np.ndarray:
    """(k, depth) int64 rows of a level stack that hold the authentication
    paths of leaves ``indices``, bottom-up: the sibling on level l of leaf
    i is row ``level_offset(l) + ((i >> l) ^ 1)``, level_offset(l) =
    2W - 2W / 2^l.  ``depth`` defaults to log2 W (a tree); a forest of
    trees of width 2^depth stops there, and leaf i of tree b is its leaf
    b 2^depth + i.  (stark_tpu/merkle.py's gather_operands and
    open_batch_dev, stark_tpu/batch.py's open_batch_dev serve its
    layouts; every tree and forest of the port is one stack.)"""
    if depth is None:
        depth = num_leaves.bit_length() - 1
    idx = np.asarray(indices, dtype=np.int64).reshape(-1, 1)
    lv = np.arange(depth, dtype=np.int64)[None, :]
    return (2 * num_leaves - ((2 * num_leaves) >> lv)) + ((idx >> lv) ^ 1)


def paths_from_sib(sib: np.ndarray) -> list[list[Hash]]:
    """(k, depth, 32) u8 fetched sibling digests -> k paths of Hash
    objects (stark_tpu/merkle.py:paths_from_dev, query-major)."""
    return [[Hash(row.tobytes()) for row in path] for path in sib]


class MerkleTree:
    """``_stack``: the (2W - 1, 32) u8 level stack, on the device that built
    it."""

    def __init__(self, leaves=None, *, _stack: torch.Tensor | None = None):
        if leaves is not None:
            assert len(leaves) > 0, "Cannot create tree from empty leaves"
            n = len(leaves)
            assert n & (n - 1) == 0, "Number of leaves must be power of 2"
            arr = np.frombuffer(
                b"".join(h.data for h in leaves), dtype=np.uint8
            ).reshape(n, 32)
            _stack = _host_stack(arr)
        assert _stack is not None
        self._stack = _stack
        self.num_leaves = (int(_stack.shape[0]) + 1) // 2

    # -- constructors --------------------------------------------------------

    @staticmethod
    def from_rows(values, device=None) -> "MerkleTree":
        """leaf_i = Hash::from_field_elements(column i) of the (c, n)
        ``values`` (tensor or numpy of reduced field values) - the trace
        commitment.  ``device``: where to hash; by default the tensor's own
        device, or the host engine for numpy input."""
        if device is not None:
            values = _to_device(values, device)
        n = int(values.shape[1])
        assert n > 0 and n & (n - 1) == 0
        if isinstance(values, np.ndarray):
            if values.shape[0] == 1:
                digests = native.hash_u64s(values[0].astype(np.uint64))
            else:
                # The C engine hashes single values only: host rows go
                # through the row hash's plain version.
                digests = HB.digests_to_bytes(HB.hash_rows(_to_device(values, None)))
            return MerkleTree(_stack=_host_stack(digests))
        stack = torch.empty((2 * n - 1, 32), dtype=torch.uint8, device=values.device)
        HB.hash_rows(values, stack[:n])
        return MerkleTree(_stack=HB.merkle_build(stack))

    @staticmethod
    def from_leaf_values(values, device=None) -> "MerkleTree":
        """leaf_i = Hash::from_field_elements([v_i]) - the FRI codeword
        commitment (fri.rs:117-128).  ``values``: (n,) tensor or numpy;
        ``device`` as in :meth:`from_rows`."""
        return MerkleTree.from_rows(values[None, :], device)

    @staticmethod
    def from_leaf_digests(digests, device=None) -> "MerkleTree":
        """From (N, 32) u8 leaf digests, numpy bytes or a tensor.
        ``device`` as in :meth:`from_rows`."""
        if device is not None and isinstance(digests, np.ndarray):
            digests = HB.bytes_to_digests(digests, device)
        elif device is not None:
            digests = digests.to(device)
        if isinstance(digests, np.ndarray):
            return MerkleTree(_stack=_host_stack(digests))
        n = int(digests.shape[0])
        assert n > 0 and n & (n - 1) == 0
        stack = torch.empty((2 * n - 1, 32), dtype=torch.uint8, device=digests.device)
        stack[:n] = digests
        return MerkleTree(_stack=HB.merkle_build(stack))

    # -- level access --------------------------------------------------------

    @property
    def levels(self) -> list[np.ndarray]:
        """All levels as host (w, 32) u8 bytes, leaf level first."""
        host = HB.digests_to_bytes(self._stack)
        n = self.num_leaves
        return [
            host[HB.level_offset(n, l) : HB.level_offset(n, l + 1)]
            for l in range(n.bit_length())
        ]

    # -- queries (merkle.rs:40-96) -------------------------------------------

    @property
    def root(self) -> Hash:
        return Hash(self._stack[-1].cpu().numpy().tobytes())

    def leaf(self, index: int) -> Hash:
        """Leaf ``index``'s digest (the stack's leaf level is in natural
        order; a negative index counts from the end, as a list's does)."""
        n = self.num_leaves
        if not -n <= index < n:
            raise IndexError(f"leaf {index} of {n}")
        return Hash(self._stack[index % n].cpu().numpy().tobytes())

    @staticmethod
    def commit(leaves) -> Hash:
        """Root-only build (merkle.rs:44-65)."""
        return MerkleTree(leaves).root

    def open(self, index: int) -> list[Hash]:
        """Sibling authentication path, bottom-up (merkle.rs:67-80)."""
        assert index < self.num_leaves, "Index out of bounds"
        return self.open_batch([index])[0]

    def open_batch(self, indices: list[int]) -> list[list[Hash]]:
        """Authentication paths for many indices: one gather over the level
        stack (:func:`path_rows`) and one transfer."""
        rows = path_rows(self.num_leaves, indices)
        sib = self._stack[torch.from_numpy(rows.reshape(-1)).to(self._stack.device)]
        return paths_from_sib(sib.cpu().numpy().reshape(*rows.shape, 32))

    @staticmethod
    def verify(leaf: Hash, index: int, proof: list[Hash], root: Hash) -> bool:
        """Refold by index parity (merkle.rs:82-96)."""
        return native.merkle_verify(
            leaf.data, index, [h.data for h in proof], root.data
        )


class Forest:
    """B trees of width n side by side (stark_tpu/batch.py:BatchedTrees,
    :141-190): ``stack`` is the (2 B n - B, 32) u8 level stack of one tree
    of width B n stopped at the B roots, on the device that built it.
    Tree b's leaves are the stack's rows b n .. (b + 1) n - 1, and the
    path of its leaf i is that of leaf b n + i (:meth:`global_index`,
    ``GatherPlan.paths(stack, ..., depth)``)."""

    def __init__(self, stack: torch.Tensor, trees: int):
        self.stack = stack
        self.B = trees
        self.n = (int(stack.shape[0]) + trees) // (2 * trees)
        self.depth = self.n.bit_length() - 1

    @staticmethod
    def from_rows(values: torch.Tensor) -> "Forest":
        """(B, c, n) field values -> tree b's leaf j =
        Hash::from_field_elements(values[b, :, j]) (the trace forest)."""
        b, c, n = values.shape
        if n < 1 or n & (n - 1):
            raise ValueError(f"a forest's trees need a power-of-two width, got {n}")
        lanes = values.permute(1, 0, 2).reshape(c, b * n)
        stack = torch.empty((2 * b * n - b, 32), dtype=torch.uint8, device=values.device)
        HB.hash_rows(lanes.contiguous(), stack[: b * n])
        return Forest(HB.forest_build(stack, b), b)

    @staticmethod
    def from_values(values: torch.Tensor) -> "Forest":
        """(B, n) field values -> tree b's leaf i = Hash::from_field_elements(
        [values[b, i]]) (a FRI round's codewords)."""
        return Forest.from_rows(values[:, None, :])

    def roots_dev(self) -> torch.Tensor:
        """(B, 32) u8 roots, a view of the stack's last rows."""
        return self.stack[-self.B :]

    def global_index(self, indices) -> np.ndarray:
        """(B, k) per-tree leaf indices -> (B, k) leaves of the stack."""
        idx = np.asarray(indices, dtype=np.int64).reshape(self.B, -1)
        return idx + self.n * np.arange(self.B, dtype=np.int64)[:, None]

    def tree(self, b: int) -> MerkleTree:
        """Tree b on its own (a copy of its nodes: tests and checks)."""
        w = self.B * self.n
        rows = [self.stack[HB.level_offset(w, l) + b * (self.n >> l):][: self.n >> l]
                for l in range(self.depth + 1)]
        return MerkleTree(_stack=torch.cat(rows))
