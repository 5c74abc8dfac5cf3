"""Merkle commitment trees.  Contract: reference src/merkle.rs:4-96.

Counterpart of stark_tpu/merkle.py.  Constructors:

* ``MerkleTree(leaves)`` — from a list of :class:`Hash` leaves, mirroring
  ``MerkleTree::new`` (merkle.rs:11-38).  Host-side.
* ``MerkleTree.from_leaf_values(values)`` / ``from_leaf_digests`` — leaf
  hashing and every level at least ``_DEVICE_MIN_WIDTH`` wide run on the
  tensor's device (ops/hash_batch) and stay there, as ``(32, w)`` uint8
  tensors in natural node order; the narrower top of the tree is built by
  the host C engine from one ~32 KB transfer, which also yields the root
  (narrow levels are launch-bound on the device).  A numpy input, or one
  narrower than the cutover, builds on the host entirely.

Authentication paths gather every device level's siblings in one indexed
read and one transfer (:meth:`open_batch`).  Level bytes equal the scalar
construction (merkle.rs:18-29: pairwise ``Hash::combine`` bottom-up, every
level kept).
"""

from __future__ import annotations

import numpy as np
import torch

from stark_tpu_torch import native
from stark_tpu_torch.hashfn import Hash
from stark_tpu_torch.ops import hash_batch as HB

# Tree levels at least this wide are built and kept on device; narrower
# levels are built on the host (stark_tpu/merkle.py:33).
_DEVICE_MIN_WIDTH = 1024


def _host_levels(leaf_bytes: np.ndarray) -> list[np.ndarray]:
    """(w, 32) u8 leaf digests -> every level as (w_l, 32) u8, leaf first."""
    return native.merkle_levels(leaf_bytes)


def _to_device(values, device) -> torch.Tensor:
    if isinstance(values, np.ndarray):
        values = torch.from_numpy(values.astype(np.int64))
    return values.to(device)


class MerkleTree:
    """``_dev_levels``: (32, w) u8 tensors, widest first, each at least
    ``_DEVICE_MIN_WIDTH`` wide (empty for host trees).  ``_top_levels``:
    (w, 32) u8 numpy levels continuing below the last device level down to
    the root."""

    def __init__(self, leaves=None, *, _dev_levels=(), _top_levels=None):
        self._dev_levels = list(_dev_levels)
        if leaves is not None:
            assert len(leaves) > 0, "Cannot create tree from empty leaves"
            n = len(leaves)
            assert n & (n - 1) == 0, "Number of leaves must be power of 2"
            arr = np.frombuffer(
                b"".join(h.data for h in leaves), dtype=np.uint8
            ).reshape(n, 32)
            self._top_levels = _host_levels(arr)
        else:
            assert _top_levels is not None
            self._top_levels = list(_top_levels)

    # -- constructors --------------------------------------------------------

    @staticmethod
    def from_leaf_values(values, device=None) -> "MerkleTree":
        """leaf_i = Hash::from_field_elements([v_i]) — the FRI codeword
        commitment (fri.rs:117-128).  ``values``: (n,) tensor or numpy of
        reduced field values.  ``device``: where to hash; by default the
        tensor's own device, or the host engine for numpy input."""
        if device is not None:
            values = _to_device(values, device)
        n = int(values.shape[0])
        assert n > 0 and n & (n - 1) == 0
        if isinstance(values, np.ndarray) or n < _DEVICE_MIN_WIDTH:
            host = (
                values if isinstance(values, np.ndarray) else values.cpu().numpy()
            )
            digests = native.hash_u64s(host.astype(np.uint64))
            return MerkleTree(_top_levels=_host_levels(digests))
        return MerkleTree._finish_device(HB.leaf_hash(values))

    @staticmethod
    def from_leaf_digests(digests, device=None) -> "MerkleTree":
        """From leaf digests: (N, 32) u8 numpy bytes or a (32, N) u8 tensor.
        ``device`` as in :meth:`from_leaf_values`."""
        if device is not None and isinstance(digests, np.ndarray):
            digests = HB.bytes_to_digests(digests, device)
        elif device is not None:
            digests = digests.to(device)
        if isinstance(digests, np.ndarray):
            return MerkleTree(_top_levels=_host_levels(digests))
        if digests.shape[1] < _DEVICE_MIN_WIDTH:
            return MerkleTree(_top_levels=_host_levels(HB.digests_to_bytes(digests)))
        return MerkleTree._finish_device(digests)

    @staticmethod
    def _finish_device(leaf_digests: torch.Tensor) -> "MerkleTree":
        dev = [leaf_digests]
        while dev[-1].shape[1] > _DEVICE_MIN_WIDTH:
            dev.append(HB.merkle_level(dev[-1]))
        top = _host_levels(HB.digests_to_bytes(dev[-1]))
        return MerkleTree(_dev_levels=dev, _top_levels=top[1:])

    # -- level access --------------------------------------------------------

    @property
    def levels(self) -> list[np.ndarray]:
        """All levels as host (w, 32) u8 bytes, leaf level first."""
        return [HB.digests_to_bytes(lv) for lv in self._dev_levels] + list(
            self._top_levels
        )

    @property
    def num_leaves(self) -> int:
        if self._dev_levels:
            return int(self._dev_levels[0].shape[1])
        return int(self._top_levels[0].shape[0])

    # -- queries (merkle.rs:40-96) -------------------------------------------

    @property
    def root(self) -> Hash:
        return Hash(self._top_levels[-1][0].tobytes())

    @staticmethod
    def commit(leaves) -> Hash:
        """Root-only build (merkle.rs:44-65)."""
        return MerkleTree(leaves).root

    def open(self, index: int) -> list[Hash]:
        """Sibling authentication path, bottom-up (merkle.rs:67-80)."""
        assert index < self.num_leaves, "Index out of bounds"
        return self.open_batch([index])[0]

    def _open_top(self, index: int) -> list[Hash]:
        proof = []
        idx = index
        for level in self._top_levels[:-1]:
            sibling = idx + 1 if idx % 2 == 0 else idx - 1
            proof.append(Hash(level[sibling].tobytes()))
            idx //= 2
        return proof

    def open_batch(self, indices: list[int]) -> list[list[Hash]]:
        """Authentication paths for many indices: the device levels' part
        in one gather and one transfer, the host top appended."""
        if not self._dev_levels:
            return [self._open_top(i) for i in indices]
        idx = torch.tensor(indices, dtype=torch.int64)
        idx = idx.to(self._dev_levels[0].device)
        sib = torch.stack(
            [lv[:, (idx >> l) ^ 1] for l, lv in enumerate(self._dev_levels)]
        )  # (L_dev, 32, k)
        sib = sib.permute(2, 0, 1).cpu().numpy()  # (k, L_dev, 32)
        shift = len(self._dev_levels)
        return [
            [Hash(sib[q, l].tobytes()) for l in range(shift)]
            + self._open_top(i >> shift)
            for q, i in enumerate(indices)
        ]

    @staticmethod
    def verify(leaf: Hash, index: int, proof: list[Hash], root: Hash) -> bool:
        """Refold by index parity (merkle.rs:82-96)."""
        return native.merkle_verify(
            leaf.data, index, [h.data for h in proof], root.data
        )
