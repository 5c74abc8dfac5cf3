"""State carried between the JAX package's numpy world and the port's tensors.

There are no weights: a proof is fixed by the AIR, the config and the
witness, and both packages derive their NTT plans and domain tables from
the config.  What crosses over:

* the witness — numpy ``(T, c)`` rows or ``(c, T)`` columns (uint32, or
  any integers, reduced mod p as the reference's trace.rs:29-34 cast-then-
  reduce does) <-> the port's ``(c, T)`` int32 device tensor;
* field vectors — int32 tensors <-> numpy uint32;
* proofs — bytes, identical in both packages, <-> numpy u8.

Digests cross with ``ops.hash_batch.digests_to_bytes`` / ``bytes_to_digests``:
the port's ``(32, N)`` u8 tensors <-> numpy ``(N, 32)`` bytes, the layout of
stark_tpu's host levels.
"""

from __future__ import annotations

import numpy as np
import torch

from stark_tpu_torch.ops.fieldops import P


def witness_to_device(trace, device, *, rows: bool = True) -> torch.Tensor:
    """(T, c) rows (``rows=True``) or (c, T) columns -> (c, T) int32
    tensor on ``device``, reduced mod p."""
    arr = np.asarray(trace)
    if arr.dtype != np.uint32:
        arr = np.asarray(trace, dtype=np.uint64) % np.uint64(P)
    cols = arr.T if rows else arr
    cols = np.ascontiguousarray(cols % P, dtype=np.uint32)
    return torch.from_numpy(cols.view(np.int32)).to(device)


def witness_to_numpy(cols: torch.Tensor, *, rows: bool = True) -> np.ndarray:
    """(c, T) int32 tensor -> uint32 numpy (T, c) rows or (c, T) columns."""
    host = field_to_numpy(cols)
    return np.ascontiguousarray(host.T) if rows else host


def field_to_numpy(values: torch.Tensor) -> np.ndarray:
    """int32 (or int64) tensor of values in [0, p) -> numpy uint32."""
    return values.cpu().numpy().astype(np.uint32)


def proof_to_numpy(proof: bytes) -> np.ndarray:
    return np.frombuffer(proof, dtype=np.uint8).copy()


def proof_from_numpy(arr: np.ndarray) -> bytes:
    return np.ascontiguousarray(arr, dtype=np.uint8).tobytes()
