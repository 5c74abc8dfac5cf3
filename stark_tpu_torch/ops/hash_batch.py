"""Device-vectorized commitment hash: N leaves hashed in parallel.

Counterpart of stark_tpu/ops/hash_batch.py (``leaf_hash_core`` :219,
``row_hash_core`` :246, ``combine_core`` :232, ``digests_to_bytes`` :1051),
bit-exact with the host engines in hashfn.py (reference src/hash.rs).

The 32-byte state of every lane is one stacked ``(32, N)`` uint8 tensor —
the JAX package's ``_mix_stacked`` form (:100-113) — so each hash step is
one torch op over all lanes, and uint8 wrapping IS the hash's mod-256
arithmetic:

* sbox, the 4-byte-group XOR mixing and the round constants are
  elementwise;
* the sequential in-place neighbor diffusion (hash.rs:77-81) is a prefix
  sum: new[i] = new[i-1] + s[i] + s[i+1] telescopes to a uint8 cumsum of
  v[0] = s[0]+s[1]+s[31], v[i] = s[i]+s[i+1], with new[31] =
  s[31] + new[0] + new[30] appended;
* the absorb (hash.rs:14-23) updates byte i and then XORs it into byte
  i+7, so byte i depends only on steps i-7 and earlier: runs of 7 bytes
  are independent and go as one slice op each (5 runs per 32-byte chunk
  instead of 32 steps).

These are plain torch ops on the card too; hand kernels for the hash
(the leaf, row and combine digests and the Merkle levels) are later work.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from stark_tpu_torch.hashfn import PRIMES, ROUND_CONSTANTS


@functools.lru_cache(maxsize=8)
def _constants(device: torch.device) -> tuple:
    """(initial state (32,), round constants (32, 1)) u8 on ``device``,
    uploaded once: a host-to-device copy per mix would stall the stream."""
    return (
        torch.from_numpy(np.tile(PRIMES, 2)).to(device),
        torch.from_numpy(ROUND_CONSTANTS).to(device)[:, None],
    )


def _rotl8(x: torch.Tensor, n: int) -> torch.Tensor:
    return (x << n) | (x >> (8 - n))


def _mix(s: torch.Tensor) -> torch.Tensor:
    """One mix round (hash.rs:59-86) on a stacked (32, N) u8 state."""
    x = _rotl8(s * 251, 1) ^ 0x63
    t0, t1, t2, t3 = x.reshape((8, 4) + x.shape[1:]).unbind(1)
    g = torch.stack(
        [t0 ^ t1 ^ t3, t0 ^ t2 ^ t3, t0 ^ t1 ^ t2, t1 ^ t2 ^ t3], dim=1
    ).reshape(x.shape)
    v = g + torch.roll(g, -1, dims=0)
    v[0] += g[31]
    c = torch.cumsum(v, dim=0, dtype=torch.uint8)
    last = g[31] + c[0] + c[30]
    rc = _constants(s.device)[1]
    return torch.cat([c[:31], last[None]], dim=0) + rc


def _init_state(n: int, device) -> torch.Tensor:
    return _constants(device)[0][:, None].expand(32, n).clone()


def _absorb(s: torch.Tensor, chunk: torch.Tensor) -> torch.Tensor:
    """Absorb one <= 32-byte chunk ((k, N) u8) into the state, in place."""
    k = chunk.shape[0]
    for i in range(0, k, 7):
        e = min(i + 7, k)
        v = _rotl8(s[i:e] + chunk[i:e], 3)
        s[i:e] = v
        # XOR targets i+7 .. e+6 (mod 32): at most one wrap.
        lo, hi = i + 7, e + 7
        if hi <= 32:
            s[lo:hi] ^= v
        else:
            cut = max(32 - lo, 0)
            s[lo:32] ^= v[:cut]
            s[lo + cut - 32 : hi - 32] ^= v[cut:]
    return s


def _hash_chunks(data: torch.Tensor, final_mixes: int = 8) -> torch.Tensor:
    """(L, N) u8 messages (one per lane) -> (32, N) digests: absorb each
    32-byte chunk with a mix after it, then the final mixes (hash.rs:7-30)."""
    s = _init_state(data.shape[1], data.device)
    for start in range(0, data.shape[0], 32):
        s = _mix(_absorb(s, data[start : start + 32]))
    for _ in range(final_mixes):
        s = _mix(s)
    return s


def _value_bytes(values: torch.Tensor) -> torch.Tensor:
    """(c, N) field values (< 2^32) -> (8c, N) u8: each as a LE u64."""
    c, n = values.shape
    v = values.long()
    out = torch.zeros((c, 8, n), dtype=torch.uint8, device=values.device)
    for b in range(4):
        out[:, b] = ((v >> (8 * b)) & 0xFF).to(torch.uint8)
    return out.reshape(8 * c, n)


def row_hash(values: torch.Tensor) -> torch.Tensor:
    """(c, N) field values -> (32, N) digests:
    Hash::from_field_elements(row) per lane (hash.rs:7-35), the row's c
    values as 8c LE bytes.  For c = 1 this is the per-value leaf hash."""
    return _hash_chunks(_value_bytes(values))


def leaf_hash(values: torch.Tensor) -> torch.Tensor:
    """(N,) field values -> (32, N) digests: Hash::from_field_elements(&[v])."""
    return row_hash(values[None, :])


def combine(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """(32, N) x (32, N) -> (32, N): Hash::combine per lane (hash.rs:41-46),
    the 64-byte input left || right."""
    return _hash_chunks(torch.cat([left, right], dim=0))


def merkle_level(nodes: torch.Tensor) -> torch.Tensor:
    """(32, W) node digests -> (32, W/2) parents (pairwise combine)."""
    return combine(nodes[:, 0::2], nodes[:, 1::2])


def digests_to_bytes(digests: torch.Tensor) -> np.ndarray:
    """(32, N) u8 digest tensor -> (N, 32) u8 host array."""
    return np.ascontiguousarray(digests.cpu().numpy().T)


def bytes_to_digests(arr: np.ndarray, device="cpu") -> torch.Tensor:
    """(N, 32) u8 host array -> (32, N) u8 digest tensor on ``device``."""
    return torch.from_numpy(np.ascontiguousarray(arr.T)).to(device)
