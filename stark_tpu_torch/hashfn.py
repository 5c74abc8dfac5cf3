"""The commitment hash: a byte-oriented 256-bit non-cryptographic hash.

Bit-exact reimplementation of the reference hash (src/hash.rs:7-99) on the
host, in two engines:

* **native C** (:mod:`stark_tpu_torch.native`) — ``hash_bytes``, used for
  the Fiat-Shamir transcript and index sampling;
* **numpy** (:func:`hash_bytes_np`) — the compiler-free cross-check the
  tests hold the C engine against.

The device engine (many leaves at once) is :mod:`stark_tpu_torch.ops.hash_batch`.

Reference algorithm (hash.rs):
  state[32] seeded by cycling the first 16 primes (hash.rs:10-12,53);
  absorb 32-byte chunks — per byte i at pos=i: wrapping add, rotl 3,
  XOR into pos+7 mod 32 (hash.rs:14-23); after each chunk plus 8 final
  rounds, `mix_state` (hash.rs:25-27,59-86): per-byte sbox
  (mul 251, rotl 1, xor 0x63), XOR mixing in 4-byte groups, wrapping
  neighbor diffusion (sequential in-place — equivalent to a prefix sum),
  and round-constant addition.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from stark_tpu_torch import native

PRIMES = np.array(
    [2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43, 47, 53], dtype=np.uint8
)

ROUND_CONSTANTS = np.array(
    [
        0x01, 0x02, 0x04, 0x08, 0x10, 0x20, 0x40, 0x80,
        0x1B, 0x36, 0x6C, 0xD8, 0xAB, 0x4D, 0x9A, 0x2F,
        0x5E, 0xBC, 0x63, 0xC6, 0x97, 0x35, 0x6A, 0xD4,
        0xB3, 0x7D, 0xFA, 0xEF, 0xC5, 0x91, 0x39, 0x72,
    ],
    dtype=np.uint8,
)

_INIT_STATE = np.tile(PRIMES, 2)  # 32 bytes: primes cycled (hash.rs:10-12)


def _rotl8(x: np.ndarray, n: int) -> np.ndarray:
    return ((x << np.uint8(n)) | (x >> np.uint8(8 - n))).astype(np.uint8)


def _mix_state(state: np.ndarray) -> np.ndarray:
    """One mix round on a 32-byte state (hash.rs:59-86)."""
    s = _rotl8(state * np.uint8(251), 1) ^ np.uint8(0x63)  # sbox, hash.rs:88-94
    g = s.reshape(8, 4)
    t0, t1, t2, t3 = g[:, 0], g[:, 1], g[:, 2], g[:, 3]
    s = np.stack([t0 ^ t1 ^ t3, t0 ^ t2 ^ t3, t0 ^ t1 ^ t2, t1 ^ t2 ^ t3], axis=1)
    s = s.reshape(32)
    # Neighbor diffusion (hash.rs:77-81) as a prefix sum:
    #   d[0] = old0 + old1 + old31,  d[i] = old_i + old_{i+1}  (1 <= i <= 30)
    # and new31 = old31 + new0 + new30.
    old = s.astype(np.int32)
    d = np.empty(31, dtype=np.int32)
    d[0] = old[0] + old[1] + old[31]
    d[1:] = old[1:31] + old[2:32]
    new = np.cumsum(d)
    out = np.empty(32, dtype=np.int32)
    out[:31] = new
    out[31] = old[31] + new[0] + new[30]
    return ((out + ROUND_CONSTANTS) & 0xFF).astype(np.uint8)


def hash_bytes_np(data: bytes) -> bytes:
    """32-byte digest; bit-exact contract with hash.rs:7-30 (numpy engine)."""
    state = _INIT_STATE.copy()
    buf = np.frombuffer(data, dtype=np.uint8)
    for start in range(0, len(buf), 32):
        chunk = buf[start : start + 32]
        for i in range(len(chunk)):
            v = (int(state[i]) + int(chunk[i])) & 0xFF
            v = ((v << 3) | (v >> 5)) & 0xFF  # rotl 3
            state[i] = v
            state[(i + 7) % 32] ^= np.uint8(v)
        state = _mix_state(state)
    for _ in range(8):
        state = _mix_state(state)
    return state.tobytes()


hash_bytes = native.hash_bytes


@dataclass(frozen=True)
class Hash:
    """A 32-byte digest.  API contract: hash.rs:2-51."""

    data: bytes

    def __post_init__(self):
        assert len(self.data) == 32

    @staticmethod
    def from_bytes(b: bytes) -> "Hash":
        return Hash(hash_bytes(b))

    @staticmethod
    def from_field_elements(values) -> "Hash":
        # LE u64 concat (hash.rs:32-35); accepts raw (possibly unreduced) u64s.
        b = b"".join(int(v).to_bytes(8, "little") for v in values)
        return Hash(hash_bytes(b))

    @staticmethod
    def from_u64(value: int) -> "Hash":
        return Hash(hash_bytes(int(value).to_bytes(8, "little")))

    @staticmethod
    def combine(left: "Hash", right: "Hash") -> "Hash":
        return Hash(hash_bytes(left.data + right.data))

    def to_hex(self) -> str:
        return self.data.hex()
