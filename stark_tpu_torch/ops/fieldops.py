"""Prime-field arithmetic over F_p, p = 998244353 = 119*2^23 + 1, on torch
tensors.

Plain torch ops hold every value in ``torch.int64``: inputs are in
[0, p) and p < 2^30, so a product stays below 2^60 and ``%`` reduces it
exactly.  (CPU torch has almost no ``uint32`` arithmetic, and int64 needs
no Montgomery or Shoup tricks.)  The CUDA kernels store field vectors as
``torch.int32`` and treat them as uint32 inside (csrc/field.cuh); every
function here accepts either dtype and returns int64.

The reference's *unreduced* u64 values (Fiat-Shamir challenges, see
src/fiat_shamir.rs:19-25 and src/ff.rs:113-118) may exceed 2^63 and so
never enter a tensor: they stay Python ints and are reduced mod p first.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

P = 998244353  # 119 * 2^23 + 1, 2-adicity 23, generator g = 3 (ff.rs:191-197)
GENERATOR = 3
TWO_ADICITY = 23

R1 = (1 << 32) % P            # 2^32 mod p  (Montgomery R mod p)
R_INV = pow(1 << 32, P - 2, P)  # 2^-32 mod p (undoes one REDC factor)


def _i64(a):
    return a.long() if isinstance(a, torch.Tensor) else a


def addmod(a, b):
    """(a + b) mod p for a, b in [0, p)."""
    s = _i64(a) + _i64(b)
    return torch.where(s >= P, s - P, s)


def submod(a, b):
    """(a - b) mod p for a, b in [0, p)."""
    d = _i64(a) - _i64(b)
    return torch.where(d < 0, d + P, d)


def negmod(a):
    """(-a) mod p for a in [0, p)."""
    a = _i64(a)
    return torch.where(a == 0, a, P - a)


def mulmod(a, b):
    """(a * b) mod p for a, b in [0, p): the product is below 2^60."""
    return _i64(a) * _i64(b) % P


def powmod(a, e: int):
    """a^e mod p elementwise, e a Python int >= 0 (LSB-first ladder,
    exp(0, 0) = 1 as in ff.rs:200-213)."""
    a = _i64(a)
    e = int(e)
    acc = torch.ones_like(a)
    base = a
    while e > 0:
        if e & 1:
            acc = mulmod(acc, base)
        e >>= 1
        if e:
            base = mulmod(base, base)
    return acc


def invmod(a):
    """a^{-1} mod p elementwise via Fermat (a^{p-2}).

    For a != 0 this is ff.rs:169-178; inv(0) is undefined there (the
    reference panics) and returns 0 here, as on the TPU (PARITY row 2)."""
    return powmod(a, P - 2)


# ---------------------------------------------------------------------------
# Host-side exact scalar helpers (Python ints / numpy — the control plane).
# ---------------------------------------------------------------------------

def host_inv(v: int, p: int = P) -> int:
    return pow(v % p, p - 2, p)


@functools.lru_cache(maxsize=64)
def primitive_nth_root(n: int, p: int = P) -> int:
    """w_n = g^((p-1)/n); contract: ff.rs:215-223 (n a power of two <= 2^23)."""
    assert n & (n - 1) == 0, "n must be a power of two"
    assert n <= (1 << TWO_ADICITY), "n > 2^23 not supported by this modulus"
    return pow(GENERATOR, (p - 1) // n, p)


def host_powers(base: int, n: int, scale: int = 1, p: int = P) -> np.ndarray:
    """[scale * base^i mod p for i in range(n)] as numpy uint32."""
    base %= p
    scale %= p
    out = np.array([scale], dtype=np.uint64)
    step = base
    while len(out) < n:
        out = np.concatenate([out, (out * np.uint64(step)) % np.uint64(p)])
        step = (step * step) % p
    return out[:n].astype(np.uint32)


def shoup_precompute(w):
    """Companion w' = floor(w * 2^32 / p) for Shoup multiplication by the
    constant w in [0, p) (numpy uint32; the CUDA kernels' operand)."""
    w = np.asarray(w, dtype=np.uint64)
    return ((w << np.uint64(32)) // np.uint64(P)).astype(np.uint32)


def powers(base: int, n: int, scale: int = 1, device="cpu") -> torch.Tensor:
    """(n,) int64 tensor of scale * base^i mod p, built on ``device`` by
    log-doubling (about log2 n ops, no host transfer)."""
    base %= P
    out = torch.full((1,), scale % P, dtype=torch.int64, device=device)
    step = base
    while out.shape[0] < n:
        out = torch.cat([out, out * step % P])
        step = step * step % P
    return out[:n]


def u32_to_i32(t: torch.Tensor) -> torch.Tensor:
    """int64 tensor of u32 values -> int32 storage of the same bits (the
    kernels' operand type; companions of Shoup constants exceed 2^31)."""
    return torch.where(t >= 1 << 31, t - (1 << 32), t).to(torch.int32)
