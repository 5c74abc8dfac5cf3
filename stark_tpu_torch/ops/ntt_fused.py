"""Four-step NTT on the card: kernels K1-K3 (csrc/ntt.cu), their plan
tables, and the plain PyTorch version of each.

Counterpart of stark_tpu/ops/ntt_fused.py.  With n = n1 * n2 (n1 = 2^(lg//2),
n2 >= n1), input index n2*i1 + i2 and output index k1 + n1*k2:

    X[k1 + n1*k2] = sum_{i2} w^{i2*k1} * w2^{i2*k2}
                        * ( sum_{i1} x[n2*i1 + i2] * w1^{i1*k1} )

with w1 = w^{n2}, w2 = w^{n1}.  The transform runs as

    K1 ntt_pass1      column NTTs of length n1 on the (n1, n2) view, times
                      the inter-pass twiddle w^{k1*i2} (1/n folded in for
                      the inverse), natural row order;
    K3 ntt_transpose  (n1, n2) -> (n2, n1);
    K2 ntt_pass2      column NTTs of length n2; the (n2, n1) row-major
                      result is the transform in natural order.

Each wrapper takes a ``(B, rows, cols)`` int32 batch: on a CUDA tensor it
launches its kernel (or raises), on a CPU tensor it runs its plain version
(int64 torch ops).  There is no size gate: every power of two n >= 4 takes
the kernels on the card.  :func:`ntt_plain`, a radix-2 Stockham, is the
plain version of the whole chain.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from stark_tpu_torch.ops import cuda
from stark_tpu_torch.ops import fieldops as F
from stark_tpu_torch.ops.fieldops import P, primitive_nth_root

#: Column-tile budget of one block, in elements (64 KB of shared memory):
#: a pass over columns of length 2^lg_r takes 2^14 / 2^lg_r of them at once.
_SMEM_ELEMS = 1 << 14

_SRC = "stark_tpu_torch/csrc/ntt.cu"
PASS1 = cuda.Kernel(
    "ntt_pass1", "stark_ntt_pass1", [cuda.ptr] * 5 + [cuda.i32] * 4,
    source=_SRC, replaces="stark_tpu/ops/ntt_fused.py:383",
)
TRANSPOSE = cuda.Kernel(
    "ntt_transpose", "stark_ntt_transpose", [cuda.ptr] * 2 + [cuda.i32] * 3,
    source=_SRC, replaces="stark_tpu/ops/ntt_fused.py:345",
)
PASS2 = cuda.Kernel(
    "ntt_pass2", "stark_ntt_pass2", [cuda.ptr] * 4 + [cuda.i32] * 4,
    source=_SRC, replaces="stark_tpu/ops/ntt_fused.py:409",
)


def _root(n: int, inverse: bool) -> int:
    w = primitive_nth_root(n)
    return pow(w, P - 2, P) if inverse else w


# ---------------------------------------------------------------------------
# Radix-2 Stockham (plain version of the whole transform).
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def stockham_twiddles(n: int, inverse: bool) -> tuple:
    """Stage t of a length-n Stockham uses w^(j * n/2^(t+1)), j < 2^t
    (numpy uint32 per stage; shared with the host engine in ntt.py)."""
    pow_table = F.host_powers(_root(n, inverse), n)
    lg = n.bit_length() - 1
    return tuple(
        pow_table[:: n >> (t + 1)][: 1 << t].copy() for t in range(lg)
    )


@functools.lru_cache(maxsize=32)
def _stockham_tables(n: int, inverse: bool, device: torch.device) -> tuple:
    return tuple(
        torch.from_numpy(w.astype(np.int64)).to(device)[:, None]
        for w in stockham_twiddles(n, inverse)
    )


def _stockham(x: torch.Tensor, n: int, inverse: bool) -> torch.Tensor:
    """(..., n) int64 -> (..., n) int64 length-n transform along the last
    axis, natural order, WITHOUT the inverse's 1/n.  Stage invariant: the
    array is (L, r) with L = 2^t and X_t[j, q] the L-point transform of
    a[q::r]; column q (even) merges with column q + r/2 (odd)."""
    batch = x.shape[:-1]
    x = x.reshape(batch + (1, n))
    for w in _stockham_tables(n, inverse, x.device):
        half = x.shape[-1] // 2
        even, odd = x[..., :half], x[..., half:]
        tw = odd * w % P
        x = torch.cat([(even + tw) % P, (even - tw) % P], dim=-2)
    return x.reshape(batch + (n,))


def ntt_plain(x: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """(..., n) int32 in [0, p) -> (..., n) int32 (i)NTT, natural order."""
    n = x.shape[-1]
    y = _stockham(x.long(), n, inverse)
    if inverse:
        y = y * F.host_inv(n) % P
    return y.to(torch.int32)


# ---------------------------------------------------------------------------
# Plan tables.
# ---------------------------------------------------------------------------

def _shoup_pair(w: torch.Tensor):
    """int64 constants < p -> (int32 values, int32 Shoup companions)."""
    return w.to(torch.int32), F.u32_to_i32((w << 32) // P)


class FusedNTTPlan:
    """Device tables for one (n, inverse) four-step transform.

    ``tw1``/``tw2``: the first half of the powers of the column roots
    w1 = w^{n2} and w2 = w^{n1} (stage s of a length-m DIF multiplies by
    tw[j << s], j < m / 2^(s+1)), with Shoup companions.  The JAX plan
    stores the same values as dense (rows, stages) tables for Mosaic;
    tw[j << s] is its entry [m/2^(s+1) + j, s].  ``wm``: the (n1, n2)
    inter-pass twiddle scale * w^(k1*i2) * 2^32 mod p (Montgomery form,
    scale = 1/n for the inverse), in NATURAL row order — the JAX table is
    the same one with rows bit-reversed, because its pass 1 writes rows
    in bit-reversed order and this one does not."""

    def __init__(self, n: int, inverse: bool, device):
        if n < 4 or n & (n - 1):
            raise ValueError(f"NTT size must be a power of two >= 4, got {n}")
        lg = n.bit_length() - 1
        self.n, self.inverse = n, inverse
        self.lg1, self.lg2 = lg // 2, lg - lg // 2
        self.n1, self.n2 = 1 << self.lg1, 1 << self.lg2
        omega = _root(n, inverse)
        self.tw1, self.tw1_shoup = _shoup_pair(
            F.powers(pow(omega, self.n2, P), self.n1 // 2, device=device)
        )
        self.tw2, self.tw2_shoup = _shoup_pair(
            F.powers(pow(omega, self.n1, P), self.n2 // 2, device=device)
        )
        # Column doubling: wm[:, m:2m] = wm[:, :m] * (w^k1)^m.
        scale = F.host_inv(n) if inverse else 1
        step = F.powers(omega, self.n1, device=device)
        wm = torch.full(
            (self.n1, 1), scale * F.R1 % P, dtype=torch.int64, device=device
        )
        while wm.shape[1] < self.n2:
            wm = torch.cat([wm, wm * step[:, None] % P], dim=1)
            step = step * step % P
        self.wm = wm.to(torch.int32).contiguous()


@functools.lru_cache(maxsize=32)
def get_plan(n: int, inverse: bool, device: torch.device) -> FusedNTTPlan:
    return FusedNTTPlan(n, inverse, device)


# ---------------------------------------------------------------------------
# Plain versions of the three kernels (int64 torch ops).
# ---------------------------------------------------------------------------

def _col_ntt(x3: torch.Tensor, inverse: bool) -> torch.Tensor:
    """(B, r, c) -> int64 length-r transforms down each column, no 1/r
    (root primitive_nth_root(r) = w^(n/r), the pass's column root)."""
    r = x3.shape[1]
    return _stockham(x3.long().transpose(1, 2), r, inverse).transpose(1, 2)


def pass1_plain(x3: torch.Tensor, plan: FusedNTTPlan) -> torch.Tensor:
    y = _col_ntt(x3, plan.inverse)
    return (y * plan.wm.long() % P * F.R_INV % P).to(torch.int32)


def transpose_plain(y3: torch.Tensor) -> torch.Tensor:
    return y3.transpose(1, 2).contiguous()


def pass2_plain(y3: torch.Tensor, plan: FusedNTTPlan) -> torch.Tensor:
    return _col_ntt(y3, plan.inverse).to(torch.int32)


# ---------------------------------------------------------------------------
# Kernel wrappers.
# ---------------------------------------------------------------------------

def _lg_tile(lg_r: int, cols: int) -> int:
    tc = min(cols, max(1, _SMEM_ELEMS >> lg_r))
    return tc.bit_length() - 1


def _check_batch(x3: torch.Tensor, rows: int, cols: int) -> None:
    if x3.dim() != 3 or tuple(x3.shape[1:]) != (rows, cols):
        raise ValueError(f"expected (B, {rows}, {cols}), got {tuple(x3.shape)}")


def ntt_pass1(x3: torch.Tensor, plan: FusedNTTPlan) -> torch.Tensor:
    """K1 on a (B, n1, n2) int32 batch."""
    _check_batch(x3, plan.n1, plan.n2)
    if x3.device.type == "cpu":
        return pass1_plain(x3, plan)
    cuda.check_operand(x3, "x")
    out = torch.empty_like(x3)
    PASS1.launch(
        x3.device, x3.data_ptr(), out.data_ptr(), plan.tw1.data_ptr(),
        plan.tw1_shoup.data_ptr(), plan.wm.data_ptr(), x3.shape[0],
        plan.lg1, plan.n2, _lg_tile(plan.lg1, plan.n2),
    )
    return out


def ntt_transpose(y3: torch.Tensor) -> torch.Tensor:
    """K3: (B, r, c) int32 -> (B, c, r)."""
    if y3.dim() != 3:
        raise ValueError(f"expected (B, rows, cols), got {tuple(y3.shape)}")
    if y3.device.type == "cpu":
        return transpose_plain(y3)
    cuda.check_operand(y3, "y")
    b, r, c = y3.shape
    out = torch.empty((b, c, r), dtype=y3.dtype, device=y3.device)
    TRANSPOSE.launch(y3.device, y3.data_ptr(), out.data_ptr(), b, r, c)
    return out


def ntt_pass2(y3: torch.Tensor, plan: FusedNTTPlan) -> torch.Tensor:
    """K2 on a (B, n2, n1) int32 batch."""
    _check_batch(y3, plan.n2, plan.n1)
    if y3.device.type == "cpu":
        return pass2_plain(y3, plan)
    cuda.check_operand(y3, "y")
    out = torch.empty_like(y3)
    PASS2.launch(
        y3.device, y3.data_ptr(), out.data_ptr(), plan.tw2.data_ptr(),
        plan.tw2_shoup.data_ptr(), y3.shape[0], plan.lg2, plan.n1,
        _lg_tile(plan.lg2, plan.n1),
    )
    return out


def fused_ntt(x: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """(..., n) int32 in [0, p) -> (..., n) int32 (i)NTT, natural order,
    through K1 -> K3 -> K2 (their plain versions on the CPU).  Same
    contract as stark_tpu's ops/ntt.ntt / intt."""
    if x.dtype != torch.int32:
        raise ValueError(f"expected int32 field values, got {x.dtype}")
    plan = get_plan(x.shape[-1], inverse, x.device)
    x3 = x.reshape(-1, plan.n1, plan.n2).contiguous()
    z = ntt_pass2(ntt_transpose(ntt_pass1(x3, plan)), plan)
    return z.reshape(x.shape)
