"""FRI fold on the card: kernels K4 and K4-dyn (csrc/fold.cu) and their
plain versions.

Counterpart of stark_tpu/ops/pallas_kernels.py:fold_pallas, the same math as
stark_tpu/fri.py:_fold_kernel (reference src/fri.rs:57-91 re-algorithmized):

    folded[i] = 2^-1 * ((a + b) + alpha * x_i^-1 * (a - b))  mod p,
    a = codeword[i], b = codeword[i + half],

with x_i^-1 = (offset * omega^i)^-1 precomputed per round in Montgomery form
(fri.FriPlan.inv_x_mont).  K4 (``fold``) takes the raw challenge ``alpha``
as a Python int up to 2^64: it is reduced mod p before it reaches a tensor
or the kernel.  K4-dyn (``fold_dyn``) is one round of the device commit
chain for B codewords in one launch: it absorbs each row's Merkle root into
that row's Fiat-Shamir sponge (ops/hash_batch.Sponge), draws the challenge
mod p and folds the row with it - stark_tpu/fri.py:_fold_kernel_dynamic
with the root absorb and challenge of the JAX package's fused round
(fri.py:_commit_round_fn, batch.py:_batch_round_fn).
"""

from __future__ import annotations

import ctypes

import torch

from stark_tpu_torch.ops import cuda
from stark_tpu_torch.ops import fieldops as F
from stark_tpu_torch.ops import hash_batch as HB
from stark_tpu_torch.ops.fieldops import P

INV2 = F.host_inv(2)
INV2_SHOUP = int(F.shoup_precompute(INV2))

FOLD = cuda.Kernel(
    "fri_fold", "stark_fri_fold",
    [cuda.ptr] * 3 + [ctypes.c_longlong] + [ctypes.c_uint] * 4,
    source="stark_tpu_torch/csrc/fold.cu",
    replaces="stark_tpu/ops/pallas_kernels.py:104",
)
FOLD_DYN = cuda.Kernel(
    "fri_fold_dyn", "stark_fri_fold_dyn",
    [cuda.ptr] * 6 + [cuda.i32] * 2 + [cuda.ptr] * 4 + [ctypes.c_longlong] + [cuda.i32] * 2
    + [ctypes.c_uint] * 2,
    source="stark_tpu_torch/csrc/fold.cu",
    replaces="stark_tpu/fri.py:85",
)


def fold_plain(codeword: torch.Tensor, inv_x_mont: torch.Tensor,
               alpha: int) -> torch.Tensor:
    """int64 torch ops on the same operands (REDC by x^-1 * R = times
    x^-1 * R * R^-1)."""
    half = codeword.shape[0] // 2
    a, b = codeword[:half].long(), codeword[half:].long()
    s = (a + b) % P
    d = (a - b) % P
    inv_x = inv_x_mont.long() * F.R_INV % P
    u = inv_x * (alpha % P) % P * d % P
    return ((s + u) % P * INV2 % P).to(torch.int32)


def fold(codeword: torch.Tensor, inv_x_mont: torch.Tensor,
         alpha: int) -> torch.Tensor:
    """(n,) int32 codeword -> (n/2,) int32 folded codeword; ``alpha`` the
    raw (possibly unreduced) u64 challenge."""
    n = codeword.shape[0]
    if codeword.dim() != 1 or n < 2 or n % 2:
        raise ValueError(f"expected an even-length 1-D codeword, got {tuple(codeword.shape)}")
    if tuple(inv_x_mont.shape) != (n // 2,):
        raise ValueError("inverse-x ladder must have length n/2")
    if codeword.device.type == "cpu":
        return fold_plain(codeword, inv_x_mont, alpha)
    cuda.check_operand(codeword, "codeword")
    cuda.check_operand(inv_x_mont, "inv_x_mont")
    a_red = alpha % P
    out = torch.empty(n // 2, dtype=torch.int32, device=codeword.device)
    FOLD.launch(
        codeword.device, codeword.data_ptr(), inv_x_mont.data_ptr(),
        out.data_ptr(), n // 2, a_red, int(F.shoup_precompute(a_red)),
        INV2, INV2_SHOUP,
    )
    return out


def fold_dyn_plain(codewords: torch.Tensor, inv_x_mont: torch.Tensor,
                   alpha: torch.Tensor) -> torch.Tensor:
    """int64 torch ops: row b folded with alpha[b] (reduced), as
    _fold_kernel_dynamic computes it: mont_mul(inv_x_mont, alpha) = alpha /
    x, a full product by (a - b), then the halving."""
    half = codewords.shape[1] // 2
    a, b = codewords[:, :half].long(), codewords[:, half:].long()
    s = (a + b) % P
    d = (a - b) % P
    t = inv_x_mont.long()[None, :] * alpha.long()[:, None] % P * F.R_INV % P
    return ((s + t * d % P) % P * INV2 % P).to(torch.int32)


def fold_dyn_round_plain(codewords: torch.Tensor, inv_x_mont: torch.Tensor,
                         state: torch.Tensor, pending: torch.Tensor, q: int,
                         roots: torch.Tensor, fresh: bool = False):
    """K4-dyn's plain version: K9's plain absorb of each row's root
    (hash_batch.sponge_absorb_plain), then fold_dyn_plain with the
    challenge it draws.  Returns (state, pending, alpha, folded): the
    sponges after the roots, the (B,) int64 challenges mod p, the (B, n/2)
    int32 folded codewords."""
    state, pending, alpha = HB.sponge_absorb_plain(state, pending, q, roots, fresh)
    return state, pending, alpha, fold_dyn_plain(codewords, inv_x_mont, alpha)


def fold_dyn(codewords: torch.Tensor, inv_x_mont: torch.Tensor, sponge: HB.Sponge,
             roots: torch.Tensor, copy: torch.Tensor, alpha: torch.Tensor,
             out: torch.Tensor | None = None) -> torch.Tensor:
    """(B, n) int32 codewords -> (B, n/2) int32: row b's root (``roots``,
    (B, 32) u8) absorbed into lane b of ``sponge``, the challenge drawn and
    row b folded with it; written into ``out`` when given.  The root is
    also written into ``copy`` ((B, 32) u8) and the challenge mod p into
    ``alpha`` ((B,) int32), for the host's replay."""
    if codewords.dim() != 2 or codewords.shape[1] < 2 or codewords.shape[1] % 2:
        raise ValueError(f"expected (B, n) codewords, n even, got {tuple(codewords.shape)}")
    rows, half = codewords.shape[0], codewords.shape[1] // 2
    dev = codewords.device
    if tuple(inv_x_mont.shape) != (half,):
        raise ValueError("inverse-x ladder must have length n/2")
    if sponge.lanes != rows or sponge.state.device != dev:
        raise ValueError(f"the sponge must have {rows} lanes on {dev}")
    for t, name, shape, dtype in ((roots, "roots", (rows, 32), torch.uint8),
                                  (copy, "copy", (rows, 32), torch.uint8),
                                  (alpha, "alpha", (rows,), torch.int32),
                                  (out, "out", (rows, half), torch.int32)):
        if t is not None and (tuple(t.shape) != shape or t.dtype != dtype
                              or t.device != dev):
            raise ValueError(f"{name} must be {shape} {dtype} on {dev}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
    if out is None:
        out = torch.empty((rows, half), dtype=torch.int32, device=dev)
    if dev.type == "cpu":
        state, pending, got, folded = fold_dyn_round_plain(
            codewords, inv_x_mont, sponge.state, sponge.pending, sponge.q, roots,
            sponge.fresh)
        sponge.next_state.copy_(state)
        sponge.next_pending.copy_(pending)
        out.copy_(folded)
        copy.copy_(roots)
        alpha.copy_(got)
    else:
        for t, name in ((codewords, "codewords"), (inv_x_mont, "inv_x_mont"),
                        (roots, "roots"), (copy, "copy"), (alpha, "alpha"), (out, "out")):
            cuda.check_operand(t, name, t.dtype)
        FOLD_DYN.launch(
            dev, codewords.data_ptr(), inv_x_mont.data_ptr(), sponge.state.data_ptr(),
            sponge.pending.data_ptr(), sponge.next_state.data_ptr(),
            sponge.next_pending.data_ptr(), sponge.q, int(sponge.fresh), roots.data_ptr(),
            copy.data_ptr(), alpha.data_ptr(), out.data_ptr(), half, rows,
            cuda.sm_count(dev), INV2, INV2_SHOUP,
        )
    sponge.swap(32)
    return out
