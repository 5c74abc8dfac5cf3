"""FRI fold on the card: kernel K4 (csrc/fold.cu) and its plain version.

Counterpart of stark_tpu/ops/pallas_kernels.py:fold_pallas, the same math as
stark_tpu/fri.py:_fold_kernel (reference src/fri.rs:57-91 re-algorithmized):

    folded[i] = 2^-1 * ((a + b) + alpha * x_i^-1 * (a - b))  mod p,
    a = codeword[i], b = codeword[i + half],

with x_i^-1 = (offset * omega^i)^-1 precomputed per round in Montgomery form
(fri.FriPlan.inv_x_mont).  The raw challenge ``alpha`` is a Python int up to
2^64 — it is reduced mod p before it reaches a tensor or the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from stark_tpu_torch.ops import cuda
from stark_tpu_torch.ops import fieldops as F
from stark_tpu_torch.ops.fieldops import P

INV2 = F.host_inv(2)
INV2_SHOUP = int(F.shoup_precompute(INV2))

FOLD = cuda.Kernel(
    "fri_fold", "stark_fri_fold",
    [cuda.ptr] * 3 + [ctypes.c_longlong] + [ctypes.c_uint] * 4,
    source="stark_tpu_torch/csrc/fold.cu",
    replaces="stark_tpu/ops/pallas_kernels.py:104",
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
