"""Number-theoretic transform over F_p (p = 998244353, 2-adicity 23).

Counterpart of stark_tpu/ops/ntt.py, on (..., n) int32 tensors of values in
[0, p).  Contract (the reference's dense-polynomial functions on smooth
coset domains):

    ntt(coeffs)[i]        == poly.eval(omega^i)
    coset_eval(c, off)[i] == poly.eval(off * omega^i)   (eval.rs:16-21)
    coset_interp(vals)    == interpolate_domain(off * omega^i, vals)

Every transform goes through the four-step kernels of ops/ntt_fused.py
(their plain versions on a CPU tensor); the coset scalings are int64 torch
ops.  The host numpy engine at the bottom serves the verifier's tiny
last-codeword check (fri.rs:360-397 replacement), which never touches the
device.
"""

from __future__ import annotations

import numpy as np
import torch

from stark_tpu_torch.ops import fieldops as F
from stark_tpu_torch.ops import ntt_fused as NTF
from stark_tpu_torch.ops.fieldops import P


def ntt(coeffs: torch.Tensor) -> torch.Tensor:
    """Forward NTT: coeffs (..., n) -> evaluations at omega^i, natural order."""
    return NTF.fused_ntt(coeffs, inverse=False)


def intt(evals: torch.Tensor) -> torch.Tensor:
    """Inverse NTT: evaluations at omega^i -> coefficients."""
    return NTF.fused_ntt(evals, inverse=True)


def coset_eval(coeffs: torch.Tensor, offset: int) -> torch.Tensor:
    """Evaluate on {offset * omega^i}: f(off * x) has coefficients
    c_k * off^k, which a plain NTT evaluates on the omega-domain."""
    off = offset % P
    if off == 1:
        return ntt(coeffs)
    scale = F.powers(off, coeffs.shape[-1], device=coeffs.device)
    return ntt(F.mulmod(coeffs, scale).to(torch.int32))


def coset_interp(values: torch.Tensor, offset: int) -> torch.Tensor:
    """Interpolate values on {offset * omega^i}: the iNTT gives the
    coefficients of f(off * x); undo the scale."""
    coeffs = intt(values)
    off = offset % P
    if off == 1:
        return coeffs
    scale = F.powers(F.host_inv(off), values.shape[-1], device=values.device)
    return F.mulmod(coeffs, scale).to(torch.int32)


def lde(coeffs: torch.Tensor, blowup: int, offset: int) -> torch.Tensor:
    """Low-degree extension: zero-pad coeffs (..., n) to n*blowup and
    evaluate on the size-(n*blowup) coset {offset * Omega^i}."""
    n = coeffs.shape[-1]
    assert blowup & (blowup - 1) == 0
    padded = torch.nn.functional.pad(coeffs, (0, n * blowup - n))
    return coset_eval(padded, offset)


# ---------------------------------------------------------------------------
# Host (numpy) engine — the same Stockham, for the verifier.
# ---------------------------------------------------------------------------

def _host_ntt_core(x: np.ndarray, inverse: bool) -> np.ndarray:
    n = x.shape[-1]
    a = x.astype(np.uint64).reshape(1, n)
    for w in NTF.stockham_twiddles(n, inverse):
        half = a.shape[-1] // 2
        even, odd = a[..., :half], a[..., half:]
        tw = (odd * w.astype(np.uint64)[:, None]) % P
        # (even + P - tw): keep the uint64 subtraction non-wrapping.
        a = np.concatenate(
            [(even + tw) % P, (even + np.uint64(P) - tw) % P], axis=-2
        )
    a = a.reshape(n)
    if inverse:
        a = (a * np.uint64(F.host_inv(n))) % P
    return a.astype(np.uint32)


def host_coset_interp(values: np.ndarray, offset: int) -> np.ndarray:
    """numpy coset interpolation (same contract as coset_interp)."""
    values = np.asarray(values, dtype=np.uint32)
    n = values.shape[-1]
    c = _host_ntt_core(values, inverse=True)
    if offset % P != 1:
        inv_off = F.host_inv(offset)
        c = (c.astype(np.uint64) * F.host_powers(inv_off, n).astype(np.uint64)) % P
    return c.astype(np.uint32)


def host_coset_eval(coeffs: np.ndarray, offset: int) -> np.ndarray:
    """numpy coset evaluation (same contract as coset_eval)."""
    coeffs = np.asarray(coeffs, dtype=np.uint32)
    n = coeffs.shape[-1]
    if offset % P != 1:
        coeffs = (
            coeffs.astype(np.uint64)
            * F.host_powers(offset % P, n).astype(np.uint64)
        ) % P
    return _host_ntt_core(coeffs.astype(np.uint32), inverse=False)
