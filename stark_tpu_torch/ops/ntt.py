"""Number-theoretic transform over F_p (p = 998244353, 2-adicity 23).

Counterpart of stark_tpu/ops/ntt.py, on (..., n) int32 tensors of values in
[0, p).  Contract (the reference's dense-polynomial functions on smooth
coset domains):

    ntt(coeffs)[i]        == poly.eval(omega^i)
    coset_eval(c, off)[i] == poly.eval(off * omega^i)   (eval.rs:16-21)
    coset_interp(vals)    == interpolate_domain(off * omega^i, vals)

Every transform goes through the four-step kernels of ops/ntt_fused.py
(their plain versions on a CPU tensor); the LDE's zero pad and coset scale
ride in its pass 1 (ntt_fused.fused_lde), and every other coset scale is
kernel K14 (csrc/ntt.cu ``stark_lde_pad_scale``, :func:`pad_scale`; its
plain version :func:`pad_scale_plain` on a CPU tensor).  ``lazy`` picks
the kernels' [0, 2p) butterflies (bit-identical output); strict is the
default, as in the JAX package.  The host numpy engine at the bottom serves
the verifier's tiny last-codeword check (fri.rs:360-397 replacement), which
never touches the device.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from stark_tpu_torch.ops import cuda
from stark_tpu_torch.ops import fieldops as F
from stark_tpu_torch.ops import ntt_fused as NTF
from stark_tpu_torch.ops.fieldops import P

PAD_SCALE = cuda.Kernel(
    "lde_pad_scale", "stark_lde_pad_scale", [cuda.ptr] * 3 + [cuda.i32] * 3,
    source="stark_tpu_torch/csrc/ntt.cu", replaces="stark_tpu/ops/ntt.py:151",
)


def table_of(w: np.ndarray, device) -> torch.Tensor:
    """(t,) field values (numpy, in [0, p)) -> the (2, t) int32 table K14
    reads: the values, then their Shoup companions."""
    w = np.asarray(w, dtype=np.uint32)
    return torch.from_numpy(np.stack([w, F.shoup_precompute(w)]).view(np.int32)).to(device)


@functools.lru_cache(maxsize=32)
def scale_table(t: int, s: int, device: torch.device) -> torch.Tensor:
    """(2, t) int32 on ``device``: s^k mod p for k < t, then each power's
    Shoup companion (K14's operand), built on the host once per (t, s,
    device)."""
    return table_of(F.host_powers(s, t), device)


def pad_scale_by_plain(c: torch.Tensor, n: int, table: torch.Tensor) -> torch.Tensor:
    """(rows, t) int32 in [0, p) -> (rows, n) int32: entry k < t times
    table[0, k] mod p, zeros from t on (int64 torch ops)."""
    scaled = F.mulmod(c, table[0])
    return torch.nn.functional.pad(scaled, (0, n - c.shape[-1])).to(torch.int32)


def pad_scale_by(c: torch.Tensor, n: int, table: torch.Tensor) -> torch.Tensor:
    """K14 on a (rows, t) int32 tensor with a (2, t) ``table``
    (:func:`table_of`): (rows, n), entry k < t times table[0, k], zeros
    from t on; a CPU tensor takes :func:`pad_scale_by_plain`.  t and n are
    powers of two, t <= n.  The table is the powers of one s for an LDE's
    pad and coset scale (:func:`pad_scale`), or the sharded four-step's
    twiddle w^(j2 k1) and a shard's coset scale (parallel/pntt.py)."""
    if c.dim() != 2:
        raise ValueError(f"expected (rows, t), got {tuple(c.shape)}")
    rows, t = c.shape
    if t & (t - 1) or n & (n - 1) or not 1 <= t <= n:
        raise ValueError(f"t = {t} and n = {n} must be powers of two, t <= n")
    if tuple(table.shape) != (2, t) or table.dtype != torch.int32 or table.device != c.device:
        raise ValueError(f"the table must be (2, {t}) int32 on {c.device}, got "
                         f"{tuple(table.shape)} {table.dtype} on {table.device}")
    if c.device.type == "cpu":
        return pad_scale_by_plain(c, n, table)
    cuda.check_operand(c, "c")
    cuda.check_operand(table, "table")
    if c.data_ptr() % 16:  # a view into the middle of an allocation
        c = c.clone()
    if table.data_ptr() % 16:
        table = table.clone()
    out = torch.empty((rows, n), dtype=torch.int32, device=c.device)
    PAD_SCALE.launch(c.device, c.data_ptr(), out.data_ptr(), table.data_ptr(), rows,
                     t.bit_length() - 1, n.bit_length() - 1)
    return out


def pad_scale_plain(c: torch.Tensor, n: int, s: int) -> torch.Tensor:
    """(rows, t) int32 in [0, p) -> (rows, n) int32: zero-padded to n, then
    entry k times s^k mod p (int64 torch ops)."""
    return pad_scale_by_plain(c, n, scale_table(c.shape[-1], s % P, c.device))


def pad_scale(c: torch.Tensor, n: int, s: int) -> torch.Tensor:
    """K14 on a (rows, t) int32 tensor: the (rows, n) zero pad and scale of
    :func:`pad_scale_plain` (:func:`pad_scale_by` with the powers of s)."""
    if c.dim() != 2:
        raise ValueError(f"expected (rows, t), got {tuple(c.shape)}")
    return pad_scale_by(c, n, scale_table(c.shape[-1], s % P, c.device))


def _pad_scaled(x: torch.Tensor, n: int, s: int) -> torch.Tensor:
    """(..., t) -> (..., n) through K14, the leading axes as its rows."""
    t = x.shape[-1]
    return pad_scale(x.reshape(-1, t).contiguous(), n, s).reshape(x.shape[:-1] + (n,))


def ntt(coeffs: torch.Tensor, lazy: bool = False) -> torch.Tensor:
    """Forward NTT: coeffs (..., n) -> evaluations at omega^i, natural order."""
    return NTF.fused_ntt(coeffs, inverse=False, lazy=lazy)


def intt(evals: torch.Tensor, lazy: bool = False) -> torch.Tensor:
    """Inverse NTT: evaluations at omega^i -> coefficients."""
    return NTF.fused_ntt(evals, inverse=True, lazy=lazy)


def coset_eval(coeffs: torch.Tensor, offset: int,
               lazy: bool = False) -> torch.Tensor:
    """Evaluate on {offset * omega^i}: f(off * x) has coefficients
    c_k * off^k, which a plain NTT evaluates on the omega-domain."""
    off = offset % P
    if off == 1:
        return ntt(coeffs, lazy)
    return ntt(_pad_scaled(coeffs, coeffs.shape[-1], off), lazy)


def coset_interp(values: torch.Tensor, offset: int,
                 lazy: bool = False) -> torch.Tensor:
    """Interpolate values on {offset * omega^i}: the iNTT gives the
    coefficients of f(off * x); undo the scale."""
    coeffs = intt(values, lazy)
    off = offset % P
    if off == 1:
        return coeffs
    return _pad_scaled(coeffs, coeffs.shape[-1], F.host_inv(off))


def lde(coeffs: torch.Tensor, blowup: int, offset: int,
        lazy: bool = False) -> torch.Tensor:
    """Low-degree extension: zero-pad coeffs (..., n) to n*blowup and
    evaluate on the size-(n*blowup) coset {offset * Omega^i}: the pad and
    the scale in the first round of K1 of an LDE (ntt_fused.fused_lde),
    for all the leading axes' rows at once, then K3 and K2."""
    n = coeffs.shape[-1]
    assert blowup & (blowup - 1) == 0
    return NTF.fused_lde(coeffs, n * blowup, offset % P, lazy)


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
