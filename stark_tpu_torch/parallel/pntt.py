"""The sharded NTT: the four-step (transpose) algorithm over the mesh.

Counterpart of stark_tpu/parallel/pntt.py.  With n = R C, j = C j1 + j2,
k = R k2 + k1 and w the n-th root:

    X[R k2 + k1] = NTT_C over j2 [ w^(j2 k1) NTT_R over j1 [ M[j1, j2] ] ]

so a size-n transform is two batches of local size-R and size-C
transforms, separated by three all-to-alls of n/D words a rank (equal
chunks, parallel/mesh.Mesh.all_to_all).  Data stays contiguously sharded:
rank d holds indices [d n/D, (d+1) n/D) on input and on output.

Every function here takes and returns this rank's share (..., n/D) of a
(..., n) int32 array cut on its last axis; the leading axes are a batch.
On the card the local transforms are batched rows through K1-K3
(ops/ntt_fused.fused_ntt), the axis swaps (and the moves of blocks that
pack and unpack an exchange) are K3 (``ntt_transpose``, via
mesh.swap_blocks), and the twiddle multiply by w^(j2 k1) and a shard's
coset scale are K14 with a table (ops/ntt.pad_scale_by); on the CPU their
plain versions.  ``overlap`` = K > 1 cuts each exchange into K chunks
(stark_tpu's ``_local_fourstep_overlap``): chunk k + 1's exchange runs
(``async_op``) while chunk k's transforms do.  The values are the same for
every ``overlap``; a K that is not a power of two raises, and no
environment variable sets it.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from stark_tpu_torch.ops import fieldops as F
from stark_tpu_torch.ops import ntt as NTT
from stark_tpu_torch.ops import ntt_fused as NTF
from stark_tpu_torch.ops.fieldops import P as PRIME
from stark_tpu_torch.parallel.mesh import Mesh, swap_blocks


def _split(n: int) -> tuple[int, int]:
    """(R, C): R = 2^ceil(lg n / 2), C = n / R (stark_tpu's _fourstep_consts)."""
    log2n = n.bit_length() - 1
    r = 1 << ((log2n + 1) // 2)
    return r, n // r


@functools.cache
def _twiddles(n: int, inverse: bool, size: int, rank: int, chunks: int,
              device: torch.device) -> tuple:
    """This rank's rows of T[j2, k1] = w^(+-j2 k1) (j2 in its block of C/D),
    as ``chunks`` K14 tables of (C/D/chunks) R entries each.  Never
    evicted: a captured graph reads them by address (pstark.py)."""
    r_len, c_len = _split(n)
    w = F.primitive_nth_root(n)
    if inverse:
        w = pow(w, PRIME - 2, PRIME)
    pow_table = F.host_powers(w, n)
    c = c_len // size
    j2 = rank * c + np.arange(c, dtype=np.int64)[:, None]
    k1 = np.arange(r_len, dtype=np.int64)[None, :]
    tw = pow_table[j2 * k1].reshape(chunks, -1)
    return tuple(NTT.table_of(row, device) for row in tw)


@functools.cache
def _coset_table(offset: int, start: int, t: int, device: torch.device) -> torch.Tensor:
    """K14's table of offset^(start + k), k < t (never evicted, as
    :func:`_twiddles`)."""
    return NTT.table_of(F.host_powers(offset, t, scale=pow(offset, start, PRIME)), device)


def _check_overlap(overlap: int) -> int:
    if overlap < 1 or overlap & (overlap - 1):
        raise ValueError(f"overlap must be a power of two >= 1, got {overlap}")
    return overlap


def _fourstep(x: torch.Tensor, mesh: Mesh, inverse: bool, overlap: int,
              lazy: bool) -> torch.Tensor:
    lead = tuple(x.shape[:-1])
    d_count = mesh.size
    n = x.shape[-1] * d_count
    if n % (d_count * d_count) or n < 16:
        raise ValueError(f"sharded NTT needs D^2 | n and n >= 16 (n={n}, D={d_count}); "
                         "gather smaller transforms")
    if x.dtype != torch.int32:
        raise ValueError(f"expected int32 field values, got {x.dtype}")
    r_len, c_len = _split(n)
    r, c = r_len // d_count, c_len // d_count
    k = max(1, min(_check_overlap(overlap), min(r, c)))
    b = int(np.prod(lead, dtype=np.int64))
    tables = _twiddles(n, inverse, d_count, mesh.rank, k, x.device)
    x = x.reshape(b, r, c_len).contiguous()
    if k == 1:
        y = _local_fourstep(x, mesh, b, r, c, tables[0], inverse, lazy)
    else:
        y = _local_fourstep_overlap(x, mesh, b, r, c, k, tables, inverse, lazy)
    return y.reshape(lead + (n // d_count,))


def _local_fourstep(x, mesh: Mesh, b: int, r: int, c: int, table, inverse: bool,
                    lazy: bool) -> torch.Tensor:
    """One rank's share (B, R/D, C) [j1 in its block, j2] -> (B, C/D, R)
    [k2 in its block, k1]: three exchanges, each packed and unpacked by
    block moves, the local transforms along the last axis."""
    d = mesh.size
    r_len, c_len = r * d, c * d
    # 1: [j1 block, j2] -> [j1, j2 block]; size-R transforms over j1
    send = swap_blocks(x, 1, b * r, d, c)                          # (D, B r, c)
    got = mesh.all_to_all(send.reshape(-1)).reshape(d, b, r * c)
    y = NTF.ntt_transpose(swap_blocks(got, 1, d, b, r * c).reshape(b, r_len, c))  # (B, c, R)
    y = NTF.fused_ntt(y.reshape(b * c, r_len), inverse, lazy)
    y = NTT.pad_scale_by(y.reshape(b, c * r_len), c * r_len, table)  # w^(j2 k1)
    # 2: [j2 block, k1] -> [j2, k1 block]; size-C transforms over j2
    send = swap_blocks(y, 1, b * c, d, r)                          # (D, B c, r)
    got = mesh.all_to_all(send.reshape(-1)).reshape(d, b, c * r)
    z = NTF.ntt_transpose(swap_blocks(got, 1, d, b, c * r).reshape(b, c_len, r))  # (B, r, C)
    z = NTF.fused_ntt(z.reshape(b * r, c_len), inverse, lazy)
    # 3: [k1 block, k2] -> [k2 block, k1], natural order X[R k2 + k1]
    send = swap_blocks(z, 1, b * r, d, c)                          # (D, B r, c)
    got = mesh.all_to_all(send.reshape(-1)).reshape(d, b, r * c)
    return NTF.ntt_transpose(swap_blocks(got, 1, d, b, r * c).reshape(b, r_len, c))  # (B, c, R)


def _local_fourstep_overlap(x, mesh: Mesh, b: int, r: int, c: int, k: int, tables,
                            inverse: bool, lazy: bool) -> torch.Tensor:
    """:func:`_local_fourstep` with each exchange cut into ``k`` chunks
    (stark_tpu/parallel/pntt.py:_local_fourstep_overlap): phase 1 by blocks
    of j2, phases 2 and 3 by blocks of k1; every chunk's exchange is issued
    at once and waited for just before its transforms, so the wire runs
    under the previous chunk's kernels.  The same values."""
    d = mesh.size
    r_len, c_len = r * d, c * d
    cs, rs = c // k, r // k
    # 1: all k exchanges at once; chunk kk holds j2 in kk's sub-block
    send = swap_blocks(swap_blocks(x, 1, b * r, d * k, cs), 1, d, k, b * r * cs)
    pending = [mesh.all_to_all(send[0, kk].reshape(-1), async_op=True) for kk in range(k)]
    cols = []
    for kk in range(k):
        got = pending[kk].wait().reshape(d, b, r * cs)
        y = NTF.ntt_transpose(swap_blocks(got, 1, d, b, r * cs).reshape(b, r_len, cs))  # (B, cs, R)
        y = NTF.fused_ntt(y.reshape(b * cs, r_len), inverse, lazy)
        cols.append(NTT.pad_scale_by(y.reshape(b, cs * r_len), cs * r_len, tables[kk]))
    y = swap_blocks(torch.stack(cols), 1, k, b, cs * r_len)           # (B, k, cs R)
    # 2 and 3: chunk kk holds k1 in kk's sub-block
    send = swap_blocks(swap_blocks(y, 1, b * c, d * k, rs), 1, d, k, b * c * rs)
    pending = [mesh.all_to_all(send[0, kk].reshape(-1), async_op=True) for kk in range(k)]
    third = []
    for kk in range(k):
        got = pending[kk].wait().reshape(d, b, c * rs)
        z = NTF.ntt_transpose(swap_blocks(got, 1, d, b, c * rs).reshape(b, c_len, rs))  # (B, rs, C)
        z = NTF.fused_ntt(z.reshape(b * rs, c_len), inverse, lazy)
        out = swap_blocks(z, 1, b * rs, d, c)                      # (D, B rs, c)
        third.append(mesh.all_to_all(out.reshape(-1), async_op=True))
    got = torch.stack([h.wait().reshape(d, b * rs * c) for h in third])  # (k, D, B rs c)
    got = swap_blocks(got, 1, k, d, b * rs * c)                    # (D, k, B rs c)
    got = swap_blocks(got, 1, d * k, b, rs * c)                    # (B, D k, rs c)
    return NTF.ntt_transpose(got.reshape(b, r_len, c))  # (B, c, R)


def sharded_ntt(x: torch.Tensor, mesh: Mesh, overlap: int = 1,
                lazy: bool = False) -> torch.Tensor:
    """Forward NTT of a (..., n) array: ``x`` and the result are this rank's
    shares (..., n/D).  Needs D^2 | n and n >= 16."""
    return _fourstep(x, mesh, False, overlap, lazy)


def sharded_intt(x: torch.Tensor, mesh: Mesh, overlap: int = 1,
                 lazy: bool = False) -> torch.Tensor:
    """Inverse NTT (the 1/n scale as 1/R and 1/C in the local transforms)."""
    return _fourstep(x, mesh, True, overlap, lazy)


def _scale_shard(x: torch.Tensor, mesh: Mesh, offset: int) -> torch.Tensor:
    """x[i] offset^i over this rank's indices i of the global axis: K14 with
    the shard's table of powers."""
    m = x.shape[-1]
    table = _coset_table(offset, mesh.rank * m, m, x.device)
    return NTT.pad_scale_by(x.reshape(-1, m).contiguous(), m, table).reshape(x.shape)


def sharded_coset_eval(coeffs: torch.Tensor, offset: int, mesh: Mesh, overlap: int = 1,
                       lazy: bool = False) -> torch.Tensor:
    """Evaluate on {offset omega^i}: sharded counterpart of ops.ntt.coset_eval."""
    off = offset % PRIME
    if off != 1:
        coeffs = _scale_shard(coeffs, mesh, off)
    return sharded_ntt(coeffs, mesh, overlap, lazy)


def sharded_coset_interp(values: torch.Tensor, offset: int, mesh: Mesh, overlap: int = 1,
                         lazy: bool = False) -> torch.Tensor:
    """Interpolate values on {offset omega^i}: the sharded coset iNTT."""
    c = sharded_intt(values, mesh, overlap, lazy)
    off = offset % PRIME
    return c if off == 1 else _scale_shard(c, mesh, F.host_inv(off))


def sharded_lde(coeffs: torch.Tensor, blowup: int, offset: int, mesh: Mesh,
                overlap: int = 1, lazy: bool = False) -> torch.Tensor:
    """Zero-pad (..., n) coefficients to N = n blowup and coset-evaluate,
    sharded: this rank's (..., n/D) coefficients -> its (..., N/D) points.
    Rank d's coefficients land in output share d // blowup, so one exchange
    sends each share whole to that rank; K14 with the share's table of
    offset powers pads and scales what arrived (a share past the
    coefficients is zeros), then the sharded NTT of size N."""
    if blowup < 1 or blowup & (blowup - 1):
        raise ValueError(f"blowup must be a power of two, got {blowup}")
    lead = tuple(coeffs.shape[:-1])
    d_count, d = mesh.size, mesh.rank
    m = coeffs.shape[-1]
    n = m * d_count
    share = n * blowup // d_count
    b = int(np.prod(lead, dtype=np.int64))
    send = [b * m if e == d // blowup else 0 for e in range(d_count)]
    recv = [b * m if s // blowup == d else 0 for s in range(d_count)]
    got = mesh.exchange(coeffs.reshape(-1), send, recv)
    count = sum(1 for s in recv if s)
    if count:
        t = count * m
        local = swap_blocks(got.reshape(count, b, m), 1, count, b, m).reshape(b, t)
        table = _coset_table(offset % PRIME, d * share, t, coeffs.device)
        padded = NTT.pad_scale_by(local.contiguous(), share, table)
    else:
        padded = torch.zeros((b, share), dtype=torch.int32, device=coeffs.device)
    return sharded_ntt(padded.reshape(lead + (share,)), mesh, overlap, lazy)
