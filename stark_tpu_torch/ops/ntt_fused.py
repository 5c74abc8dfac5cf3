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

K1 and K2 each come strict and lazy (``lazy=True``, the JAX package's flag
of the same name): the lazy butterflies keep values in [0, 2p) between
stages, drop the subtract's select and the Shoup multiply's final
correction, and give bit-identical output.  They are kernels of their own
(``ntt_pass1_lazy``, ``ntt_pass2_lazy``) with their own launch counts.

The column kernels run their radix-2 DIF stages in rounds of up to four,
the longer rounds first, a round's 2^q elements in one thread's registers
(csrc/ntt.cu).  The plain versions of K1 and K2 (``_col_ntt_rounds``)
follow that: the same rounds, element-to-thread mapping, twiddle indices,
u32 arithmetic (the strict butterfly's difference goes into the Shoup
product as a - b + p, unreduced) and bit-reversed store, strict and lazy,
and assert every range the kernels rely on.  K3 transposes 4 x 4 blocks in
registers between 16-byte loads and stores where rows and columns are
multiples of 4 (``_transpose_vector``), and goes through a padded 32 x 33
shared tile with 4-byte accesses elsewhere: both are the hand kernel, the
choice is a rule on the shape.  ``_col_ntt`` (Stockham) and
``_col_ntt_lazy`` (one radix-2 stage at a time) compute the same columns
independently of that grouping: the tests hold the rounds against them.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from stark_tpu_torch.ops import cuda
from stark_tpu_torch.ops import fieldops as F
from stark_tpu_torch.ops.fieldops import P, primitive_nth_root

#: Column-tile budget of one block, in elements (32 KB of shared memory):
#: a pass over columns of length 2^lg_r takes 2^13 / 2^lg_r of them at once,
#: and at least _MIN_TILE_COLS (a 32-byte run of a row) where the array has
#: them.  Two to four such blocks share an SM, so one's loads and stores
#: overlap another's butterflies.
_SMEM_ELEMS = 1 << 13
_MIN_TILE_COLS = 8
#: A pass that would run on fewer blocks than this takes narrower tiles,
#: down to _MIN_TILE_COLS columns, so that a small transform still reaches
#: most of the card's 132 SMs.
_MIN_BLOCKS = 128
#: Threads of a block: one per radix-16 unit of its tile, at most this many
#: (a column of 2^11 rows gives them two units each).
_MAX_THREADS = 512
#: Stages of the longest round (csrc/ntt.cu kMaxRound).
MAX_ROUND = 4
#: Shared memory a block may use (csrc/ntt.cu kSmemMax).
SMEM_BYTES = 227 * 1024

#: Rows and columns of a transpose must be multiples of this for 16-byte
#: accesses in both directions (K3's vector route, a block of 256 threads
#: per tile of 32 rows by 128 columns); other shapes take its edge route.
VECTOR_COLS = 4

_SRC = "stark_tpu_torch/csrc/ntt.cu"
PASS1 = cuda.Kernel(
    "ntt_pass1", "stark_ntt_pass1", [cuda.ptr] * 5 + [cuda.i32] * 5,
    source=_SRC, replaces="stark_tpu/ops/ntt_fused.py:383",
)
TRANSPOSE = cuda.Kernel(
    "ntt_transpose", "stark_ntt_transpose", [cuda.ptr] * 2 + [cuda.i32] * 4,
    source=_SRC, replaces="stark_tpu/ops/ntt_fused.py:345",
)
PASS2 = cuda.Kernel(
    "ntt_pass2", "stark_ntt_pass2", [cuda.ptr] * 4 + [cuda.i32] * 5,
    source=_SRC, replaces="stark_tpu/ops/ntt_fused.py:409",
)
PASS1_LAZY = cuda.Kernel(
    "ntt_pass1_lazy", "stark_ntt_pass1_lazy", PASS1.argtypes,
    source=_SRC, replaces="stark_tpu/ops/ntt_fused.py:383",
)
PASS2_LAZY = cuda.Kernel(
    "ntt_pass2_lazy", "stark_ntt_pass2_lazy", PASS2.argtypes,
    source=_SRC, replaces="stark_tpu/ops/ntt_fused.py:409",
)
#: K1 of a low-degree extension: the zero pad and coset scale of
#: stark_tpu/ops/ntt.py lde (:189-195, _coset_scale_fwd :151) in pass 1's
#: first round.
PASS1_LDE = cuda.Kernel(
    "ntt_pass1_lde", "stark_ntt_pass1_lde", [cuda.ptr] * 6 + [cuda.i32] * 6,
    source=_SRC, replaces="stark_tpu/ops/ntt_fused.py:383",
)
PASS1_LDE_LAZY = cuda.Kernel(
    "ntt_pass1_lde_lazy", "stark_ntt_pass1_lde_lazy", PASS1_LDE.argtypes,
    source=_SRC, replaces="stark_tpu/ops/ntt_fused.py:383",
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


@functools.cache
def get_plan(n: int, inverse: bool, device: torch.device) -> FusedNTTPlan:
    """The plan of (n, inverse) on ``device``, made once and never dropped:
    a captured graph (stark.py's slots) reads its tables by address for as
    long as it lives."""
    return FusedNTTPlan(n, inverse, device)


# ---------------------------------------------------------------------------
# Plain versions of the three kernels (int64 torch ops).
# ---------------------------------------------------------------------------

def _col_ntt(x3: torch.Tensor, inverse: bool) -> torch.Tensor:
    """(B, r, c) -> int64 length-r transforms down each column, no 1/r
    (root primitive_nth_root(r) = w^(n/r), the pass's column root).  A
    reference for ``_col_ntt_rounds``."""
    r = x3.shape[1]
    return _stockham(x3.long().transpose(1, 2), r, inverse).transpose(1, 2)


_U32 = (1 << 32) - 1
_TWO_P = 2 * P
_PINV_NEG = (-pow(P, -1, 1 << 32)) % (1 << 32)  # csrc/field.cuh kPinvNeg


def _umulhi(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """floor(a * b / 2^32) for int64 tensors of u32 values (the product
    may pass 2^63, so b goes in 16-bit halves)."""
    return (a * (b >> 16) + (a * (b & 0xFFFF) >> 16)) >> 16


def _in_range(t: torch.Tensor, bound: int, what: str) -> None:
    if not bool(((t >= 0) & (t < bound)).all()):
        raise AssertionError(f"lazy NTT: {what} left [0, {bound})")


def _col_ntt_lazy(x3: torch.Tensor, tw: torch.Tensor,
                  tws: torch.Tensor) -> torch.Tensor:
    """(B, r, c) values in [0, p) -> int64 column transforms in [0, 2p),
    natural row order: the lazy DIF stages, one radix-2 stage at a time
    (csrc/field.cuh add_lazy / sub_lazy / shoup_lazy).  A reference for
    ``_col_ntt_rounds``, equal to it value for value."""
    b, r, c = x3.shape
    lg_r = r.bit_length() - 1
    a = x3.long()
    w_all, ws_all = tw.long(), tws.long() & _U32
    for s in range(lg_r):
        half = r >> (s + 1)
        a4 = a.reshape(b, 1 << s, 2 * half, c)
        u, v = a4[:, :, :half], a4[:, :, half:]
        j = torch.arange(half, device=a.device) << s
        w, ws = w_all[j][:, None], ws_all[j][:, None]
        total = u + v
        top = torch.where(total >= _TWO_P, total - _TWO_P, total)
        d = u - v + _TWO_P
        _in_range(d, 2 * _TWO_P, "a - b + 2p")
        bot = (d * w - _umulhi(d, ws) * P) & _U32
        a = torch.cat([top, bot], dim=2).reshape(b, r, c)
        _in_range(a, _TWO_P, f"stage {s}")
    return a[:, _bit_reverse(torch.arange(r, device=a.device), lg_r)]


def round_stages(lg_r: int) -> list[int]:
    """The kernels' rounds for a column of 2^lg_r rows (csrc/ntt.cu
    Rounds): ceil(lg_r / MAX_ROUND) of them, as even as can be, the
    longer ones first.  11 -> [4, 4, 3]."""
    count = -(-lg_r // MAX_ROUND)
    base, longer = divmod(lg_r, count)
    return [base + 1] * longer + [base] * (count - longer)


def _bit_reverse(v: torch.Tensor, bits: int) -> torch.Tensor:
    rev = torch.zeros_like(v)
    for bit in range(bits):
        rev |= ((v >> bit) & 1) << (bits - 1 - bit)
    return rev


def _col_ntt_rounds(x3: torch.Tensor, tw: torch.Tensor, tws: torch.Tensor,
                    lazy: bool) -> torch.Tensor:
    """(B, r, c) values in [0, p) -> int64 column transforms, natural row
    order, in [0, p) (strict) or [0, 2p) (lazy), as csrc/ntt.cu computes
    them: round by round, every element where its thread holds it.  In a
    round of q stages starting at stage s0, with b_lo = lg_r - s0 - q, row
    (hi << (b_lo + q)) | (m << b_lo) | lo is element m of unit (hi, lo);
    stage s0 + t pairs m with m + 2^(q-1-t) and multiplies the difference
    by tw[(((m mod 2^(q-1-t)) << b_lo) | lo) << (s0 + t)]; the last round
    stores row (hi << q) | m at (reversed m) << (lg_r - q) | reversed hi.
    Asserts every range the kernels rely on."""
    b, r, c = x3.shape
    lg_r = r.bit_length() - 1
    a = x3.long()
    w_all, ws_all = tw.long(), tws.long() & _U32
    bound = _TWO_P if lazy else P
    s0 = q = 0
    for q in round_stages(lg_r):
        b_lo = lg_r - s0 - q
        lo = torch.arange(1 << b_lo, device=a.device)
        for t in range(q):
            half = 1 << (q - 1 - t)
            # (B, hi, block of 2 half, upper or lower half, k, lo, c)
            v = a.reshape(b, 1 << s0, 1 << t, 2, half, 1 << b_lo, c)
            u, d = v[:, :, :, 0], v[:, :, :, 1]
            k = torch.arange(half, device=a.device)
            e = ((k[:, None] << b_lo) | lo) << (s0 + t)
            w, ws = w_all[e][..., None], ws_all[e][..., None]
            total = u + d
            top = torch.where(total >= bound, total - bound, total)
            # The difference goes unreduced into the Shoup product, which
            # takes any u32: a - b + 2p (lazy) or a - b + p (strict).
            diff = u - d + bound
            _in_range(diff, 2 * bound, "a - b + its offset")
            bot = (diff * w - _umulhi(diff, ws) * P) & _U32
            _in_range(bot, _TWO_P, "the Shoup product")
            if not lazy:
                bot = torch.where(bot >= P, bot - P, bot)
            a = torch.stack([top, bot], dim=3).reshape(b, r, c)
            _in_range(a, bound, f"stage {s0 + t}")
        s0 += q
    rows = torch.arange(r, device=a.device)
    place = (_bit_reverse(rows & ((1 << q) - 1), q) << (lg_r - q)) | _bit_reverse(
        rows >> q, lg_r - q
    )
    out = torch.empty_like(a)
    out[:, place] = a
    return out


def _mont_mul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """csrc/field.cuh mont_mul word by word: a in [0, 2p), b in [0, p)."""
    prod = a * b  # < 2p * p < 2^61
    lo, hi = prod & _U32, prod >> 32
    m = lo * _PINV_NEG & _U32
    u = hi + (m * P >> 32) + (lo != 0)
    _in_range(u, _TWO_P, "REDC before its final subtract")
    return torch.where(u >= P, u - P, u)


def pass1_plain(x3: torch.Tensor, plan: FusedNTTPlan,
                lazy: bool = False) -> torch.Tensor:
    y = _col_ntt_rounds(x3, plan.tw1, plan.tw1_shoup, lazy)
    return _mont_mul_plain(y, plan.wm.long()).to(torch.int32)


@functools.cache
def lde_scale(n: int, s: int, device: torch.device) -> torch.Tensor:
    """(n1 + n2, 2) int32 on ``device``, for an LDE onto n points with the
    scale s: s^(n2 r) for r < n1, then s^col for col < n2, each beside its
    Shoup companion (csrc/ntt.cu LdeInput: s^e = s^(n2 r) s^col for
    element e = r n2 + col), built on the host once per (n, s, device) and
    never dropped (as :func:`get_plan`)."""
    n1 = 1 << (n.bit_length() - 1) // 2                       # FusedNTTPlan's split
    n2 = n // n1
    w = np.concatenate([F.host_powers(pow(s, n2, P), n1), F.host_powers(s, n2)])
    return torch.from_numpy(np.stack([w, F.shoup_precompute(w)], axis=1).view(
        np.int32)).to(device)


def lde_input_plain(c: torch.Tensor, plan: FusedNTTPlan, s: int) -> torch.Tensor:
    """(B, T) coefficients in [0, p) -> (B, n1, n2) int64: pass 1's input
    as the LDE's first round loads it: element e = i1 n2 + i2 is c[e] s^(n2
    i1) s^i2 where e < T (two products by the scale tables' entries), 0
    elsewhere."""
    b, t = c.shape
    table = lde_scale(plan.n, s % P, c.device).long()
    rows, cols = table[: plan.n1, 0], table[plan.n1 :, 0]
    e = (torch.arange(plan.n1, device=c.device)[:, None] * plan.n2
         + torch.arange(plan.n2, device=c.device))
    inside = e < t
    y = c.long()[:, e.clamp(max=t - 1)] * rows[:, None] % P * cols % P
    return torch.where(inside, y, torch.zeros_like(y))


def pass1_lde_plain(c: torch.Tensor, plan: FusedNTTPlan, s: int,
                    lazy: bool = False) -> torch.Tensor:
    """K1 of an LDE, plain: its first round's input, then pass 1."""
    return pass1_plain(lde_input_plain(c, plan, s), plan, lazy)


def transpose_plain(y3: torch.Tensor) -> torch.Tensor:
    return y3.transpose(1, 2).contiguous()


def pass2_plain(y3: torch.Tensor, plan: FusedNTTPlan,
                lazy: bool = False) -> torch.Tensor:
    z = _col_ntt_rounds(y3, plan.tw2, plan.tw2_shoup, lazy)
    return torch.where(z >= P, z - P, z).to(torch.int32)


# ---------------------------------------------------------------------------
# Kernel wrappers.
# ---------------------------------------------------------------------------

def _launch_shape(lg_r: int, cols: int, batch: int) -> tuple[int, int]:
    """(log2 of a block's tile width in columns, threads of a block) for a
    pass over ``batch`` arrays of 2^lg_r rows by ``cols`` columns (set from
    the sweep of tools/tune_kernels.py)."""
    tc = min(cols, max(_MIN_TILE_COLS, _SMEM_ELEMS >> lg_r))
    while tc > _MIN_TILE_COLS and batch * (cols // tc) < _MIN_BLOCKS:
        tc //= 2
    while _block_bytes(lg_r, tc.bit_length() - 1) > SMEM_BYTES:
        tc //= 2  # columns of 2^13 rows: 8 of them do not fit a block
    threads = min(max((tc << lg_r) >> MAX_ROUND, 32), _MAX_THREADS)
    return tc.bit_length() - 1, threads


def _block_bytes(lg_r: int, lg_tc: int) -> int:
    """Shared memory of a column kernel's block: the twiddle pairs and a tile
    of 2^lg_r rows by 2^lg_tc columns with its padding (csrc/ntt.cu
    pad_shift_of, tile_word): one row after every 2^q, q the stages of the
    last round, for tiles under 32 columns whose columns take more than one
    round."""
    elems = 1 << (lg_r + lg_tc)
    rounds = round_stages(lg_r)
    pad = elems >> rounds[-1] if len(rounds) > 1 and lg_tc < 5 else 0
    return 4 * ((1 << lg_r) + elems + pad)


def _transpose_vector(rows: int, cols: int) -> bool:
    """Whether a (rows, cols) transpose takes K3's vector route."""
    return rows % VECTOR_COLS == 0 and cols % VECTOR_COLS == 0


def _check_batch(x3: torch.Tensor, rows: int, cols: int) -> None:
    if x3.dim() != 3 or tuple(x3.shape[1:]) != (rows, cols):
        raise ValueError(f"expected (B, {rows}, {cols}), got {tuple(x3.shape)}")


def ntt_pass1(x3: torch.Tensor, plan: FusedNTTPlan,
              lazy: bool = False) -> torch.Tensor:
    """K1 on a (B, n1, n2) int32 batch."""
    _check_batch(x3, plan.n1, plan.n2)
    if x3.device.type == "cpu":
        return pass1_plain(x3, plan, lazy)
    cuda.check_operand(x3, "x")
    out = torch.empty_like(x3)
    (PASS1_LAZY if lazy else PASS1).launch(
        x3.device, x3.data_ptr(), out.data_ptr(), plan.tw1.data_ptr(),
        plan.tw1_shoup.data_ptr(), plan.wm.data_ptr(), x3.shape[0],
        plan.lg1, plan.n2, *_launch_shape(plan.lg1, plan.n2, x3.shape[0]),
    )
    return out


def ntt_pass1_lde(c: torch.Tensor, plan: FusedNTTPlan, s: int,
                  lazy: bool = False) -> torch.Tensor:
    """K1 of an LDE on (B, T) int32 coefficients, T a power of two <=
    plan.n: the (B, n1, n2) pass 1 of their zero pad to n, each entry e < T
    times s^e."""
    if c.dim() != 2:
        raise ValueError(f"expected (B, T), got {tuple(c.shape)}")
    b, t = c.shape
    if t & (t - 1) or not 1 <= t <= plan.n or plan.inverse:
        raise ValueError(f"T = {t} coefficients into a forward plan of {plan.n}")
    if c.device.type == "cpu":
        return pass1_lde_plain(c, plan, s, lazy)
    cuda.check_operand(c, "c")
    scale = lde_scale(plan.n, s % P, c.device)
    out = torch.empty((b, plan.n1, plan.n2), dtype=torch.int32, device=c.device)
    (PASS1_LDE_LAZY if lazy else PASS1_LDE).launch(
        c.device, c.data_ptr(), out.data_ptr(), plan.tw1.data_ptr(),
        plan.tw1_shoup.data_ptr(), plan.wm.data_ptr(), scale.data_ptr(), b, plan.lg1,
        plan.n2, *_launch_shape(plan.lg1, plan.n2, b), t.bit_length() - 1,
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
    if y3.data_ptr() % 16:  # a view into the middle of an allocation
        y3 = y3.clone()
    out = torch.empty((b, c, r), dtype=y3.dtype, device=y3.device)
    TRANSPOSE.launch(y3.device, y3.data_ptr(), out.data_ptr(), b, r, c,
                     int(_transpose_vector(r, c)))
    return out


def ntt_pass2(y3: torch.Tensor, plan: FusedNTTPlan,
              lazy: bool = False) -> torch.Tensor:
    """K2 on a (B, n2, n1) int32 batch."""
    _check_batch(y3, plan.n2, plan.n1)
    if y3.device.type == "cpu":
        return pass2_plain(y3, plan, lazy)
    cuda.check_operand(y3, "y")
    out = torch.empty_like(y3)
    (PASS2_LAZY if lazy else PASS2).launch(
        y3.device, y3.data_ptr(), out.data_ptr(), plan.tw2.data_ptr(),
        plan.tw2_shoup.data_ptr(), y3.shape[0], plan.lg2, plan.n1,
        *_launch_shape(plan.lg2, plan.n1, y3.shape[0]),
    )
    return out


def fused_ntt(x: torch.Tensor, inverse: bool = False,
              lazy: bool = False) -> torch.Tensor:
    """(..., n) int32 in [0, p) -> (..., n) int32 (i)NTT, natural order,
    through K1 -> K3 -> K2 (their plain versions on the CPU).  Same
    contract as stark_tpu's ops/ntt.ntt / intt; ``lazy`` selects the
    [0, 2p) butterflies (bit-identical output)."""
    if x.dtype != torch.int32:
        raise ValueError(f"expected int32 field values, got {x.dtype}")
    plan = get_plan(x.shape[-1], inverse, x.device)
    x3 = x.reshape(-1, plan.n1, plan.n2).contiguous()
    z = ntt_pass2(ntt_transpose(ntt_pass1(x3, plan, lazy)), plan, lazy)
    return z.reshape(x.shape)


def fused_lde(x: torch.Tensor, n: int, s: int, lazy: bool = False) -> torch.Tensor:
    """(..., T) int32 coefficients in [0, p) -> (..., n) int32: the NTT of
    their zero pad to n, entry k scaled by s^k (the evaluations on the
    coset s omega_n^i), through K1 of an LDE -> K3 -> K2 (their plain
    versions on the CPU): the pad and the scale ride in pass 1's first
    round, which loads only the T coefficients."""
    if x.dtype != torch.int32:
        raise ValueError(f"expected int32 field values, got {x.dtype}")
    plan = get_plan(n, False, x.device)
    c = x.reshape(-1, x.shape[-1]).contiguous()
    z = ntt_pass2(ntt_transpose(ntt_pass1_lde(c, plan, s, lazy)), plan, lazy)
    return z.reshape(x.shape[:-1] + (n,))
