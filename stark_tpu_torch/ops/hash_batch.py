"""Device commitment hash and Merkle levels: kernels K5-K8 (csrc/hash.cu),
their wrappers, and the plain PyTorch version of each.

Counterpart of stark_tpu/ops/hash_batch.py, bit-exact with the host engines
in hashfn.py (reference src/hash.rs):

    hash_rows     K5/K6  (c, N) field values -> N digests, lane i the hash
                         of column i's 8c little-endian bytes
                         (leaf_hash_rows_core :279 is c = 1,
                         row_hash_rows_core :290 any c);
    merkle_level  K7     W node digests -> W/2 parents, parent j =
                         hash(node 2j || node 2j+1) (level_rows_core :329);
    merkle_tail   K8     W node digests -> every level above them, down to
                         the root (_tail_levels_core :433), in one launch:
                         a block per subtree (tail_sub_lg), and the block
                         that finishes last builds the top;
    merkle_build         fills a whole tree's level stack from its leaf
                         level: K7 for levels wider than TAIL_CUTOVER, K8
                         from there to the root.

**Layout.**  Digests are node-major ``(N, 32)`` uint8 tensors: node j is
the 32 contiguous bytes at 32 j.  (The JAX package keeps them byte-major,
``(32, N)``, a TPU-lane habit; its tests' side transposes.)  A thread reads
a digest as two 16-byte words, a parent's input left || right is the 64
contiguous bytes at 64 j, and it is already the host and wire layout, so
``digests_to_bytes`` is a plain copy.  A tree is one **level stack**, a
``(2W - 1, 32)`` tensor holding level 0 (the W leaves) first, then W/2
parents, ... and the root last - the layout of native.merkle_levels - so
an authentication path is one gather over it.

On a CUDA tensor every wrapper launches its kernel or raises; the plain
versions (``*_plain``: torch uint8 ops on a stacked byte-major state, where
uint8 wrapping IS the hash's mod-256 arithmetic) serve CPU tensors and the
comparisons:

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
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from stark_tpu_torch.hashfn import PRIMES, ROUND_CONSTANTS
from stark_tpu_torch.ops import cuda

_SRC = "stark_tpu_torch/csrc/hash.cu"
_I64 = ctypes.c_longlong
HASH_ROWS = cuda.Kernel(
    "hash_rows", "stark_hash_rows", [cuda.ptr] * 2 + [cuda.i32, _I64],
    source=_SRC, replaces="stark_tpu/ops/hash_batch.py:290",
)
MERKLE_LEVEL = cuda.Kernel(
    "merkle_level", "stark_merkle_level", [cuda.ptr] * 2 + [_I64],
    source=_SRC, replaces="stark_tpu/ops/hash_batch.py:329",
)
MERKLE_TAIL = cuda.Kernel(
    "merkle_tail", "stark_merkle_tail",
    [cuda.ptr] * 2 + [_I64, cuda.i32, cuda.i32, cuda.ptr],
    source=_SRC, replaces="stark_tpu/ops/hash_batch.py:433",
)

#: The subtree a K8 block owns leaves 2^TAIL_TOP_LG roots to the block that
#: builds the top, but is never smaller than 2^TAIL_MIN_SUB_LG nodes: set
#: from chip_smoke.py's subtree sweep on an H100 (PERF.md).
TAIL_TOP_LG = 7
TAIL_MIN_SUB_LG = 6
#: The most levels one block walks at a time (csrc/hash.cu kTailMaxLg): a
#: subtree, or the top that the last block builds.  A launch therefore
#: reaches the root from up to 2^(2 TAIL_MAX_LG) nodes.
TAIL_MAX_LG = 10
#: Levels wider than this go to K7, one launch each; from this width down
#: K8 builds the rest of the tree.  (The counterpart of the JAX package's
#: FUSE_MAX_WIDTH.)  K7 keeps every thread hashing; in K8 half of a block's
#: threads drop out per level, which pays only where a level is too narrow
#: to fill the card.  Set from chip_smoke.py's cutover sweep on an H100
#: (PERF.md).
TAIL_CUTOVER = 1 << 16


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


def _hash_chunks(data: torch.Tensor) -> torch.Tensor:
    """(L, N) u8 messages (one per lane) -> (32, N) digests: absorb each
    32-byte chunk with a mix after it, then the 8 final mixes
    (hash.rs:7-30)."""
    s = _init_state(data.shape[1], data.device)
    for start in range(0, data.shape[0], 32):
        s = _mix(_absorb(s, data[start : start + 32]))
    for _ in range(8):
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


# ---------------------------------------------------------------------------
# Plain versions (torch uint8 ops; node-major at the boundary).
# ---------------------------------------------------------------------------

def hash_rows_plain(values: torch.Tensor) -> torch.Tensor:
    """(c, N) field values -> (N, 32) digests:
    Hash::from_field_elements(column) per lane (hash.rs:7-35), the c values
    as 8c LE bytes.  For c = 1 this is the per-value leaf hash."""
    return _hash_chunks(_value_bytes(values)).T.contiguous()


def combine_plain(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """(N, 32) x (N, 32) -> (N, 32): Hash::combine per lane (hash.rs:41-46),
    the 64-byte input left || right."""
    return _hash_chunks(torch.cat([left, right], dim=1).T).T.contiguous()


def merkle_level_plain(nodes: torch.Tensor) -> torch.Tensor:
    """(W, 32) node digests -> (W/2, 32) parents (pairwise combine)."""
    return _hash_chunks(nodes.reshape(-1, 64).T).T.contiguous()


def tail_sub_lg(lg_w: int) -> int:
    """log2 of the subtree a K8 block owns when W = 2^lg_w nodes come in."""
    return min(max(lg_w - TAIL_TOP_LG, TAIL_MIN_SUB_LG), TAIL_MAX_LG, lg_w)


def tail_launches(lg_w: int, lg_sub: int | None = None):
    """K8's launches for a subtree of 2^lg_w nodes, as (lg_sub, lg_top)
    pairs: each builds lg_sub levels, a block per 2^lg_sub nodes, and
    lg_top more in the block that finishes last.  One launch reaches the
    root unless more than 2^TAIL_MAX_LG subtree roots would be left.
    ``lg_sub`` fixes the subtree size; by default tail_sub_lg chooses."""
    while lg_w > 0:
        sub = tail_sub_lg(lg_w) if lg_sub is None else min(lg_w, lg_sub)
        top = lg_w - sub if lg_w - sub <= TAIL_MAX_LG else 0
        yield sub, top
        lg_w -= sub + top


def merkle_tail_plain(nodes: torch.Tensor,
                      lg_sub: int | None = None) -> torch.Tensor:
    """(W, 32) node digests -> (W - 1, 32): every level above them, widest
    first, the root last, built as K8 builds them: launch by launch, each
    block's subtree on its own with its share of a level written at the
    block's offset, then the top."""
    w = nodes.shape[0]
    out = nodes.new_empty((w - 1, 32))
    pos = 0
    for sub, top in tail_launches(w.bit_length() - 1, lg_sub):
        # Every subtree's levels, then the top's as those of one block.
        for blocks, levels in ((nodes.shape[0] >> sub, sub), (1, top)):
            part = nodes.reshape(blocks, -1, 32)
            for _ in range(levels):
                count = part.shape[1] // 2
                part = merkle_level_plain(part.reshape(-1, 32)).reshape(
                    blocks, count, 32
                )
                # block b's share of the level starts at its node b * count
                out[pos : pos + blocks * count] = part.reshape(-1, 32)
                pos += blocks * count
            nodes = part.reshape(-1, 32)
    return out


# ---------------------------------------------------------------------------
# Kernel wrappers.
# ---------------------------------------------------------------------------

def _pow2(n: int) -> bool:
    return n > 0 and n & (n - 1) == 0


def _check_digests(t: torch.Tensor, name: str) -> None:
    """Digest operands: (N, 32) uint8, contiguous rows."""
    if t.dim() != 2 or t.shape[1] != 32 or t.dtype != torch.uint8:
        raise ValueError(
            f"{name} must be (N, 32) uint8 digests, got "
            f"{tuple(t.shape)} {t.dtype}"
        )
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_card_digests(t: torch.Tensor, name: str) -> None:
    """The kernels move digests as 16-byte words."""
    cuda.check_operand(t, name, torch.uint8)
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def _output(out, n: int, like: torch.Tensor) -> torch.Tensor:
    if out is None:
        return torch.empty((n, 32), dtype=torch.uint8, device=like.device)
    _check_digests(out, "out")
    if out.shape[0] != n or out.device != like.device:
        raise ValueError(
            f"out must hold {n} digests on {like.device}, got "
            f"{out.shape[0]} on {out.device}"
        )
    return out


def hash_rows(values: torch.Tensor, out: torch.Tensor | None = None) -> torch.Tensor:
    """K5/K6: (c, N) int32 field values -> (N, 32) digests, written into
    ``out`` when given (a slice of a level stack)."""
    if values.dim() != 2 or values.shape[0] < 1:
        raise ValueError(f"expected (c, N) values, c >= 1, got {tuple(values.shape)}")
    c, n = values.shape
    out = _output(out, n, values)
    if values.device.type == "cpu":
        out.copy_(hash_rows_plain(values))
        return out
    cuda.check_operand(values, "values")
    _check_card_digests(out, "out")
    if n:
        HASH_ROWS.launch(values.device, values.data_ptr(), out.data_ptr(), c, n)
    return out


def leaf_hash(values: torch.Tensor, out: torch.Tensor | None = None) -> torch.Tensor:
    """K5: (N,) field values -> (N, 32) digests,
    Hash::from_field_elements(&[v]) per value."""
    return hash_rows(values[None, :], out)


def merkle_level(nodes: torch.Tensor, out: torch.Tensor | None = None) -> torch.Tensor:
    """K7: (W, 32) node digests -> (W/2, 32) parents."""
    _check_digests(nodes, "nodes")
    w = nodes.shape[0]
    if w < 2 or w % 2:
        raise ValueError(f"a level needs an even number of nodes, got {w}")
    out = _output(out, w // 2, nodes)
    if nodes.device.type == "cpu":
        out.copy_(merkle_level_plain(nodes))
        return out
    _check_card_digests(nodes, "nodes")
    _check_card_digests(out, "out")
    MERKLE_LEVEL.launch(nodes.device, nodes.data_ptr(), out.data_ptr(), w // 2)
    return out


@functools.lru_cache(maxsize=64)
def _ticket(device: torch.device, stream: int) -> torch.Tensor:
    """K8's ticket counter for the launches on one stream of ``device``
    (``stream`` is its handle): one zeroed word, which every launch leaves
    at zero again.  Launches on one stream follow one another, so they can
    share it; launches on two streams may overlap and get a word each.  (A
    captured graph holds the word of the stream it was captured on: two
    such graphs must not be replayed at the same time.)"""
    return torch.zeros(1, dtype=torch.int32, device=device)


def merkle_tail(nodes: torch.Tensor, out: torch.Tensor | None = None,
                lg_sub: int | None = None) -> torch.Tensor:
    """K8: (W, 32) node digests, W a power of two -> (W - 1, 32), every
    level above them (widest first, the root last).  One launch for W up
    to 2^(2 TAIL_MAX_LG): a block per subtree, the top by the block that
    finishes last (``tail_launches``; ``lg_sub`` fixes the subtree size)."""
    _check_digests(nodes, "nodes")
    w = nodes.shape[0]
    if not _pow2(w):
        raise ValueError(f"a subtree needs a power-of-two width, got {w}")
    if lg_sub is not None and not 1 <= lg_sub <= TAIL_MAX_LG:
        raise ValueError(f"lg_sub must be in 1..{TAIL_MAX_LG}, got {lg_sub}")
    out = _output(out, w - 1, nodes)
    if nodes.device.type == "cpu":
        out.copy_(merkle_tail_plain(nodes, lg_sub))
        return out
    _check_card_digests(nodes, "nodes")
    _check_card_digests(out, "out")
    stream = torch.cuda.current_stream(nodes.device).cuda_stream
    ticket = _ticket(nodes.device, stream)
    src, pos = nodes, 0
    for sub, top in tail_launches(w.bit_length() - 1, lg_sub):
        try:
            MERKLE_TAIL.launch(
                nodes.device, src.data_ptr(), out[pos:].data_ptr(), w, sub,
                top, ticket.data_ptr(),
            )
        except RuntimeError:
            # A launch that failed may have left tickets drawn: the next
            # one must find the word at zero all the same.
            ticket.zero_()
            raise
        left = w >> (sub + top)
        pos += w - left
        src, w = out[pos - left : pos], left
    return out


def merkle_build(stack: torch.Tensor) -> torch.Tensor:
    """Fill a level stack in place: ``stack`` is (2W - 1, 32) with the W
    leaf digests in its first W rows; every level above is written behind
    them, the root last.  Levels wider than TAIL_CUTOVER come from K7, the
    rest from K8."""
    _check_digests(stack, "stack")
    w = (stack.shape[0] + 1) // 2
    if not _pow2(w) or stack.shape[0] != 2 * w - 1:
        raise ValueError(f"a level stack has 2W - 1 rows, got {stack.shape[0]}")
    pos = 0
    while w > TAIL_CUTOVER:
        merkle_level(stack[pos : pos + w], stack[pos + w : pos + w + w // 2])
        pos += w
        w //= 2
    if w > 1:
        merkle_tail(stack[pos : pos + w], stack[pos + w :])
    return stack


def level_offset(num_leaves: int, level: int) -> int:
    """Row of level ``level``'s first node in a level stack."""
    return 2 * num_leaves - ((2 * num_leaves) >> level)


def digests_to_bytes(digests: torch.Tensor) -> np.ndarray:
    """(N, 32) u8 digest tensor -> (N, 32) u8 host array."""
    return digests.cpu().numpy()


def bytes_to_digests(arr: np.ndarray, device) -> torch.Tensor:
    """(N, 32) u8 host array -> (N, 32) u8 digest tensor on ``device``."""
    return torch.from_numpy(np.ascontiguousarray(arr, dtype=np.uint8)).to(device)
