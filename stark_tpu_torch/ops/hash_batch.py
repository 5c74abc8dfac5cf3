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
                         that finishes last builds the top; a level
                         narrower than the block spreads each hash over
                         several lanes (tail_lanes, tail_plan);
    merkle_forest K8     the same for B trees of one width side by side
                         (a forest), each down to its own root
                         (forest_tail_levels_core :510): the block of a
                         tree that finishes last builds that tree's top;
    merkle_build         fills a whole tree's level stack from its leaf
                         level: K7 for levels wider than TAIL_CUTOVER, K8
                         from there to the root; forest_build a forest's;
    Sponge        K9     the incremental Fiat-Shamir sponge of the device
                         commit chain (sponge_from_bytes :831,
                         sponge_absorb :850, sponge_state :860,
                         state_alpha :869, device_sponge_root_alpha :911):
                         B lanes, each the hash state after its full
                         32-byte chunks and a pending tail; a launch
                         appends bytes and draws the challenge mod p
                         (the FRI rounds' root absorbs but the last run
                         in K4-dyn, ops/fold.fold_dyn);
    constraint_challenges K15  the STARK layer's constraint challenges on
                         the same sponge, seeded with each proof's trace
                         root (stark_tpu/stark.py:_device_challenges_fn
                         :165): the digests' bytes, K11's weight words and
                         the sponge the FRI chain goes on from;
    sample_indices K10   the FRI query indices from the sponge after the
                         last root (sample_indices_core :964,
                         seed_digest_rows_from_state :951): M candidate
                         hashes, the first ``number`` distinct reduced
                         indices in order, and how many were found.

**Layout.**  Digests are node-major ``(N, 32)`` uint8 tensors: node j is
the 32 contiguous bytes at 32 j.  (The JAX package keeps them byte-major,
``(32, N)``, a TPU-lane habit; its tests' side transposes.)  A thread reads
a digest as two 16-byte words, a parent's input left || right is the 64
contiguous bytes at 64 j, and it is already the host and wire layout, so
``digests_to_bytes`` is a plain copy.  A tree is one **level stack**, a
``(2W - 1, 32)`` tensor holding level 0 (the W leaves) first, then W/2
parents, ... and the root last - the layout of native.merkle_levels - so
an authentication path is one gather over it.  A **forest** of B trees of
width n is the level stack of one tree of width B n stopped at the B
roots, ``(2 B n - B, 32)``: tree b's nodes of a level are that level's
b-th share, so no pairing crosses a tree's edge, K7 builds a forest's
level as it builds a tree's, and the authentication path of leaf i of
tree b is the first log2 n siblings of leaf b n + i.

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

import contextlib
import ctypes
import functools

import numpy as np
import torch

from stark_tpu_torch.hashfn import PRIMES, ROUND_CONSTANTS
from stark_tpu_torch.ops import cuda
from stark_tpu_torch.ops.fieldops import P as _P

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
    [cuda.ptr] * 2 + [_I64, cuda.i32, cuda.i32, cuda.ptr, cuda.i32],
    source=_SRC, replaces="stark_tpu/ops/hash_batch.py:433",
)
MERKLE_FOREST = cuda.Kernel(
    "merkle_forest", "stark_merkle_forest",
    [cuda.ptr] * 2 + [_I64, cuda.i32, cuda.i32, cuda.ptr, cuda.i32],
    source=_SRC, replaces="stark_tpu/ops/hash_batch.py:510",
)
SPONGE = cuda.Kernel(
    "sponge_absorb", "stark_sponge_absorb",
    [cuda.ptr] * 2 + [cuda.i32] * 2 + [cuda.ptr, cuda.i32] + [cuda.ptr] * 2 + [cuda.i32],
    source=_SRC, replaces="stark_tpu/ops/hash_batch.py:911",
)
CHALLENGES = cuda.Kernel(
    "constraint_challenges", "stark_constraint_challenges",
    [cuda.ptr] * 6 + [cuda.i32] * 2,
    source=_SRC, replaces="stark_tpu/stark.py:165",
)
SAMPLE = cuda.Kernel(
    "sample_indices", "stark_sample_indices",
    [cuda.ptr] * 2 + [cuda.i32, _I64, _I64, cuda.i32, cuda.i32] + [cuda.ptr] * 2 + [cuda.i32],
    source=_SRC, replaces="stark_tpu/ops/hash_batch.py:964",
)
#: The largest reduced size K10 takes: its seen-mask, one bit a reduced
#: index, lies in 2 KB of shared memory (csrc/hash.cu kSampleMaxReduced).
SAMPLE_MAX_REDUCED = 1 << 14
#: Draws of a K15 chain that a group keeps in shared memory before it
#: writes their digests and weight words (csrc/hash.cu kChallengeWindow):
#: a chain past it goes on in windows, and the count has no bound.
CHALLENGE_WINDOW = 1024

#: The subtree a K8 block owns leaves 2^TAIL_TOP_LG roots to the block that
#: builds the top, but is never smaller than 2^TAIL_MIN_SUB_LG nodes: set
#: from chip_smoke.py's subtree sweep on an H100 (PERF.md; 2^8 since the
#: narrow levels spread a hash over several lanes, which made the deeper
#: walk of a larger subtree cheaper than a wider top).
TAIL_TOP_LG = 7
TAIL_MIN_SUB_LG = 8
#: The most levels one block walks at a time (csrc/hash.cu kTailMaxLg): a
#: subtree, or the top that the last block builds.  A launch therefore
#: reaches the root from up to 2^(2 TAIL_MAX_LG) nodes.
TAIL_MAX_LG = 10
#: The most threads of a K8 block (csrc/hash.cu kTailThreads), and the most
#: lanes one hash takes in a level narrower than the block (kTailLanes):
#: set from chip_smoke.py's sweep on an H100 (PERF.md).
TAIL_THREADS = 256
TAIL_LANES = 8
LANE_CHOICES = (1, 4, 8)
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


def tail_launches(lg_w: int, lg_sub: int | None = None,
                  lg_tree: int | None = None):
    """K8's launches for 2^lg_w nodes in trees of 2^lg_tree (one tree by
    default), as (lg_sub, lg_top) pairs: each builds lg_sub levels, a
    block per 2^lg_sub nodes, and lg_top more in the block of each tree
    that finishes last.  One launch reaches the roots unless more than
    2^TAIL_MAX_LG subtree roots a tree would be left.  ``lg_sub`` fixes
    the subtree size; by default tail_sub_lg chooses from the width."""
    lg_tree = lg_w if lg_tree is None else lg_tree
    while lg_tree > 0:
        sub = min(tail_sub_lg(lg_w) if lg_sub is None else lg_sub, lg_tree)
        top = lg_tree - sub if lg_tree - sub <= TAIL_MAX_LG else 0
        yield sub, top
        lg_w -= sub + top
        lg_tree -= sub + top


def tail_threads(lg_sub: int, lg_top: int) -> int:
    """The threads of a K8 block for a launch (csrc/hash.cu): half the
    widest level it walks, at least a warp, at most TAIL_THREADS."""
    return min(max(1 << (max(lg_sub, lg_top) - 1), 32), TAIL_THREADS)


def tail_lanes(count: int, threads: int, lanes_max: int = TAIL_LANES) -> int:
    """Lanes a hash at a level of ``count`` hashes in a block of
    ``threads`` (csrc/hash.cu tail_lanes): the block's threads spread over
    the level, at most ``lanes_max`` a hash; one lane where they would
    not give a hash four."""
    spread = threads // count
    return 1 if spread < 4 else min(spread, lanes_max)


def tail_plan(lg_w: int, lg_sub: int | None = None, lg_tree: int | None = None,
              lanes_max: int = TAIL_LANES):
    """K8's launches as tail_launches gives them, each as (threads, lanes
    of each subtree level, lanes of each top level): what a block of each
    walk runs, level by level."""
    for sub, top in tail_launches(lg_w, lg_sub, lg_tree):
        threads = tail_threads(sub, top)
        yield (threads,
               [tail_lanes(1 << (sub - k), threads, lanes_max) for k in range(1, sub + 1)],
               [tail_lanes(1 << (top - k), threads, lanes_max) for k in range(1, top + 1)])


def merkle_tail_plain(nodes: torch.Tensor, lg_sub: int | None = None,
                      trees: int = 1) -> torch.Tensor:
    """(W, 32) node digests -> (W - trees, 32): every level above them,
    widest first, the roots last, built as K8 builds them: launch by
    launch, each block's subtree on its own with its share of a level
    written at the block's offset, then each tree's top.  ``trees`` > 1:
    a forest of that many trees of width W / trees side by side, each
    built to its own root, as K8-forest builds it."""
    w = nodes.shape[0]
    out = nodes.new_empty((w - trees, 32))
    pos = 0
    lg_tree = (w // trees).bit_length() - 1
    for sub, top in tail_launches(w.bit_length() - 1, lg_sub, lg_tree):
        # Every subtree's levels, then the tops' as those of a block a tree.
        for blocks, levels in ((nodes.shape[0] >> sub, sub), (trees, top)):
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


def forest_tail_plain(nodes: torch.Tensor, trees: int) -> torch.Tensor:
    """(B n, 32) leaf digests of ``trees`` = B trees of width n -> (B n -
    B, 32): merkle_tail_plain applied to every tree (all at once), its
    levels laid out as the forest's (each level the trees' shares side by
    side, the B roots last)."""
    return merkle_tail_plain(nodes, None, trees)


def _stream_alpha(s: torch.Tensor) -> torch.Tensor:
    """(32, B) u8 finalized states -> (B,) int64: the first 8 digest bytes
    as a little-endian u64, mod p (stark_tpu's state_alpha)."""
    acc = torch.zeros(s.shape[1], dtype=torch.int64, device=s.device)
    for i in range(8):
        acc = (acc + s[i].long() * pow(2, 8 * i, _P)) % _P
    return acc


def sponge_state_plain(state: torch.Tensor, pending: torch.Tensor,
                       q: int) -> torch.Tensor:
    """(B, 32) cached states and their q-byte pending tails -> (B, 32)
    digests of every byte absorbed: the tail absorbed as a partial chunk
    and mixed, then the 8 closing mixes (stark_tpu's sponge_state)."""
    s = state.T.clone()
    if q:
        s = _mix(_absorb(s, pending[:, :q].T.contiguous()))
    for _ in range(8):
        s = _mix(s)
    return s.T.contiguous()


def _sponge_append(state: torch.Tensor, pending: torch.Tensor, q: int,
                   data: torch.Tensor, fresh: bool = False):
    """(B, 32) state and pending (q bytes), (B, m) data -> (state, pending,
    q): the state after every full chunk of pending || data and the new
    (B, 32) pending, its first q = (q + m) mod 32 bytes."""
    b = data.shape[0]
    s = _init_state(b, data.device) if fresh else state.T.clone()
    stream = torch.cat([pending[:, :q], data], dim=1).T  # (q + m, B)
    full = stream.shape[0] // 32 * 32
    for c in range(0, full, 32):
        s = _mix(_absorb(s, stream[c : c + 32]))
    new_pending = torch.zeros_like(pending)
    new_pending[:, : stream.shape[0] - full] = stream[full:].T
    return s.T.contiguous(), new_pending, stream.shape[0] - full


def sponge_absorb_plain(state: torch.Tensor, pending: torch.Tensor, q: int,
                        data: torch.Tensor, fresh: bool = False):
    """K9's plain version: (B, 32) state and pending (q bytes), (B, m)
    data -> (state, pending, alpha): the state after every full chunk of
    pending || data, the new (B, 32) pending (its first (q + m) mod 32
    bytes), and the (B,) int64 challenge mod p of all bytes so far."""
    state, new_pending, q = _sponge_append(state, pending, q, data, fresh)
    digest = sponge_state_plain(state, new_pending, q)
    return state, new_pending, _stream_alpha(digest.T)


_R1 = (1 << 32) % _P
_R2 = _R1 * _R1 % _P


def _as_int32(words: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 tensors holding their 32 bits."""
    return torch.where(words >= 1 << 31, words - (1 << 32), words).to(torch.int32)


def constraint_challenges_plain(roots: torch.Tensor, challenges: int):
    """K15's plain version: (B, 32) u8 trace roots -> (state, pending,
    digests, weights): a fresh sponge absorbs each root, then draws
    ``challenges`` challenges, each the first 8 bytes of the digest of
    every byte so far, which it absorbs in turn (stark.py
    _draw_constraint_challenges); the (B, 32) state and pending after them
    (a tail of 8 challenges mod 32 bytes), the (B, challenges, 8) u8
    challenge bytes, and the (B, 2 challenges) int32 weight words of K11,
    per pair (a, b): a R^2 mod p, its Shoup companion, b R mod p, its
    companion (ops/compose.py:ComposeProgram.weights)."""
    b = roots.shape[0]
    pending = torch.zeros((b, 32), dtype=torch.uint8, device=roots.device)
    state, pending, q = _sponge_append(None, pending, 0, roots, fresh=True)
    digests = torch.empty((b, challenges, 8), dtype=torch.uint8, device=roots.device)
    for k in range(challenges):
        digests[:, k] = sponge_state_plain(state, pending, q)[:, :8]
        state, pending, q = _sponge_append(state, pending, q, digests[:, k])
    red = _stream_alpha(digests.reshape(-1, 8).T).reshape(b, -1, 2)
    wa, wb = red[..., 0] * _R2 % _P, red[..., 1] * _R1 % _P
    words = torch.stack([wa, (wa << 32) // _P, wb, (wb << 32) // _P], dim=-1)
    return state, pending, digests, _as_int32(words.reshape(b, 2 * challenges))


def sample_indices_plain(state: torch.Tensor, pending: torch.Tensor, q: int,
                         size: int, reduced: int, number: int, m: int):
    """K10's plain version: (B, 32) sponge states with q pending bytes ->
    ((B, number) int32 indices, (B,) int32 counts).  Per lane the seed
    challenge's 8 bytes, the seed H(them), the m candidates H(seed || c as
    LE u32), low32 their last four digest bytes most significant first;
    the candidates whose low32 mod ``reduced`` is its first occurrence
    among them are accepted in order, up to ``number`` of them, each
    giving low32 mod ``size`` (0 past the count) (stark_tpu's
    sample_indices_core)."""
    b, dev = state.shape[0], state.device
    challenge = sponge_state_plain(state, pending, q)[:, :8]
    seed = _hash_chunks(challenge.T.contiguous())                     # (32, B)
    c = torch.arange(m, dtype=torch.int64, device=dev)
    ctr = torch.stack([(c >> s) & 0xFF for s in (0, 8, 16, 24)]).to(torch.uint8)
    msg = torch.cat([seed[:, :, None].expand(32, b, m), ctr[:, None, :].expand(4, b, m)])
    st = _hash_chunks(msg.reshape(36, b * m)).long().reshape(32, b, m)
    low32 = st[28] << 24 | st[29] << 16 | st[30] << 8 | st[31]         # (B, M)
    red = low32 % reduced
    earlier = torch.ones((m, m), dtype=torch.bool, device=dev).tril(-1)
    first = ~((red[:, :, None] == red[:, None, :]) & earlier).any(-1)
    pos = torch.cumsum(first.long(), 1) - 1
    take = first & (pos < number)
    out = torch.zeros((b, number + 1), dtype=torch.int64, device=dev)
    out.scatter_(1, torch.where(take, pos, number), torch.where(take, low32 % size, 0))
    return out[:, :number].to(torch.int32), take.sum(1).to(torch.int32)


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
    share it; launches on two streams may overlap and get a word each.  A
    captured graph takes words of its own instead (:func:`own_tickets`)."""
    return torch.zeros(1, dtype=torch.int32, device=device)


#: The ticket words that K8 and K8-forest take in place of their stream's,
#: innermost last (:func:`own_tickets`).
_OWN_TICKETS: list[torch.Tensor] = []


@contextlib.contextmanager
def own_tickets(words: torch.Tensor):
    """Within the block, K8 and K8-forest take their ticket counters from
    ``words`` ((FOREST_MAX_TREES,) int32 zeros on the launches' device,
    K8 its first word) in place of their stream's: the words of one CUDA
    graph (stark.py's slots), which it holds at their addresses for as long
    as it lives, and which no other graph's replay can touch.  The
    launches leave them at zero."""
    if tuple(words.shape) != (FOREST_MAX_TREES,) or words.dtype != torch.int32:
        raise ValueError(f"ticket words must be ({FOREST_MAX_TREES},) int32")
    _OWN_TICKETS.append(words)
    try:
        yield
    finally:
        _OWN_TICKETS.pop()


def _check_lanes(lanes: int | None) -> int:
    lanes = TAIL_LANES if lanes is None else lanes
    if lanes not in LANE_CHOICES:
        raise ValueError(f"lanes must be one of {LANE_CHOICES}, got {lanes}")
    return lanes


def merkle_tail(nodes: torch.Tensor, out: torch.Tensor | None = None,
                lg_sub: int | None = None, lanes: int | None = None) -> torch.Tensor:
    """K8: (W, 32) node digests, W a power of two -> (W - 1, 32), every
    level above them (widest first, the root last).  One launch for W up
    to 2^(2 TAIL_MAX_LG): a block per subtree, the top by the block that
    finishes last (``tail_launches``; ``lg_sub`` fixes the subtree size).
    A level narrower than the block spreads each hash over up to ``lanes``
    lanes (``tail_lanes``; default TAIL_LANES): the same digests."""
    _check_digests(nodes, "nodes")
    w = nodes.shape[0]
    if not _pow2(w):
        raise ValueError(f"a subtree needs a power-of-two width, got {w}")
    if lg_sub is not None and not 1 <= lg_sub <= TAIL_MAX_LG:
        raise ValueError(f"lg_sub must be in 1..{TAIL_MAX_LG}, got {lg_sub}")
    lanes = _check_lanes(lanes)
    out = _output(out, w - 1, nodes)
    if nodes.device.type == "cpu":
        out.copy_(merkle_tail_plain(nodes, lg_sub))
        return out
    _check_card_digests(nodes, "nodes")
    _check_card_digests(out, "out")
    stream = torch.cuda.current_stream(nodes.device).cuda_stream
    ticket = _OWN_TICKETS[-1][:1] if _OWN_TICKETS else _ticket(nodes.device, stream)
    src, pos = nodes, 0
    for sub, top in tail_launches(w.bit_length() - 1, lg_sub):
        try:
            MERKLE_TAIL.launch(
                nodes.device, src.data_ptr(), out[pos:].data_ptr(), w, sub,
                top, ticket.data_ptr(), lanes,
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


#: The most trees one K8-forest launch takes (its ticket words).
FOREST_MAX_TREES = 1 << 12


@functools.lru_cache(maxsize=64)
def _tickets(device: torch.device, stream: int) -> torch.Tensor:
    """K8-forest's ticket counters, one word a tree, for the launches on
    one stream of ``device`` (as _ticket)."""
    return torch.zeros(FOREST_MAX_TREES, dtype=torch.int32, device=device)


def merkle_forest(nodes: torch.Tensor, trees: int,
                  out: torch.Tensor | None = None,
                  lg_sub: int | None = None, lanes: int | None = None) -> torch.Tensor:
    """K8 for a forest: (B n, 32) digests of ``trees`` = B trees of width
    n, a power of two -> (B n - B, 32), every level above them, each
    level the trees' shares side by side, the B roots last.  One launch
    for n up to 2^(2 TAIL_MAX_LG): a block per subtree, each tree's top by
    its block that finishes last (``tail_launches``); ``lanes`` as in
    merkle_tail."""
    _check_digests(nodes, "nodes")
    w = nodes.shape[0]
    n = w // trees if trees > 0 else 0
    if trees < 1 or n * trees != w or not _pow2(n):
        raise ValueError(f"{w} digests are not {trees} trees of a power-of-two width")
    if trees > FOREST_MAX_TREES:
        raise ValueError(f"at most {FOREST_MAX_TREES} trees, got {trees}")
    if lg_sub is not None and not 1 <= lg_sub <= TAIL_MAX_LG:
        raise ValueError(f"lg_sub must be in 1..{TAIL_MAX_LG}, got {lg_sub}")
    lanes = _check_lanes(lanes)
    out = _output(out, w - trees, nodes)
    if nodes.device.type == "cpu":
        out.copy_(forest_tail_plain(nodes, trees))
        return out
    _check_card_digests(nodes, "nodes")
    _check_card_digests(out, "out")
    stream = torch.cuda.current_stream(nodes.device).cuda_stream
    tickets = _OWN_TICKETS[-1] if _OWN_TICKETS else _tickets(nodes.device, stream)
    src, pos = nodes, 0
    for sub, top in tail_launches(w.bit_length() - 1, lg_sub, n.bit_length() - 1):
        try:
            MERKLE_FOREST.launch(
                nodes.device, src.data_ptr(), out[pos:].data_ptr(), w, sub,
                top, tickets.data_ptr(), lanes,
            )
        except RuntimeError:
            tickets.zero_()  # as in merkle_tail
            raise
        left = w >> (sub + top)
        pos += w - left
        src, w = out[pos - left : pos], left
    return out


def forest_build(stack: torch.Tensor, trees: int = 1) -> torch.Tensor:
    """Fill a forest's level stack in place: ``stack`` is (2W - B, 32) for
    ``trees`` = B trees of width W / B (B = 1: a tree, (2W - 1, 32)), with
    the W leaf digests in its first W rows; every level above is written
    behind them, the B roots last.  Levels wider than TAIL_CUTOVER come
    from K7; the rest from K8, or K8-forest where B > 1."""
    _check_digests(stack, "stack")
    w = (stack.shape[0] + trees) // 2
    n = w // trees if trees > 0 else 0
    if trees < 1 or n * trees != w or not _pow2(n) or stack.shape[0] != 2 * w - trees:
        raise ValueError(f"a level stack of {trees} trees has 2W - {trees} rows, "
                         f"got {stack.shape[0]}")
    pos = 0
    while w > TAIL_CUTOVER and w > trees:
        merkle_level(stack[pos : pos + w], stack[pos + w : pos + w + w // 2])
        pos += w
        w //= 2
    if w > trees:
        if trees == 1:
            merkle_tail(stack[pos : pos + w], stack[pos + w :])
        else:
            merkle_forest(stack[pos : pos + w], trees, stack[pos + w :])
    return stack


def merkle_build(stack: torch.Tensor) -> torch.Tensor:
    """Fill a level stack in place: ``stack`` is (2W - 1, 32) with the W
    leaf digests in its first W rows; every level above is written behind
    them, the root last.  Levels wider than TAIL_CUTOVER come from K7, the
    rest from K8."""
    return forest_build(stack, 1)


class Sponge:
    """K9's state for B transcripts (lanes): ``state`` (B, 32) u8, the hash
    state after each lane's full 32-byte chunks, and ``pending`` (B, 32)
    u8 whose first ``q`` bytes are the tail after them (the same q for
    every lane: the lanes absorb the same lengths).  Its launches go on the
    tensors' device; on the CPU the plain version runs.  K4-dyn
    (ops/fold.fold_dyn) does not update in place: it writes the next state
    and pending into ``next_state`` and ``next_pending`` (a lane's other
    blocks read the current ones meanwhile), and :meth:`swap` makes them
    current."""

    def __init__(self, lanes: int, device):
        self.state = torch.empty((lanes, 32), dtype=torch.uint8, device=device)
        self.pending = torch.zeros((lanes, 32), dtype=torch.uint8, device=device)
        self.next_state = torch.empty_like(self.state)
        self.next_pending = torch.zeros_like(self.pending)
        self.q = 0
        self.fresh = True

    @property
    def lanes(self) -> int:
        return int(self.state.shape[0])

    def advance(self, m: int) -> None:
        """Account for ``m`` bytes absorbed."""
        self.q = (self.q + m) % 32
        self.fresh = False

    def swap(self, m: int) -> None:
        """Make ``next_state`` and ``next_pending`` current, after ``m``
        bytes absorbed into them."""
        self.state, self.next_state = self.next_state, self.state
        self.pending, self.next_pending = self.next_pending, self.pending
        self.advance(m)

    def absorb(self, data: torch.Tensor, copy: torch.Tensor | None = None,
               alpha: torch.Tensor | None = None) -> None:
        """Append ``data`` ((B, m) u8, row b to lane b); write the bytes
        also into ``copy`` ((B, m) u8) and, with ``alpha`` ((B,) int32),
        each lane's challenge mod p after them (the first 8 bytes of the
        hash of every byte so far, a little-endian u64)."""
        b, m = self.lanes, int(data.shape[1]) if data.dim() == 2 else -1
        for t, name in ((data, "data"), (copy, "copy")):
            if t is not None and (t.dtype != torch.uint8 or tuple(t.shape) != (b, m)
                                  or t.device != self.state.device):
                raise ValueError(f"{name} must be ({b}, m) u8 on {self.state.device}, "
                                 f"got {tuple(t.shape)} {t.dtype} on {t.device}")
        if alpha is not None and (alpha.dtype != torch.int32 or tuple(alpha.shape) != (b,)
                                  or alpha.device != self.state.device):
            raise ValueError(f"alpha must be ({b},) int32 on {self.state.device}")
        if self.state.device.type == "cpu":
            state, pending, got = sponge_absorb_plain(self.state, self.pending, self.q,
                                                      data, self.fresh)
            self.state.copy_(state)
            self.pending.copy_(pending)
            if copy is not None:
                copy.copy_(data)
            if alpha is not None:
                alpha.copy_(got)
        else:
            for t, name in ((data, "data"), (copy, "copy"), (alpha, "alpha")):
                if t is not None:
                    cuda.check_operand(t, name, t.dtype)
            SPONGE.launch(
                self.state.device, self.state.data_ptr(), self.pending.data_ptr(),
                self.q, int(self.fresh), data.data_ptr(), m,
                None if copy is None else copy.data_ptr(),
                None if alpha is None else alpha.data_ptr(), b,
            )
        self.advance(m)


def constraint_challenges(roots: torch.Tensor, challenges: int, sponge: "Sponge",
                          copy: torch.Tensor, digests: torch.Tensor,
                          weights: torch.Tensor) -> None:
    """K15: each lane's trace root ((B, 32) u8, the trace forest's roots)
    into a fresh ``sponge`` of B lanes, then ``challenges`` challenges drawn
    and absorbed; writes the roots into ``copy`` ((B, 32) u8), the
    challenges' bytes into ``digests`` ((B, challenges, 8) u8), K11's
    weight words into ``weights`` ((B, 2 challenges) int32), and leaves the
    sponge after the last challenge's bytes (constraint_challenges_plain
    on the CPU)."""
    b = sponge.lanes
    if challenges < 0 or challenges % 2:
        raise ValueError(f"challenges come in pairs, got {challenges}")
    for t, name, shape, dtype in ((roots, "roots", (b, 32), torch.uint8),
                                  (copy, "copy", (b, 32), torch.uint8),
                                  (digests, "digests", (b, challenges, 8), torch.uint8),
                                  (weights, "weights", (b, 2 * challenges), torch.int32)):
        if tuple(t.shape) != shape or t.dtype != dtype or t.device != sponge.state.device:
            raise ValueError(f"{name} must be {shape} {dtype} on {sponge.state.device}, "
                             f"got {tuple(t.shape)} {t.dtype} on {t.device}")
    if sponge.state.device.type == "cpu":
        state, pending, digs, words = constraint_challenges_plain(roots, challenges)
        sponge.state.copy_(state)
        sponge.pending.copy_(pending)
        copy.copy_(roots)
        digests.copy_(digs)
        weights.copy_(words)
    else:
        for t, name in ((roots, "roots"), (copy, "copy"), (digests, "digests"),
                        (weights, "weights")):
            cuda.check_operand(t, name, t.dtype)
        CHALLENGES.launch(
            sponge.state.device, roots.data_ptr(), sponge.state.data_ptr(),
            sponge.pending.data_ptr(), copy.data_ptr(), digests.data_ptr(),
            weights.data_ptr(), challenges, b,
        )
    sponge.q = 8 * challenges % 32
    sponge.fresh = False


def sample_indices(sponge: "Sponge", size: int, reduced: int, number: int, m: int,
                   out: torch.Tensor, count: torch.Tensor) -> None:
    """K10: ``number`` FRI query indices a lane from the sponge after the
    last root, out of ``m`` candidates, into ``out`` ((B, number) int32),
    and how many were found into ``count`` ((B,) int32): fewer than
    ``number`` where the candidates give fewer distinct indices mod
    ``reduced`` (sample_indices_plain on the CPU).  ``size`` and
    ``reduced`` are powers of two, reduced at most SAMPLE_MAX_REDUCED."""
    b = sponge.lanes
    if sponge.fresh:
        raise ValueError("the sponge has absorbed nothing")
    if not (_pow2(size) and _pow2(reduced) and reduced <= SAMPLE_MAX_REDUCED
            and 1 <= number <= reduced and m >= 0 and size < 1 << 31):
        raise ValueError(f"sampling {number} of {m} candidates, size {size}, reduced "
                         f"{reduced}: out of range")
    for t, name, shape in ((out, "out", (b, number)), (count, "count", (b,))):
        if tuple(t.shape) != shape or t.dtype != torch.int32 or \
                t.device != sponge.state.device:
            raise ValueError(f"{name} must be {shape} int32 on {sponge.state.device}")
    if sponge.state.device.type == "cpu":
        idx, cnt = sample_indices_plain(sponge.state, sponge.pending, sponge.q, size,
                                        reduced, number, m)
        out.copy_(idx)
        count.copy_(cnt)
        return
    cuda.check_operand(out, "out")
    cuda.check_operand(count, "count")
    SAMPLE.launch(sponge.state.device, sponge.state.data_ptr(), sponge.pending.data_ptr(),
                  sponge.q, size, reduced, number, m, out.data_ptr(), count.data_ptr(), b)


def level_offset(num_leaves: int, level: int) -> int:
    """Row of level ``level``'s first node in a level stack."""
    return 2 * num_leaves - ((2 * num_leaves) >> level)


def digests_to_bytes(digests: torch.Tensor) -> np.ndarray:
    """(N, 32) u8 digest tensor -> (N, 32) u8 host array."""
    return digests.cpu().numpy()


def bytes_to_digests(arr: np.ndarray, device) -> torch.Tensor:
    """(N, 32) u8 host array -> (N, 32) u8 digest tensor on ``device``."""
    return torch.from_numpy(np.ascontiguousarray(arr, dtype=np.uint8)).to(device)
