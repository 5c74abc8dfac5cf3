"""The Fiat-Shamir sponge over 8 lanes (csrc/hash.cuh split_close,
split_absorb_short, split_absorb_prefix) as K15 (stark_constraint_challenges)
and K10 (stark_sample_indices) run it, in a numpy model that computes what
each lane of a group computes, in uint32 arithmetic (the bits above a state
byte's low 8 left as they fall), each cross-lane read the shuffle the
kernel makes: lane r holds state bytes 4r .. 4r + 3 and the pending tail's
word r; a draw's 8 digest bytes come from lanes 0 and 1 to every lane,
which absorbs them itself from the state's words at their positions; a
full chunk every fourth draw; the reductions after each window of draws.
K10's model hashes the candidates' first chunk (the seed, absorbed and
mixed) once, then a candidate's counter and its 9 mixes, in passes of the
block's groups, walked 32 at a time.

Held against stark_tpu's sponge_from_bytes, sponge_absorb, sponge_state,
state_alpha and _device_challenges_fn (K15 at 0, 2, 6, 32 and 40
challenges; with the window of raw draws a group keeps, at a window less
a pair, one window, a pair past it and two windows and three pairs, draw
by draw through the sponge functions), seed_digest_rows_from_state and sample_indices_core (K10 at
every pending length a prove gives, a shortfall, no candidates, and a
candidate count that is no multiple of a pass), and against the port's
plain versions.  Tolerance zero: bytes and integers."""

import numpy as np
import pytest
import torch

from chip_smoke import _sample_pass as sample_pass  # K10's pass, as hash.cu sizes its block
from stark_tpu_torch.ops import hash_batch as HB
from stark_tpu_torch.ops.fieldops import P
from test_torch_hash_merkle import _PRIMES, _fetch7, _positions, _select, _split_absorb, \
    _split_mix

POS = _positions(8)  # (8, 4): lane r's positions 4r .. 4r + 3
LOW = POS < 7
R1 = (1 << 32) % P
R2 = R1 * R1 % P
KPRIME0 = 2 | 3 << 8 | 5 << 16 | 7 << 24  # the initial state's words 0 and 1
KPRIME1 = 11 | 13 << 8 | 17 << 16 | 19 << 24


def _u32(x):
    return np.uint32(x)


def _init(n: int) -> np.ndarray:
    return np.broadcast_to(_PRIMES[POS & 15], (n, 8, 4)).astype(np.uint32)


def _words(s: np.ndarray) -> np.ndarray:
    """(N, 8, 4) split states -> (N, 8): each lane's bytes as one word."""
    b = s & _u32(0xFF)
    return b[..., 0] | b[..., 1] << _u32(8) | b[..., 2] << _u32(16) | b[..., 3] << _u32(24)


def _bytes(words: np.ndarray) -> np.ndarray:
    """(N, k) little-endian words -> (N, 4 k) u8."""
    return words.astype("<u4").view(np.uint8).reshape(words.shape[0], -1)


def _rot(t):
    return _select(0xF8, t << _u32(3), t >> _u32(5))


def _close(s: np.ndarray, mixes: int) -> np.ndarray:
    """split_close: ``mixes`` rounds, kOwed between them."""
    s = _split_mix(s, 8, "bytes", "owed")
    for _ in range(mixes - 2):
        s = _split_mix(s, 8, "owed", "owed")
    return _split_mix(s, 8, "owed", "bytes")


def _absorb_short(s, at0, at1, d0, d1, q: int, n: int) -> np.ndarray:
    """split_absorb_short<n>: every lane computes the absorb of the n bytes
    at q .. q + n - 1 from the state's words at0, at1 ((N,) each, at
    positions q and q + 4) and the data's d0, d1, then keeps what falls on
    its own positions (o = 4 ((r - q / 4) mod 8) + j from q)."""
    v = []
    for i in range(n):
        a = (at0 if i < 4 else at1) >> _u32(8 * (i & 3))
        if i >= 7:
            a = a ^ v[i - 7]
        v.append(_rot(a + ((d0 if i < 4 else d1) >> _u32(8 * (i & 3)))))
    delta = (np.arange(8) - q // 4) & 7
    out = s.copy()
    for j in range(4):
        for d in range(4):
            o = 4 * d + j
            if o < n:
                val = np.broadcast_to(v[o][:, None], s.shape[:2])
            elif 7 <= o < n + 7:
                val = s[:, :, j] ^ v[o - 7][:, None]
            else:
                continue
            out[:, :, j] = np.where(delta == d, val, out[:, :, j])
    return out


def _absorb_prefix(s: np.ndarray, d: np.ndarray, n: int) -> np.ndarray:
    """split_absorb_prefix: bytes 0 .. n - 1 of the chunk d ((N, 8, 4)) in
    ceil(n / 7) waves, the positions past n taking only the XOR of the byte
    7 before them."""
    inside = POS < n
    x = np.zeros_like(s)
    v = np.zeros_like(s)
    for _ in range((n + 6) // 7):
        v = np.where(inside, _rot((s ^ np.where(LOW, _u32(0), x)) + d), _u32(0))
        x = _fetch7(v, 8)
    return np.where(inside, v ^ np.where(LOW, x, _u32(0)), s ^ x)


def _pair_words(raws: np.ndarray) -> np.ndarray:
    """(N, 2 k, 2) raw draw words -> (N, k, 4) K11 weight words a pair: a
    R^2 mod p, its Shoup companion, b R mod p, its companion."""
    n = raws.shape[0]
    raw = raws[..., 0].astype(np.uint64) | raws[..., 1].astype(np.uint64) << np.uint64(32)
    red = (raw % np.uint64(P)).reshape(n, -1, 2)
    wa, wb = red[..., 0] * np.uint64(R2) % np.uint64(P), red[..., 1] * np.uint64(R1) % np.uint64(P)
    return np.stack([wa, (wa << np.uint64(32)) // np.uint64(P),
                     wb, (wb << np.uint64(32)) // np.uint64(P)], axis=-1).astype(np.uint32)


def challenges_model(roots: np.ndarray, challenges: int, window: int = HB.CHALLENGE_WINDOW):
    """K15 as its 8-lane groups compute it: (N, 32) u8 roots -> (state,
    pending, digests, weights) as constraint_challenges_plain gives them.
    A group keeps ``window`` draws' raw words (hash.cu kChallengeWindow);
    after a window's last draw lane r stores its pairs r, r + 8, ..., and
    the next window's draws take the buffer again."""
    n = roots.shape[0]
    a = _split_absorb(_init(n), roots.reshape(n, 8, 4).astype(np.uint32), 8)
    a = _split_mix(a, 8, "bytes", "bytes")
    s, pend = a.copy(), np.zeros((n, 8), np.uint32)
    kept = np.zeros((n, min(challenges, window), 2), np.uint32)  # the group's buffer
    raws = np.zeros((n, challenges, 2), np.uint32)  # digests, as stored
    words = np.zeros((n, challenges // 2, 4), np.uint32)
    delta = np.arange(8)
    for base in range(0, challenges, window):
        end = min(base + window, challenges)
        for k in range(base, end):
            q = 8 * k % 32
            word = _words(a)
            at0, at1 = word[:, q // 4], word[:, q // 4 + 1]  # fetched before the mixes
            dig = _words(_close(a.copy(), 9 if q else 8))
            d0, d1 = dig[:, 0], dig[:, 1]  # from lanes 0 and 1, to every lane
            kept[:, k - base] = np.stack([d0, d1], axis=1)
            a = _absorb_short(a, at0, at1, d0, d1, q, 8)
            lane = (delta - q // 4) & 7
            pend = np.where(lane == 0, d0[:, None], np.where(lane == 1, d1[:, None], pend))
            if q == 24:
                a = _split_mix(a, 8, "bytes", "bytes")
                s, pend = a.copy(), np.zeros_like(pend)
        pairs = kept[:, : end - base].reshape(n, -1, 2, 2)  # the window's pairs
        for r in range(8):  # lane r: pairs r, r + 8, ... of the window
            at = base // 2 + r
            raws.reshape(n, -1, 2, 2)[:, at : end // 2 : 8] = pairs[:, r::8]
            words[:, at : end // 2 : 8] = _pair_words(pairs[:, r::8].reshape(n, -1, 2))
    return (_bytes(_words(s)), _bytes(pend), _bytes(raws.reshape(n, -1)).reshape(n, -1, 8),
            words.reshape(n, -1))


def sample_model(state, pending, q, size, reduced, number, m):
    """K10 as its block computes it: (N, 32) u8 sponges with a q-byte tail
    -> ((N, number) u32 indices, (N,) counts, the seeds)."""
    n = state.shape[0]
    s = _absorb_prefix(state.reshape(n, 8, 4).astype(np.uint32),
                       pending.reshape(n, 8, 4).astype(np.uint32), q)
    dig = _words(_close(s, 9 if q else 8))
    h = _absorb_short(_init(n), np.full(n, KPRIME0, np.uint32), np.full(n, KPRIME1, np.uint32),
                      dig[:, 0], dig[:, 1], 0, 8)
    seed = _close(h, 9)
    first = _split_mix(_split_absorb(_init(n), seed & _u32(0xFF), 8), 8, "bytes", "bytes")
    head = _words(first)[:, 0]  # shared memory's word 0: every lane reads it
    per = sample_pass(number, m)
    out = np.zeros((n, number), np.uint32)
    counts = np.zeros(n, np.int64)
    for b in range(n):
        seen, found = set(), 0
        for base in range(0, m, per):
            if found >= number:
                break
            c = np.arange(base, base + per, dtype=np.uint32)
            st = _absorb_short(np.broadcast_to(first[b], (per, 8, 4)).copy(),
                               np.full(per, head[b], np.uint32), np.zeros(per, np.uint32),
                               c, np.zeros(per, np.uint32), 0, 4)
            w = _words(_close(st, 9))[:, 7]  # lane 7: digest bytes 28 .. 31
            low = w.byteswap()  # most significant first
            for sub in range(0, per, 32):  # the walking warp, 32 at a time
                if found >= number:
                    break
                group = [i for i in range(sub, sub + 32) if i < per and base + i < m]
                red = [int(low[i]) & (reduced - 1) for i in group]
                ok = [red[k] not in red[:k] and red[k] not in seen for k in range(len(group))]
                for k, i in enumerate(group):
                    pos = found + sum(ok[:k])
                    if ok[k] and pos < number:
                        out[b, pos] = int(low[i]) & (size - 1)
                seen.update(r for r, o in zip(red, ok) if o)
                found += sum(ok)
        counts[b] = min(found, number)
    return out, counts, seed


def _rand_bytes(seed: int, shape) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, size=shape, dtype=np.uint8)


@pytest.mark.parametrize("challenges", [0, 2, 6, 32, 40])
def test_split_sponge_model_equals_stark_tpu(challenges):
    import jax.numpy as jnp
    from stark_tpu.ops import hash_batch as JHB
    from stark_tpu.stark import _device_challenges_fn

    roots = _rand_bytes(100 + challenges, (3, 32))
    roots[0] = 0
    state, pending, digests, words = challenges_model(roots, challenges)
    q = 8 * challenges % 32
    for b in range(3):
        if challenges == 0:
            j_state, j_pending = JHB.sponge_from_bytes(jnp.asarray(roots[b]))
            assert j_pending.shape[0] == 0
        else:
            digs, alphas, j_state, j_pending = _device_challenges_fn(challenges)(
                jnp.asarray(roots[b]))
            np.testing.assert_array_equal(digests[b], np.asarray(digs))
            raw = digests[b].view("<u8").reshape(-1)
            assert [int(x) % P for x in raw] == [int(a) for a in np.asarray(alphas)]
            np.testing.assert_array_equal(pending[b, :q], np.asarray(j_pending).reshape(-1))
        np.testing.assert_array_equal(state[b], np.asarray(j_state).reshape(32))
        assert not pending[b, q:].any()
    # Draw by draw through stark_tpu's sponge: each digest the sponge's state
    # after every byte before it, its alpha state_alpha's.
    if challenges <= 6:
        st, pd = JHB.sponge_from_bytes(jnp.asarray(roots[1]))
        for k in range(challenges):
            fin = JHB.sponge_state(st, pd)
            np.testing.assert_array_equal(digests[1, k], np.asarray(fin[:8]).reshape(-1))
            alpha = int(np.asarray(JHB.state_alpha([fin[j] for j in range(8)])))
            assert alpha == int(digests[1, k].view("<u8")[0]) % P
            st, pd = JHB.sponge_absorb(st, pd, jnp.asarray(digests[1, k]))
    got = HB.constraint_challenges_plain(torch.from_numpy(roots), challenges)
    for mine, plain in zip((state, pending, digests, words.view(np.int32)), got):
        np.testing.assert_array_equal(mine, plain.numpy())


@pytest.mark.parametrize("q", [0, 8, 16, 24])
def test_absorb_short_equals_the_one_lane_absorb(q):
    # Eight bytes at q .. q + 7 into a state with q pending bytes absorbed
    # are the tail's absorb continued: the one-lane hash's absorb of q + 8
    # bytes (a whole chunk at q = 24, the bytes 25 .. 31 reaching 0 .. 6).
    rng = np.random.default_rng(q)
    n = 64
    base = rng.integers(0, 256, size=(n, 32), dtype=np.uint8)
    data = rng.integers(0, 256, size=(n, 32), dtype=np.uint8)
    s = _absorb_prefix(base.reshape(n, 8, 4).astype(np.uint32),
                       data.reshape(n, 8, 4).astype(np.uint32), q)
    word = _words(s)
    dw = data.view("<u4")
    got = _absorb_short(s, word[:, q // 4], word[:, q // 4 + 1], dw[:, q // 4],
                        dw[:, q // 4 + 1], q, 8)
    want = _absorb_prefix(base.reshape(n, 8, 4).astype(np.uint32),
                          data.reshape(n, 8, 4).astype(np.uint32), q + 8)
    np.testing.assert_array_equal(got & _u32(0xFF), want & _u32(0xFF))
    ref = HB._absorb(torch.from_numpy(base.T.copy()),
                     torch.from_numpy(data[:, : q + 8].T.copy())).T.numpy()
    np.testing.assert_array_equal((want & _u32(0xFF)).astype(np.uint8).reshape(n, 32), ref)


# (size, reduced, tests, candidates): the main path's; a pool that falls
# short; none; 200 candidates in passes of 128.
SAMPLE_CASES = [(1 << 21, 128, 16, 64), (1 << 10, 16, 16, 20), (1 << 10, 64, 8, 0),
                (1 << 12, 1024, 150, 200)]


@pytest.mark.parametrize("q", [0, 8, 16, 24])
@pytest.mark.parametrize("size, reduced, number, m", SAMPLE_CASES)
def test_hoisted_sampler_model_equals_stark_tpu(size, reduced, number, m, q):
    import jax.numpy as jnp
    from stark_tpu.ops import hash_batch as JHB

    prefix = _rand_bytes(q + m, (2, 64 + q))
    sp = HB.Sponge(2, "cpu")
    sp.absorb(torch.from_numpy(prefix.copy()))
    assert sp.q == q
    idx, count, seed = sample_model(sp.state.numpy(), sp.pending.numpy(), q, size, reduced,
                                    number, m)
    for b in range(2):
        state, pending = JHB.sponge_from_bytes(jnp.asarray(prefix[b]))
        rows = JHB.seed_digest_rows_from_state(JHB.sponge_state(state, pending))
        np.testing.assert_array_equal(
            (seed[b] & _u32(0xFF)).reshape(32), [int(np.asarray(r).reshape(())) for r in rows])
        if m:
            want, want_count = JHB.sample_indices_core(rows, m, size, reduced, number)
            np.testing.assert_array_equal(idx[b], np.asarray(want))
            assert count[b] == int(want_count)
    want, want_count = HB.sample_indices_plain(sp.state, sp.pending, q, size, reduced, number, m)
    np.testing.assert_array_equal(idx.view(np.int32), want.numpy())
    np.testing.assert_array_equal(count, want_count.numpy())
    if m < number or (reduced, m) == (16, 20):
        assert (count < number).all()  # the pool falls short
    if m > 128:
        assert sample_pass(number, m) == 128 and m % 128


@pytest.mark.parametrize("number, m, want", [(16, 64, 32), (16, 20, 20), (8, 0, 4),
                                             (300, 632, 128), (150, 200, 128), (1, 1, 4),
                                             (33, 40, 40)])
def test_sample_pass(number, m, want):
    # A pass is no wider than the tests need (rounded up to a warp's walk)
    # or the candidates, whole warps of 8-lane groups, at most 128.
    assert sample_pass(number, m) == want


@pytest.mark.parametrize("challenges", [7266, 3 * HB.CHALLENGE_WINDOW + 6])
def test_challenges_past_a_window_reach_the_launch(monkeypatch, challenges):
    # No count is refused: past 7,264 (what a block's shared memory held
    # when it kept a whole chain) and past several windows, the wrapper
    # hands the count to the launch (a meta tensor stands in for a card
    # that is not there; the launch and the operand check record instead).
    dev, b = torch.device("meta"), 5
    launched = []
    monkeypatch.setattr(HB.cuda, "check_operand", lambda t, name, dtype=None: None)
    monkeypatch.setattr(HB.CHALLENGES, "launch", lambda *args: launched.append(args))
    sp = HB.Sponge(b, dev)
    HB.constraint_challenges(
        torch.empty((b, 32), dtype=torch.uint8, device=dev), challenges, sp,
        torch.empty((b, 32), dtype=torch.uint8, device=dev),
        torch.empty((b, challenges, 8), dtype=torch.uint8, device=dev),
        torch.empty((b, 2 * challenges), dtype=torch.int32, device=dev))
    assert len(launched) == 1 and launched[0][0] == dev
    assert launched[0][-2:] == (challenges, b)
    assert (sp.q, sp.fresh) == (8 * challenges % 32, False)


def test_the_window_is_the_kernels():
    # hash_batch.CHALLENGE_WINDOW names csrc/hash.cu's kChallengeWindow, the
    # window the model and the card shapes are chosen around.
    import os
    import re

    from stark_tpu_torch.ops import cuda

    with open(os.path.join(cuda.CSRC, "hash.cu")) as f:
        got = re.findall(r"constexpr int kChallengeWindow = (\d+);", f.read())
    assert got == [str(HB.CHALLENGE_WINDOW)]


def _stark_tpu_draws(root: np.ndarray, counts: tuple) -> dict:
    """stark_tpu's sponge draw by draw from a fresh sponge holding ``root``
    (sponge_from_bytes, then sponge_state and sponge_absorb a draw, each
    jitted once for every pending length): count -> (the digests so far,
    state, pending) at each of ``counts``."""
    import jax
    import jax.numpy as jnp
    from stark_tpu.ops import hash_batch as JHB

    @jax.jit
    def draw(state, pending):
        digest8 = JHB.sponge_state(state, pending)[:8]
        return (digest8,) + tuple(JHB.sponge_absorb(state, pending, digest8))

    state, pending = JHB.sponge_from_bytes(jnp.asarray(root))
    digests, at = [], {}
    for k in range(max(counts)):
        digest8, state, pending = draw(state, pending)
        digests.append(np.asarray(digest8).reshape(8))
        if k + 1 in counts:
            at[k + 1] = (np.stack(digests), np.asarray(state).reshape(32),
                         np.asarray(pending).reshape(-1))
    return at


W = HB.CHALLENGE_WINDOW
WINDOW_COUNTS = (W - 2, W, W + 2, 2 * W + 6)


@pytest.fixture(scope="module")
def window_reference():
    roots = _rand_bytes(W, (2, 32))
    return roots, _stark_tpu_draws(roots[1], WINDOW_COUNTS)


@pytest.mark.parametrize("challenges", WINDOW_COUNTS)
def test_windowed_model_equals_stark_tpu(window_reference, challenges):
    # Short of a window, one window, one pair past it, two windows and
    # three pairs: the draws a window's flush stores and the weight words
    # it reduces are stark_tpu's, the sponge after them too.
    roots, ref = window_reference
    state, pending, digests, words = challenges_model(roots, challenges)
    want_digests, want_state, want_pending = ref[challenges]
    q = 8 * challenges % 32
    np.testing.assert_array_equal(digests[1], want_digests)
    np.testing.assert_array_equal(state[1], want_state)
    np.testing.assert_array_equal(pending[1, :q], want_pending)
    assert not pending[:, q:].any()
    raws = want_digests.view("<u4").reshape(1, -1, 2)
    np.testing.assert_array_equal(words[1], _pair_words(raws).reshape(-1))
    # Row 0 gets its own chain: the groups of a block do not share windows.
    assert not np.array_equal(digests[0], digests[1])
