"""The device witnesses (kernel K12, ops/witness.py; models.fibonacci_trace
_cols_device, models.examples.mds_square_trace_cols_device) and the C seed
walk against stark_tpu: on the CPU the plain versions equal stark_tpu's
functions and the host traces, at lengths that are not powers of two, at
awkward start pairs of the Fibonacci run and at several MDS block sizes;
the MDS proof from device columns equals the one from host rows and
stark_tpu's.  On a card, each kernel equals its plain version, and the
Fibonacci witness, its length's basis made, runs without a synchronizing
call.  Tolerance zero: every value is an exact integer mod p."""

import hashlib
import os
import re

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from stark_tpu_torch import StarkConfig, StarkProver, StarkVerifier, native
from stark_tpu_torch.models import examples as ex
from stark_tpu_torch.models import fibonacci as FIB
from stark_tpu_torch.models.fibonacci import (
    fibonacci_seeds,
    fibonacci_segment_cols_device,
    fibonacci_trace_cols_device,
    fibonacci_trace_mod_p,
)
from stark_tpu_torch.ops import cuda
from stark_tpu_torch.ops import witness as W
from stark_tpu_torch.ops.fieldops import P
from torch_port_support import cuda_device, rand_field, to_numpy, to_torch  # noqa: F401

FIB_LENGTHS = [1, 2, 3, 1000, 1024]
#: Start pairs of the Fibonacci run: the default statement's, the awkward
#: ones and one drawn from a seed.
FIB_STARTS = [(1, 1), (0, 0), (0, 1), (P - 1, P - 1),
              tuple(int(v) for v in np.random.default_rng(26).integers(0, P, 2))]
MDS_LENGTHS = [1, 5, 64, 1000]
MDS_BLOCKS = [1, 7, 64]
# sha256 of stark_tpu's MdsSquareAir proof at T=1024, blowup 4, 16 tests,
# from prove(trace_cols=mds_square_trace_cols_device(1024)) on the CPU (its
# trace-rows proof has the same bytes; chip_smoke.py pins it too).
MDS_1024 = "97cf6cf94a41c0df3c285c34e497c315a14e4083e3897632b1d76e39109f61a6"


@pytest.mark.parametrize("T", FIB_LENGTHS)
def test_fibonacci_device_cols_equal_stark_tpu(T):
    from stark_tpu.models.fibonacci import fibonacci_trace_cols_device as j_cols

    got = to_numpy(fibonacci_trace_cols_device(T, device="cpu"))
    assert got.shape == (1, T)
    np.testing.assert_array_equal(got, np.asarray(j_cols(T)))
    np.testing.assert_array_equal(got, fibonacci_trace_mod_p(T).T)


@pytest.mark.parametrize("T", FIB_LENGTHS)
def test_fib_expand_plain_equals_stark_tpu_block_fn(T):
    """Random basis words (not only Fibonacci's) and a random start pair
    through the plain version and stark_tpu's block function on the seeds
    they combine to."""
    from stark_tpu.models.fibonacci import _fib_block_fn

    _, nb = fibonacci_seeds(T)
    b = 1 << max(0, (T.bit_length() - 1) // 2)
    rng = np.random.default_rng(T)
    words = np.concatenate([rand_field(rng, 3 * nb), rand_field(rng, 2 * b)])
    start = tuple(int(v) for v in rng.integers(0, P, 2))
    want = np.asarray(_fib_block_fn(T)(*_seeds_of(words, nb, start)))
    got = W.fib_expand(to_torch(words), nb, T, start)
    np.testing.assert_array_equal(to_numpy(got), want)


def _seeds_of(words: np.ndarray, nb: int, start) -> list[np.ndarray]:
    """s0, s1, u0, u1 of the run from ``start``, combined from basis words
    in Python ints: s0[k] = a F_{kB-2} + b F_{kB-1}, s1[k] = a F_{kB-1} + b
    F_{kB}."""
    a, b = (int(v) % P for v in start)
    fm2, fm1, f0 = ([int(v) for v in words[r * nb : (r + 1) * nb]] for r in range(3))
    s0 = np.array([(a * x + b * y) % P for x, y in zip(fm2, fm1)], dtype=np.uint32)
    s1 = np.array([(a * x + b * y) % P for x, y in zip(fm1, f0)], dtype=np.uint32)
    width = (len(words) - 3 * nb) // 2
    return [s0, s1, words[3 * nb : 3 * nb + width], words[3 * nb + width :]]


@pytest.mark.parametrize("start", FIB_STARTS)
@pytest.mark.parametrize("T", FIB_LENGTHS + [100, 4096])
def test_fib_basis_plain_equals_the_trace_and_stark_tpu_block_fn(T, start):
    """The main path's plain version (the length's basis and a start pair)
    equals the host walk from the start pair and stark_tpu's block function
    on that run's seeds; so do the device witness and its end pair."""
    from stark_tpu.models.fibonacci import _fib_block_fn

    basis, words, nb = FIB._basis(T, torch.device("cpu"))
    got = to_numpy(W.fib_expand_plain(basis, nb, T, start))
    assert got.shape == (1, T)
    np.testing.assert_array_equal(got, fibonacci_trace_mod_p(T, start).T)
    np.testing.assert_array_equal(got, np.asarray(_fib_block_fn(T)(*_seeds_of(words, nb, start))))
    cols, end = fibonacci_segment_cols_device(T, start, device="cpu")
    np.testing.assert_array_equal(to_numpy(cols), got)
    a, b = (int(v) % P for v in start)
    assert end == ((b - a) % P if T == 1 else int(got[0, -2]), int(got[0, -1]))


@pytest.mark.parametrize("block", MDS_BLOCKS)
@pytest.mark.parametrize("T", MDS_LENGTHS)
def test_mds_device_cols_equal_stark_tpu(T, block):
    from stark_tpu.models.examples import mds_square_trace_cols_device as j_cols

    got = to_numpy(ex.mds_square_trace_cols_device(T, block, device="cpu"))
    assert got.shape == (8, T)
    np.testing.assert_array_equal(got, np.asarray(j_cols(T, block)))
    np.testing.assert_array_equal(got, ex.mds_square_trace(T).T)


@pytest.mark.parametrize("block", [1, 5, 64])
def test_mds_expand_plain_equals_stark_tpu_expand_fn(block):
    """Random block-start states through both expansions."""
    from stark_tpu.models.examples import _mds_expand_fn

    seeds = rand_field(np.random.default_rng(block), (9, 8))
    consts = np.concatenate([np.array(ex._MDS).reshape(-1), ex._RC]).astype(np.uint32)
    want = np.asarray(_mds_expand_fn(block)(seeds))
    got = W.mds_expand(to_torch(consts), to_torch(seeds), block, 9 * block)
    np.testing.assert_array_equal(to_numpy(got), want)


@pytest.mark.parametrize("nb,block", [(1, 1), (3, 7), (16, 64)])
def test_mds_seed_walk_equals_stark_tpu(nb, block):
    from stark_tpu import native as j_native

    args = (np.array(ex._MDS), np.array(ex._RC), np.arange(1, 9), nb, block, P)
    got = native.mds_seed_walk(*args)
    assert got.dtype == np.uint32 and got.shape == (nb, 8)
    np.testing.assert_array_equal(got, j_native.mds_seed_walk(*args))


# -- K12 mds_expand's lane arithmetic (csrc/witness.cu) as Python ints -----------

M32 = (1 << 32) - 1
CSRC = os.path.join(os.path.dirname(cuda.__file__), os.pardir, "csrc")
# The constants witness.cu uses: -p^-1 mod 2^32 (field.cuh), 2^64 and 2^80
# mod p (kR2, kR80), computed as it computes them.
K_PINV_NEG = 998244351
K_R2 = ((1 << 32) % P) ** 2 % P
K_R80 = K_R2 * (1 << 16) % P


def _min_wrapped(u: int, minus: int) -> int:
    """__viaddmin_u32(u, -minus, u): min(u - minus mod 2^32, u)."""
    return min((u - minus) & M32, u)


def _mont_mul(a: int, b: int) -> int:
    lo, hi = (a * b) & M32, (a * b) >> 32
    u = hi + (((lo * K_PINV_NEG) & M32) * P >> 32) + (lo != 0)
    assert u < 2 * P
    return _min_wrapped(u, P)


def _lane_step(s: list[int], mh_row: list[int], rc: int) -> int:
    """Row i of one step as a lane computes it: the lazy 64-bit row sum,
    one Montgomery reduction by the constant p (u < 3p, two corrections),
    the Montgomery square, + rc."""
    x = sum(m * v for m, v in zip(mh_row, s))
    assert x < 1 << 63
    lo, hi = x & M32, x >> 32
    u = hi + (((lo * K_PINV_NEG) & M32) * P >> 32) + (lo != 0)
    assert u < 3 * P and u <= M32
    u = _min_wrapped(_min_wrapped(u, 2 * P), P)
    sq = _mont_mul(u, u)
    return _min_wrapped(sq + rc, P)


def _lane_model(consts, seeds, block: int, length: int) -> np.ndarray:
    """mds_expand as the kernel's lanes compute it: (8, length)."""
    m = [int(v) for v in consts[:64]]
    mh = [[_mont_mul(m[8 * i + j], K_R80) for j in range(8)] for i in range(8)]
    rc = [int(v) for v in consts[64:]]
    out = np.zeros((8, length), dtype=np.uint32)
    for b, seed in enumerate(seeds):
        s = [int(v) for v in seed]
        for k in range(block):
            if b * block + k < length:
                out[:, b * block + k] = s
            s = [_lane_step(s, mh[i], rc[i]) for i in range(8)]
    return out


def test_lane_model_constants_are_the_kernels():
    with open(os.path.join(CSRC, "field.cuh")) as f:
        assert re.search(rf"kPinvNeg = {K_PINV_NEG}u;", f.read())
    with open(os.path.join(CSRC, "witness.cu")) as f:
        src = f.read()
    assert "kR2 = static_cast<uint32_t>(kR1 * kR1 % kP)" in src
    assert "kR80 = static_cast<uint32_t>((uint64_t)kR2 * (1u << 16) % kP)" in src
    assert (P * K_PINV_NEG) & M32 == M32
    assert _mont_mul(1, K_R80) == pow(2, 48, P)


def _fib_thread_model(words: np.ndarray, nb: int, length: int, start) -> np.ndarray:
    """fib_expand as the kernel's threads compute it (csrc/witness.cu): a
    thread puts the start pair (a, b) into Montgomery form once (am, bm =
    mont_mul(a, 2^64 mod p), ...), owns 8 columns j of the block (every
    column alone where the block is narrower than 8), puts u0[j], u1[j] into
    Montgomery form once, and for each row k forms the row's seeds from its
    basis words, s0 = mont_mul(am, F_{kB-2}) + mont_mul(bm, F_{kB-1}) and s1
    = mont_mul(am, F_{kB-1}) + mont_mul(bm, F_{kB}) mod p, then writes
    mont_mul(s1, that of u1) + mont_mul(s0, that of u0) mod p, the row's
    elements past ``length`` not written."""
    b = (len(words) - 3 * nb) // 2
    fm2, fm1, f0 = ([int(v) for v in words[r * nb : (r + 1) * nb]] for r in range(3))
    u0 = [int(v) for v in words[3 * nb : 3 * nb + b]]
    u1 = [int(v) for v in words[3 * nb + b :]]
    am, bm = (_mont_mul(int(v) % P, K_R2) for v in start)
    s0 = [_min_wrapped(_mont_mul(am, x) + _mont_mul(bm, y), P) for x, y in zip(fm2, fm1)]
    s1 = [_min_wrapped(_mont_mul(am, x) + _mont_mul(bm, y), P) for x, y in zip(fm1, f0)]
    cols = 8 if b >= 8 else 1
    out = np.zeros(nb * b, dtype=np.uint32)
    for j0 in range(0, b, cols):
        m0 = [_mont_mul(u0[j0 + c], K_R2) for c in range(cols)]
        m1 = [_mont_mul(u1[j0 + c], K_R2) for c in range(cols)]
        for k in range(nb):
            for c in range(cols):
                v = _mont_mul(s1[k], m1[c]) + _mont_mul(s0[k], m0[c])
                out[k * b + j0 + c] = _min_wrapped(v, P)
    return out[:length]


@pytest.mark.parametrize("T", FIB_LENGTHS + [8, 64, 100, 4096])
def test_fib_thread_model_equals_stark_tpu_block_fn(T):
    """Random basis words and a start pair, 0 and p - 1 among them, through
    the kernel's arithmetic (the seeds formed from the start pair in
    Montgomery form, u pre-scaled into it), stark_tpu's block function on
    the seeds they combine to, and the plain version."""
    from stark_tpu.models.fibonacci import _fib_block_fn

    _, nb = fibonacci_seeds(T)
    b = 1 << max(0, (T.bit_length() - 1) // 2)
    rng = np.random.default_rng(T + 1)
    words = np.concatenate([rand_field(rng, 3 * nb), rand_field(rng, 2 * b)])
    start = (0, P - 1) if T % 2 else tuple(int(v) for v in rng.integers(0, P, 2))
    want = np.asarray(_fib_block_fn(T)(*_seeds_of(words, nb, start))).reshape(-1)
    np.testing.assert_array_equal(_fib_thread_model(words, nb, T, start), want)
    np.testing.assert_array_equal(
        to_numpy(W.fib_expand_plain(to_torch(words), nb, T, start)).reshape(-1), want)


_field = st.one_of(st.sampled_from([0, 1, P - 1]), st.integers(0, P - 1))


@pytest.mark.parametrize("block", MDS_BLOCKS)
@settings(max_examples=8, deadline=None)
@given(seeds=st.lists(st.lists(_field, min_size=8, max_size=8), min_size=1, max_size=3))
def test_lane_model_equals_plain_and_stark_tpu(block, seeds):
    from stark_tpu.models.examples import _mds_expand_fn

    seeds = np.array(seeds, dtype=np.uint32)
    consts = np.concatenate([np.array(ex._MDS).reshape(-1), ex._RC]).astype(np.uint32)
    length = len(seeds) * block
    got = _lane_model(consts, seeds, block, length)
    np.testing.assert_array_equal(
        got, to_numpy(W.mds_expand_plain(to_torch(consts), to_torch(seeds), block, length)))
    np.testing.assert_array_equal(got, np.asarray(_mds_expand_fn(block)(seeds)))


@pytest.mark.parametrize("block", MDS_BLOCKS)
@settings(max_examples=8, deadline=None)
@given(consts=st.lists(_field, min_size=72, max_size=72),
       seeds=st.lists(st.lists(_field, min_size=8, max_size=8), min_size=1, max_size=3),
       cut=st.integers(0, 6))
def test_lane_model_equals_plain_any_constants(block, consts, seeds, cut):
    """Any M and rc (the kernel takes them as operands), and a last block
    cut short."""
    consts, seeds = np.array(consts, dtype=np.uint32), np.array(seeds, dtype=np.uint32)
    length = max(len(seeds) * block - min(cut, block - 1), 1)
    np.testing.assert_array_equal(
        _lane_model(consts, seeds, block, length),
        to_numpy(W.mds_expand_plain(to_torch(consts), to_torch(seeds), block, length)))


@pytest.mark.parametrize("mh,s", [(P - 1, P - 1), (P - 1, 0), (0, P - 1), (1, 1)])
def test_lane_step_at_the_largest_lazy_sum(mh, s):
    """x = 8 (p - 1)^2, the largest row sum, still reduces exactly."""
    x = 8 * mh * s
    assert 8 * (P - 1) ** 2 < 1 << 63
    inv = pow(1 << 32, -1, P)
    want = (pow(x * inv % P, 2, P) * inv + 5) % P
    assert _lane_step([s] * 8, [mh] * 8, 5) == want


def test_witness_functions_require_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        fibonacci_trace_cols_device(8)
    with pytest.raises(RuntimeError):
        ex.mds_square_trace_cols_device(8)


def test_expand_rejects_bad_shapes():
    basis = torch.zeros(3 * 3 + 2 * 4, dtype=torch.int32)
    with pytest.raises(ValueError):
        W.fib_expand(basis, 3, 13, (1, 1))         # 3 blocks of 4 hold at most 12
    with pytest.raises(ValueError):
        W.fib_expand(basis[:-2], 3, 8, (1, 1))     # B = 3 is no power of two
    with pytest.raises(ValueError):
        W.fib_expand(basis[3:], 3, 12, (1, 1))     # two words a block: seeds, not a basis
    consts = torch.zeros(72, dtype=torch.int32)
    with pytest.raises(ValueError):
        W.mds_expand(consts, torch.zeros((2, 8), dtype=torch.int32), 4, 4)
    with pytest.raises(ValueError):
        W.mds_expand(consts[:64], torch.zeros((2, 8), dtype=torch.int32), 4, 8)


@pytest.fixture(scope="module")
def mds_proofs():
    cfg = StarkConfig(trace_length=1024, blowup=4, num_colinearity_tests=16)
    prover = StarkProver(ex.MdsSquareAir(), cfg, device="cpu")
    cols = ex.mds_square_trace_cols_device(1024, device="cpu")
    return (cfg, prover.prove(trace_cols=cols),
            prover.prove(ex.mds_square_trace(1024)),
            prover.prove(trace_cols=to_numpy(cols)))


def test_mds_proof_from_device_cols_equals_stark_tpu(mds_proofs):
    cfg, from_cols, from_rows, from_numpy_cols = mds_proofs
    assert from_cols == from_rows == from_numpy_cols
    assert hashlib.sha256(from_cols).hexdigest() == MDS_1024
    assert StarkVerifier(ex.MdsSquareAir(), cfg).verify(from_cols)


def test_mds_changed_device_cols_rejected(mds_proofs):
    cfg = mds_proofs[0]
    cols = ex.mds_square_trace_cols_device(1024, device="cpu").clone()
    cols[3, 500] = (int(cols[3, 500]) + 1) % P
    proof = StarkProver(ex.MdsSquareAir(), cfg, device="cpu").prove(trace_cols=cols)
    assert not StarkVerifier(ex.MdsSquareAir(), cfg).verify(proof)


# -- on the card ---------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("T", FIB_LENGTHS + [1 << 16, 1 << 20, 1 << 21])
def test_card_fib_expand(cuda_device, T):
    """K12 equals its plain version at every start pair; the two witness
    functions, once the length's basis is made, run with the card's sync
    debug mode at "error": no synchronizing call and no pageable copy."""
    device = cuda.device_or_raise(cuda_device, "test_card_fib_expand")
    basis, _, nb = FIB._basis(T, device)
    cpu_basis = FIB._basis(T, torch.device("cpu"))[0]
    cuda.reset_launches()
    for start in FIB_STARTS:
        want = W.fib_expand_plain(cpu_basis, nb, T, start)
        for _ in range(2):
            assert torch.equal(W.fib_expand(basis, nb, T, start).cpu(), want)
    assert cuda.launch_counts()["fib_expand"] == 2 * len(FIB_STARTS)
    assert torch.equal(fibonacci_trace_cols_device(T).cpu(),
                       fibonacci_trace_cols_device(T, device="cpu"))
    builds = FIB.BASIS_BUILDS
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        cols = fibonacci_trace_cols_device(T)
        segments = [fibonacci_segment_cols_device(T, start) for start in FIB_STARTS]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert FIB.BASIS_BUILDS == builds
    assert torch.equal(cols.cpu(), fibonacci_trace_cols_device(T, device="cpu"))
    for start, (got, end) in zip(FIB_STARTS, segments, strict=True):
        want, want_end = fibonacci_segment_cols_device(T, start, device="cpu")
        assert torch.equal(got.cpu(), want) and end == want_end


@pytest.mark.gpu
@pytest.mark.parametrize("T,block", [(1, 64), (5, 1), (1000, 7), (1024, 64),
                                     (4096, 64), (1 << 16, 64), (1 << 16, 1),
                                     (1000, 130), (300, 300), (1000, 1000)])
def test_card_mds_expand(cuda_device, T, block):
    got = ex.mds_square_trace_cols_device(T, block)
    assert got.is_cuda
    assert torch.equal(got.cpu(), ex.mds_square_trace_cols_device(T, block, device="cpu"))
    rng = np.random.default_rng(T + block)
    nb = -(-T // block)
    consts = to_torch(np.concatenate([np.array(ex._MDS).reshape(-1), ex._RC]), cuda_device)
    seeds = to_torch(rand_field(rng, (nb, 8)), cuda_device)
    want = W.mds_expand_plain(consts, seeds, block, T)
    cuda.reset_launches()
    for _ in range(2):
        assert torch.equal(W.mds_expand(consts, seeds, block, T), want)
    assert cuda.launch_counts()["mds_expand"] == 2
