"""The port's commitment hash and Merkle trees against stark_tpu.

Golden digests; the native C engine against the numpy engine; the plain
versions of kernels K5-K8 (ops/hash_batch: row hash, level, subtree level
stack; K8's decomposition into subtrees and a top, and its chained
diffusion sum) against stark_tpu's numpy leaf / row / combine cores, the numpy
scalar hash and the C engine; tree levels, roots and authentication paths
against stark_tpu.merkle.MerkleTree at widths 2^4..2^12; forests (B trees
side by side: K8-forest's plain version and the paths K13 reads from a
forest's stack) against stark_tpu.batch.BatchedTrees; the sponge of the
device commit chain (K9's plain version) against stark_tpu's sponge_*
functions and transcript_state_core.  The port keeps digests node-major (N, 32)
and stark_tpu byte-major (32, N), so stark_tpu's side is transposed.
Tolerance zero: bytes must match.  On a card only (marker ``gpu``): each
kernel against its plain version.
"""

import numpy as np
import pytest
import torch

from stark_tpu_torch import hashfn, native
from stark_tpu_torch.hashfn import Hash as THash
from stark_tpu_torch.hashfn import ROUND_CONSTANTS, hash_bytes, hash_bytes_np
from stark_tpu_torch.merkle import Forest as TForest
from stark_tpu_torch.merkle import MerkleTree as TTree
from stark_tpu_torch.ops import hash_batch as THB
from stark_tpu_torch.ops import cuda
from torch_port_support import cuda_device, rand_field, to_torch  # noqa: F401

GOLDEN_HASHES = {
    b"": "f2de8d1dbca64572c0310f32459054b28a30a5aa56ade96fa7d71fe77b536a66",
    b"abc": "6cf51dd336d3d989e7e7740318f9da802ae41cbea872add5a76c118cad12fd0a",
    bytes(range(64)): (
        "f2cef41febd30b54b1ae12377d0f36a8be0e37d2a9e2484bdc9479f33bfa5dc8"
    ),
}


@pytest.fixture(scope="module")
def jHB():
    from stark_tpu.ops import hash_batch

    return hash_batch


@pytest.mark.parametrize("engine", [hash_bytes, hash_bytes_np])
def test_hash_golden_vectors(engine):
    for data, want in GOLDEN_HASHES.items():
        assert engine(data).hex() == want


def test_hash_golden_field_elements_and_u64():
    assert (
        THash.from_field_elements([1, 2, 3]).to_hex()
        == "e360f49d2238e7c03427dba04af3a01629ba41ef4c1dfbc5af21a446ab09c6c5"
    )
    assert (
        THash.from_u64((1 << 64) - 1).to_hex()
        == "365c81e3862e0214ddf0ca36108bcecedc3c10ce03e93121005db5bcdd958a17"
    )


def test_native_matches_numpy_engine():
    rng = np.random.default_rng(0)
    for length in [0, 1, 7, 8, 31, 32, 33, 36, 64, 100, 257]:
        data = rng.integers(0, 256, size=length, dtype=np.uint8).tobytes()
        assert hash_bytes(data) == hash_bytes_np(data), length


@pytest.mark.parametrize("n", [1, 5, 1000])
def test_leaf_hash_matches_stark_tpu(jHB, n):
    v = rand_field(np.random.default_rng(n), n)
    want = jHB.leaf_hash_core(np, v).T
    got = THB.leaf_hash(to_torch(v)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(THB.digests_to_bytes(THB.leaf_hash(to_torch(v))),
                                  native.hash_u64s(v.astype(np.uint64)))


@pytest.mark.parametrize("c", [1, 2, 3, 4, 5, 8])
def test_row_hash_matches_stark_tpu(jHB, c):
    # Partial chunks (c = 1, 2, 3, 5) and multi-chunk absorbs (c = 5, 8).
    v = rand_field(np.random.default_rng(c), (c, 300))
    got = THB.hash_rows_plain(to_torch(v)).numpy()
    np.testing.assert_array_equal(got, jHB.row_hash_core(np, v).T)
    np.testing.assert_array_equal(THB.hash_rows(to_torch(v)).numpy(), got)
    for lane in (0, 1, 299):
        message = b"".join(int(x).to_bytes(8, "little") for x in v[:, lane])
        assert got[lane].tobytes() == hash_bytes_np(message)


def test_combine_matches_stark_tpu(jHB):
    rng = np.random.default_rng(3)
    left = rng.integers(0, 256, size=(500, 32), dtype=np.uint8)
    right = rng.integers(0, 256, size=(500, 32), dtype=np.uint8)
    got = THB.combine_plain(torch.from_numpy(left), torch.from_numpy(right)).numpy()
    np.testing.assert_array_equal(got, jHB.combine_core(np, left.T, right.T).T)
    np.testing.assert_array_equal(
        THB.merkle_level(torch.from_numpy(left)).numpy(),
        jHB.merkle_level_np(np.ascontiguousarray(left.T)).T,
    )
    np.testing.assert_array_equal(
        THB.digests_to_bytes(torch.from_numpy(left)),
        jHB.digests_to_bytes(np.ascontiguousarray(left.T)),
    )
    np.testing.assert_array_equal(THB.bytes_to_digests(left, "cpu").numpy(), left)


@pytest.mark.parametrize("lg", range(4, 13))
def test_tree_matches_stark_tpu(lg):
    from stark_tpu.hashfn import Hash as JHash
    from stark_tpu.merkle import MerkleTree as JTree

    n = 1 << lg
    v = rand_field(np.random.default_rng(lg), n)
    jt = JTree([JHash.from_field_elements([int(x)]) for x in v])
    for tt in (
        TTree.from_leaf_values(to_torch(v)),
        TTree.from_leaf_values(v),
        TTree.from_leaf_values(v, device="cpu"),
    ):
        assert tt.root.data == jt.root.data
        assert len(tt.levels) == len(jt.levels)
        for a, b in zip(tt.levels, jt.levels):
            np.testing.assert_array_equal(a, b)
        idx = [0, n - 1, n // 2, 5 % n, 3 * n // 7]
        paths = tt.open_batch(idx)
        for i, path in zip(idx, paths):
            want = jt.open(i)
            assert [h.data for h in path] == [h.data for h in want]
            assert [h.data for h in tt.open(i)] == [h.data for h in want]
            leaf = THash.from_field_elements([int(v[i])])
            assert TTree.verify(leaf, i, path, tt.root)
            assert not TTree.verify(leaf, i ^ 1, path, tt.root)


@pytest.mark.parametrize("n", [256, 2048])
def test_tree_from_row_digests_matches_stark_tpu(jHB, n):
    from stark_tpu.merkle import MerkleTree as JTree

    v = rand_field(np.random.default_rng(n), (2, n))
    jt = JTree.from_leaf_digests(jHB.digests_to_bytes(jHB.row_hash_core(np, v)))
    tt = TTree.from_leaf_digests(THB.hash_rows(to_torch(v)))
    assert tt.root.data == jt.root.data
    host_bytes = THB.digests_to_bytes(THB.hash_rows(to_torch(v)))
    assert TTree.from_leaf_digests(host_bytes, device="cpu").root == tt.root
    assert TTree.from_rows(to_torch(v)).root == tt.root
    assert TTree.from_rows(v).root == tt.root
    idx = [1, n - 2, 77]
    for got, want in zip(tt.open_batch(idx), jt.open_batch(idx)):
        assert [h.data for h in got] == [h.data for h in want]


def test_scalar_tree_constructor():
    leaves = [THash.from_u64(i) for i in range(8)]
    tree = TTree(leaves)
    assert TTree.commit(leaves) == tree.root
    for i in range(8):
        assert TTree.verify(leaves[i], i, tree.open(i), tree.root)


@pytest.mark.parametrize("w", [2, 64, 1024, 4096])
def test_tail_level_stack_matches_stark_tpu_and_native(w, monkeypatch):
    from stark_tpu.merkle import MerkleTree as JTree

    leaves = np.random.default_rng(w).integers(0, 256, size=(w, 32), dtype=np.uint8)
    got = THB.merkle_tail_plain(torch.from_numpy(leaves)).numpy()
    assert got.shape == (w - 1, 32)
    want = native.merkle_levels(leaves)[1:]
    np.testing.assert_array_equal(got, np.concatenate(want))
    for a, b in zip(want, JTree.from_leaf_digests(leaves).levels[1:]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(THB.merkle_tail(torch.from_numpy(leaves)).numpy(), got)
    # A whole stack, K7's and K8's plain versions on either side of the
    # cutover between them.
    for cutover in (1, 16, THB.TAIL_CUTOVER):
        monkeypatch.setattr(THB, "TAIL_CUTOVER", cutover)
        stack = torch.zeros((2 * w - 1, 32), dtype=torch.uint8)
        stack[:w] = torch.from_numpy(leaves)
        np.testing.assert_array_equal(THB.merkle_build(stack)[w:].numpy(), got)
    assert [THB.level_offset(w, l) for l in (0, 1)] == [0, w]
    assert THB.level_offset(w, w.bit_length() - 1) == 2 * w - 2


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mix_matches_the_sequential_diffusion(seed):
    # The plain mix takes the neighbour diffusion as a prefix sum (and the
    # kernels as a chain of multiply-adds); hash.rs:77-81 writes it as a
    # loop that updates the state in place.  Both must agree on any state.
    rng = np.random.default_rng(seed)
    states = rng.integers(0, 256, size=(32, 4000), dtype=np.uint8)
    states[:, 0], states[:, 1], states[:, 2] = 0, 255, 128
    x = states.astype(np.int64) * 251 & 0xFF
    x = ((x << 1) | (x >> 7)) & 0xFF ^ 0x63
    t = x.reshape(8, 4, -1)
    g = np.stack([t[:, 0] ^ t[:, 1] ^ t[:, 3], t[:, 0] ^ t[:, 2] ^ t[:, 3],
                  t[:, 0] ^ t[:, 1] ^ t[:, 2], t[:, 1] ^ t[:, 2] ^ t[:, 3]],
                 axis=1).reshape(32, -1)
    for i in range(32):
        g[i] = (g[i] + g[(i + 1) % 32] + g[(i + 31) % 32]) & 0xFF
    want = (g + ROUND_CONSTANTS[:, None]) & 0xFF
    got = THB._mix(torch.from_numpy(states))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.uint8))
    np.testing.assert_array_equal(
        got[:, :8].numpy(),
        np.stack([hashfn._mix_state(states[:, j]) for j in range(8)], axis=1))


# A model of the hash spread over L lanes (csrc/hash.cuh split_*), in
# uint32 arithmetic as a lane computes it (the bits above a state byte's
# low 8 left as they fall): (N, L, m) states, lane r holding the m = 32 / L
# bytes at positions m r .. m r + m - 1, each cross-lane read the shuffle
# the kernel makes.
_PRIMES = np.array([2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43, 47, 53], np.uint32)
_SBOX_MUL = np.uint32(0x9E3779B1)
_CHAIN_MUL = np.uint32((502 * pow(0x9E3779B1, -1, 1 << 32)) % (1 << 32))


def _select(mask, a, b):
    return (a & np.uint32(mask)) | (b & np.uint32(~mask & 0xFFFFFFFF))


def _positions(lanes: int) -> np.ndarray:
    m = 32 // lanes
    return np.arange(lanes)[:, None] * m + np.arange(m)[None, :]


def _fetch7(v: np.ndarray, lanes: int) -> np.ndarray:
    """x[.., r, j] = v at position (m r + j - 7) mod 32: split_fetch7, a
    shuffle from lane r - back (mod L) for j < 7."""
    m = 32 // lanes
    x = np.empty_like(v)
    for j in range(m):
        byte, back = (j + 32 - 7) % m, (7 - j + m - 1) // m
        x[..., j] = v[..., byte] if j >= 7 else np.roll(v[..., byte], back, axis=-1)
    return x


def _split_absorb(s, d, lanes):
    low = _positions(lanes) < 7
    x = np.zeros_like(s)
    for wave in range(5):
        t = (s ^ x) + d
        v = _select(0xF8, t << np.uint32(3), t >> np.uint32(5))
        x = _fetch7(v, lanes)
        if wave < 4:
            x = np.where(low, np.uint32(0), x)
    return np.where(low, v ^ x, v)


def _split_mix(s, lanes, form_in, form_out):
    m = 32 // lanes
    rc = ROUND_CONSTANTS.astype(np.uint32)[_positions(lanes)]
    mul = _SBOX_MUL if form_in == "scaled" else np.uint32(502)
    z = s * mul + (np.uint32(0) if form_in == "bytes" else np.uint32(502) * rc)
    x = _select(0xFE, z, z >> np.uint32(8)).reshape(s.shape[:-1] + (m // 4, 4))
    a = x[..., 0] ^ np.uint32(0x63)
    g = np.stack([a ^ x[..., 1] ^ x[..., 3], a ^ x[..., 2] ^ x[..., 3], a ^ x[..., 1] ^ x[..., 2],
                  (x[..., 1] ^ np.uint32(0x63)) ^ x[..., 2] ^ x[..., 3]], axis=-1)
    g = g.reshape(s.shape)
    k = _CHAIN_MUL if form_out == "scaled" else np.uint32(1)
    g_next = np.concatenate([g[..., 1:, 0], g[..., -1:, 0]], axis=-1)  # shfl_down 1
    g31 = g[..., -1, -1]                                                 # shfl from L - 1
    loc = g * np.uint32(2 * int(k) % (1 << 32))
    loc[..., 0, 0] = (g[..., 0, 0] + g31) * k
    loc = np.cumsum(loc, axis=-1, dtype=np.uint32)                       # the lane's own prefix
    inc = loc[..., -1].copy()
    d = 1
    while d < lanes:                                                     # shfl_up scan
        up = np.zeros_like(inc)
        up[..., d:] = inc[..., :-d]
        inc = inc + up
        d *= 2
    before = (inc - loc[..., -1])[..., None]
    nxt = np.concatenate([g[..., 1:], g_next[..., None]], axis=-1)
    n = nxt * k + (before + loc)
    n[..., -1, -1] = g31 * k + (n[..., 0, 0] + n[..., -1, -2])           # new[31]
    return n + (rc if form_out == "bytes" else np.uint32(0))


def split_combine_model(left: np.ndarray, right: np.ndarray, lanes: int,
                        between: str = "owed") -> np.ndarray:
    """(N, 32) x (N, 32) u8 digests -> (N, 32): Hash::combine as L lanes
    compute it (split_combine)."""
    shape = (left.shape[0], lanes, 32 // lanes)
    s = np.broadcast_to(_PRIMES[_positions(lanes) & 15], shape).astype(np.uint32)
    s = _split_absorb(s, left.reshape(shape).astype(np.uint32), lanes)
    s = _split_mix(s, lanes, "bytes", "bytes")
    s = _split_absorb(s, right.reshape(shape).astype(np.uint32), lanes)
    s = _split_mix(s, lanes, "bytes", "bytes")
    s = _split_mix(s, lanes, "bytes", between)
    for _ in range(6):
        s = _split_mix(s, lanes, between, between)
    s = _split_mix(s, lanes, between, "bytes")
    return (s & np.uint32(0xFF)).astype(np.uint8).reshape(-1, 32)


@pytest.mark.parametrize("between", ["owed", "scaled"])
@pytest.mark.parametrize("lanes", [1, 2, 4, 8])
def test_split_hash_model_matches_combine(jHB, lanes, between):
    import jax.numpy as jnp

    rng = np.random.default_rng(lanes)
    left = rng.integers(0, 256, size=(300, 32), dtype=np.uint8)
    right = rng.integers(0, 256, size=(300, 32), dtype=np.uint8)
    left[0], right[1] = 0, 255
    got = split_combine_model(left, right, lanes, between)
    for i in range(8):
        want = THash.combine(THash(left[i].tobytes()), THash(right[i].tobytes()))
        assert got[i].tobytes() == want.data
    rows = jHB.combine_rows_core(tuple(jnp.asarray(left.T)), tuple(jnp.asarray(right.T)))
    np.testing.assert_array_equal(got, np.stack([np.asarray(r) for r in rows], axis=1))


@pytest.mark.parametrize("lg_w", range(1, 25))
def test_tail_lanes_per_level(lg_w):
    # Each level of each launch: one lane a hash unless the block's threads
    # give each of its hashes four or more, then as many as they give,
    # never more than lanes_max, whole groups within the block; the levels
    # are tail_launches'.
    for lg_sub in (None,) + tuple(range(1, THB.TAIL_MAX_LG + 1)):
        for lanes_max in THB.LANE_CHOICES:
            launches = list(THB.tail_launches(lg_w, lg_sub))
            plan = list(THB.tail_plan(lg_w, lg_sub, lanes_max=lanes_max))
            assert len(plan) == len(launches)
            for (sub, top), (threads, sub_l, top_l) in zip(launches, plan):
                assert threads == THB.tail_threads(sub, top) and 32 <= threads <= 256
                assert (len(sub_l), len(top_l)) == (sub, top)
                for levels, lanes in ((sub, sub_l), (top, top_l)):
                    for k, ell in enumerate(lanes, 1):
                        count = 1 << (levels - k)
                        assert ell in THB.LANE_CHOICES and ell <= lanes_max
                        if 4 * count > threads:
                            assert ell == 1
                        else:
                            assert count * ell <= threads
                            assert ell == lanes_max or count * ell == threads
                    assert lanes == sorted(lanes)  # narrower levels, more lanes
    assert list(THB.tail_plan(lg_w)) == list(THB.tail_plan(lg_w, lanes_max=THB.TAIL_LANES))


@pytest.mark.parametrize("lg_sub", [1, 4, 8, 10])
@pytest.mark.parametrize("lg_w", [1, 3, 8, 9, 12])
def test_tail_decomposition_matches_level_by_level(lg_w, lg_sub):
    # merkle_tail_plain follows K8: a block per subtree of 2^lg_sub nodes,
    # each block's share of a level at the block's offset, then the top.
    w = 1 << lg_w
    leaves = np.random.default_rng(w + lg_sub).integers(
        0, 256, size=(w, 32), dtype=np.uint8)
    levels, nodes = [], torch.from_numpy(leaves)
    while nodes.shape[0] > 1:
        nodes = THB.merkle_level_plain(nodes)
        levels.append(nodes)
    want = torch.cat(levels)
    assert torch.equal(THB.merkle_tail_plain(torch.from_numpy(leaves), lg_sub), want)
    assert torch.equal(THB.merkle_tail(torch.from_numpy(leaves), lg_sub=lg_sub), want)
    np.testing.assert_array_equal(
        want.numpy(), np.concatenate(native.merkle_levels(leaves)[1:]))


@pytest.mark.parametrize("lg_w,lg_sub,want", [
    (16, 8, [(8, 8)]),            # one launch from the cutover width
    (8, 8, [(8, 0)]),             # one block: nothing left for a top
    (9, 8, [(8, 1)]),
    (18, 8, [(8, 10)]),           # the widest top a block takes
    (19, 8, [(8, 0), (8, 3)]),    # a top of 2^11 would not fit: two launches
    (22, 8, [(8, 0), (8, 6)]),
    (5, 8, [(5, 0)]),
    (12, 1, [(1, 0), (1, 10)]),
])
def test_tail_launches(lg_w, lg_sub, want):
    got = list(THB.tail_launches(lg_w, lg_sub))
    assert got == want
    assert sum(sub + top for sub, top in got) == lg_w


@pytest.mark.parametrize("lg_w", range(1, 25))
def test_tail_default_subtrees_reach_the_root(lg_w):
    # The wrapper's own choice of subtree: one launch up to 2^20 nodes,
    # every launch within what a block can hold.
    got = list(THB.tail_launches(lg_w))
    assert sum(sub + top for sub, top in got) == lg_w
    assert all(1 <= sub <= THB.TAIL_MAX_LG and 0 <= top <= THB.TAIL_MAX_LG
               for sub, top in got)
    assert len(got) == 1 or lg_w > 2 * THB.TAIL_MAX_LG
    assert THB.tail_sub_lg(16) == 9 and THB.tail_sub_lg(3) == 3


def test_wrappers_reject_bad_operands():
    good = torch.zeros((4, 32), dtype=torch.uint8)
    for lg_sub in (0, THB.TAIL_MAX_LG + 1):
        with pytest.raises(ValueError):
            THB.merkle_tail(good, lg_sub=lg_sub)
    with pytest.raises(ValueError):
        THB.merkle_level(torch.zeros((32, 4), dtype=torch.uint8))  # byte-major
    with pytest.raises(ValueError):
        THB.merkle_level(torch.zeros((3, 32), dtype=torch.uint8))
    with pytest.raises(ValueError):
        THB.merkle_tail(torch.zeros((6, 32), dtype=torch.uint8))
    with pytest.raises(ValueError):
        THB.merkle_level(good, out=torch.zeros((3, 32), dtype=torch.uint8))
    with pytest.raises(ValueError):
        THB.hash_rows(torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError):
        THB.merkle_build(torch.zeros((6, 32), dtype=torch.uint8))


def test_cpu_tensors_take_the_plain_versions():
    cuda.reset_launches()
    v = to_torch(rand_field(np.random.default_rng(5), (2, 2048)))
    TTree.from_rows(v).open_batch([0, 7])
    assert all(c == 0 for c in cuda.launch_counts().values())


@pytest.mark.parametrize("op", ["hash_rows", "merkle_level", "merkle_tail", "ntt"])
def test_non_cpu_tensor_never_takes_the_plain_version(op):
    # A tensor that is not on the CPU must reach the kernel's operand check
    # (which refuses anything but a CUDA tensor), never the plain version:
    # a meta tensor stands in for a card that is not there.
    from stark_tpu_torch.ops import ntt_fused as NTF

    digests = torch.zeros((4, 32), dtype=torch.uint8, device="meta")
    values = torch.zeros((1, 4), dtype=torch.int32, device="meta")
    call = {
        "hash_rows": lambda: THB.hash_rows(values),
        "merkle_level": lambda: THB.merkle_level(digests),
        "merkle_tail": lambda: THB.merkle_tail(digests),
        "ntt": lambda: NTF.fused_ntt(values, lazy=True),
    }[op]
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        call()


def test_launch_without_a_compiler_raises():
    import shutil

    if shutil.which("nvcc") or torch.cuda.is_available():
        pytest.skip("a CUDA toolchain is present")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        THB.HASH_ROWS.launch(torch.device("cuda"), 0, 0, 1, 0)


@pytest.mark.gpu
@pytest.mark.parametrize("c", [1, 2, 3, 5, 8])
@pytest.mark.parametrize("n", [2, 1024, 1 << 20])
def test_hash_rows_kernel_matches_plain_on_card(cuda_device, c, n):
    v = to_torch(rand_field(np.random.default_rng(c * n), (c, n)), cuda_device)
    before = cuda.launch_counts()["hash_rows"]
    got = THB.hash_rows(v)
    assert cuda.launch_counts()["hash_rows"] == before + 1
    assert torch.equal(got, THB.hash_rows_plain(v))


@pytest.mark.gpu
@pytest.mark.parametrize("w", [2, 2048, 1 << 22])
def test_level_kernel_matches_plain_on_card(cuda_device, w):
    nodes = torch.from_numpy(
        np.random.default_rng(w).integers(0, 256, size=(w, 32), dtype=np.uint8)
    ).to(cuda_device)
    before = cuda.launch_counts()["merkle_level"]
    got = THB.merkle_level(nodes)
    assert cuda.launch_counts()["merkle_level"] == before + 1
    assert torch.equal(got, THB.merkle_level_plain(nodes))


@pytest.mark.gpu
@pytest.mark.parametrize("w", [2, 64, 1024, 1 << 14, 1 << 16])
def test_tail_kernel_matches_plain_and_native_on_card(cuda_device, w):
    leaves = np.random.default_rng(w).integers(0, 256, size=(w, 32), dtype=np.uint8)
    nodes = torch.from_numpy(leaves).to(cuda_device)
    before = cuda.launch_counts()["merkle_tail"]
    got = THB.merkle_tail(nodes)
    assert cuda.launch_counts()["merkle_tail"] == before + 1  # to the root
    assert torch.equal(got, THB.merkle_tail_plain(nodes))
    np.testing.assert_array_equal(
        got.cpu().numpy(), np.concatenate(native.merkle_levels(leaves)[1:])
    )


@pytest.mark.gpu
@pytest.mark.parametrize("lg_sub", [1, 4, 6, 8, 9, 10])
@pytest.mark.parametrize("lg_w", [1, 5, 7, 8, 9, 10, 11, 16, 17, 18, 19, 20])
def test_tail_kernel_at_every_subtree_size_on_card(cuda_device, lg_w, lg_sub):
    # Widths just below, at and above the two boundaries of a launch: one
    # block (W = 2^lg_sub) and the widest top (W = 2^(lg_sub + 10)).
    w = 1 << lg_w
    nodes = torch.from_numpy(np.random.default_rng(w + lg_sub).integers(
        0, 256, size=(w, 32), dtype=np.uint8)).to(cuda_device)
    want = THB.merkle_tail_plain(nodes, lg_sub)
    for _ in range(2):  # the ticket must come back to zero
        before = cuda.launch_counts()["merkle_tail"]
        got = THB.merkle_tail(nodes, lg_sub=lg_sub)
        launches = len(list(THB.tail_launches(lg_w, lg_sub)))
        assert cuda.launch_counts()["merkle_tail"] == before + launches
        assert torch.equal(got, want)
        stream = torch.cuda.current_stream(nodes.device).cuda_stream
        assert int(THB._ticket(nodes.device, stream)) == 0


@pytest.mark.gpu
@pytest.mark.parametrize("lg_w", [10, 16])
def test_tail_kernel_on_two_streams_on_card(cuda_device, lg_w):
    # Launches on different streams may overlap: each stream has a ticket
    # word of its own, so neither tree's top starts on the other's count.
    w = 1 << lg_w
    rng = np.random.default_rng(lg_w)
    nodes = [torch.from_numpy(rng.integers(0, 256, size=(w, 32), dtype=np.uint8)
                              ).to(cuda_device) for _ in range(2)]
    want = [THB.merkle_tail_plain(n) for n in nodes]
    streams = [torch.cuda.Stream(cuda_device) for _ in range(2)]
    torch.cuda.synchronize()
    got = [[], []]
    for _ in range(20):
        for k, stream in enumerate(streams):
            with torch.cuda.stream(stream):
                got[k].append(THB.merkle_tail(nodes[k]))
    torch.cuda.synchronize()
    for k, stream in enumerate(streams):
        assert all(torch.equal(g, want[k]) for g in got[k])
        assert int(THB._ticket(nodes[k].device, stream.cuda_stream)) == 0
    assert (THB._ticket(nodes[0].device, streams[0].cuda_stream).data_ptr()
            != THB._ticket(nodes[0].device, streams[1].cuda_stream).data_ptr())


@pytest.mark.gpu
def test_tree_on_card_matches_host_engine(cuda_device):
    n = 1 << 18
    v = rand_field(np.random.default_rng(18), (3, n))
    card, host = TTree.from_rows(to_torch(v, cuda_device)), TTree.from_rows(v)
    assert card.root == host.root
    idx = [0, n - 1, 12345, n // 2]
    assert card.open_batch(idx) == host.open_batch(idx)


# -- K9: the sponge of the device commit chain --------------------------------


@pytest.mark.parametrize("q", range(32))
def test_sponge_plain_matches_stark_tpu(jHB, q):
    # A q-byte pending tail after a prefix of 0, 1 or 2 full chunks: every
    # regime for B = 3 lanes, one a case for B = 1 (each regime in turn);
    # then a 32-byte root absorbed and the challenge drawn (the per-round
    # step), against stark_tpu's sponge_from_bytes, sponge_absorb,
    # sponge_state and state_alpha.  The digest of the whole bytes equals
    # the host hash's, and transcript_state_core's in one regime a case.
    import jax.numpy as jnp

    rng = np.random.default_rng(100 + q)
    for b, full in [(3, 0), (3, 1), (3, 2), (1, q % 3)]:
        prefix = rng.integers(0, 256, size=(b, 32 * full + q), dtype=np.uint8)
        root = rng.integers(0, 256, size=(b, 32), dtype=np.uint8)
        sp = THB.Sponge(b, "cpu")
        sp.absorb(torch.from_numpy(prefix))
        j_state, j_pending = jHB.sponge_from_bytes(jnp.asarray(prefix.T))
        assert sp.q == q == j_pending.shape[0]
        np.testing.assert_array_equal(sp.state.numpy(), np.asarray(j_state).T)
        np.testing.assert_array_equal(sp.pending[:, :q].numpy(), np.asarray(j_pending).T)

        alpha, copy = torch.empty(b, dtype=torch.int32), torch.empty((b, 32), dtype=torch.uint8)
        sp.absorb(torch.from_numpy(root), copy, alpha)
        j_state, j_pending = jHB.sponge_absorb(j_state, j_pending, jnp.asarray(root.T))
        j_final = jHB.sponge_state(j_state, j_pending)
        digest = THB.sponge_state_plain(sp.state, sp.pending, sp.q).numpy()
        np.testing.assert_array_equal(sp.state.numpy(), np.asarray(j_state).T)
        np.testing.assert_array_equal(digest, np.asarray(j_final).T)
        np.testing.assert_array_equal(alpha.numpy(), np.asarray(jHB.state_alpha(j_final)))
        np.testing.assert_array_equal(copy.numpy(), root)
        whole = np.concatenate([prefix, root], axis=1)
        for lane in range(b):
            assert digest[lane].tobytes() == hash_bytes(whole[lane].tobytes())
        if b == 3 and full == q % 3:
            core = jHB.transcript_state_core(jnp.asarray(whole), rolled=True)
            np.testing.assert_array_equal(
                digest, np.stack([np.asarray(r) for r in core], axis=1))


def _funnel_rc(lo: int, hi: int, shift: int) -> int:
    """CUDA's __funnelshift_rc: (hi:lo) >> min(shift, 32), the low word."""
    return ((hi << 32 | lo) >> min(shift, 32)) & 0xFFFFFFFF


def _funnel_lc(lo: int, hi: int, shift: int) -> int:
    """CUDA's __funnelshift_lc: (hi:lo) << min(shift, 32), the high word."""
    return ((hi << 32 | lo) << min(shift, 32)) >> 32 & 0xFFFFFFFF


def _sponge_chunk_model(pend: np.ndarray, q: int, data: np.ndarray, t: int) -> bytes:
    """What a K9 thread computes for chunk t of its stream pending (q
    bytes) || data (csrc/hash.cu sponge_chunk): 8 words, each a pending
    word or one funnel shift of two data words, as 32 bytes."""
    words = pend.view("<u4")
    m, a, shift = data.size, q >> 2, 32 - 8 * (q & 3)

    def d(j: int) -> int:
        if j < 0 or 4 * j >= m:
            return 0
        return int.from_bytes(data[4 * j : min(4 * j + 4, m)].tobytes(), "little")

    out = []
    for k in range(8):
        u = 8 * t + k
        lo = _funnel_lc(0, int(words[k]), shift) if u == a else d(8 * t + k - a - 1)
        word = _funnel_rc(lo, d(8 * t + k - a), shift)
        out.append(int(words[k]) if u < a else word)
    return b"".join(w.to_bytes(4, "little") for w in out)


@pytest.mark.parametrize("q", range(32))
def test_sponge_chunk_words_model(q):
    # Every chunk of pending || data, and the zero-padded tail, from words:
    # for m the prefixes of the example AIRs' proves (32 + 16 terms: 64,
    # 80, 96, 288), a root (32), chip_smoke.py's 64 + q, short and odd m.
    rng = np.random.default_rng(q)
    pend = rng.integers(0, 256, size=32, dtype=np.uint8)  # bytes past q: not read
    for m in sorted({0, 1, 5, 31, 32, 33, 64, 80, 96, 288, 64 + q}):
        data = rng.integers(0, 256, size=m, dtype=np.uint8)
        stream = pend[:q].tobytes() + data.tobytes()
        for t in range((q + m) // 32 + 1):
            want = stream[32 * t : 32 * t + 32].ljust(32, b"\0")
            assert _sponge_chunk_model(pend, q, data, t) == want, (q, m, t)


def test_sponge_challenge_is_the_transcripts():
    # The challenge the sponge draws is the host transcript's, reduced.
    from stark_tpu_torch.field import FiniteField
    from stark_tpu_torch.transcript import FiatShamir

    rng = np.random.default_rng(7)
    fs, sp = FiatShamir(), THB.Sponge(1, "cpu")
    prefix = rng.integers(0, 256, size=(1, 80), dtype=np.uint8)
    fs.absorb(prefix.tobytes())
    sp.absorb(torch.from_numpy(prefix))
    for _ in range(5):
        root = rng.integers(0, 256, size=(1, 32), dtype=np.uint8)
        alpha = torch.empty(1, dtype=torch.int32)
        sp.absorb(torch.from_numpy(root), alpha=alpha)
        fs.absorb(root.tobytes())
        assert int(alpha) == fs.challenge(FiniteField()).value % 998244353


def test_sponge_rejects_bad_operands():
    sp = THB.Sponge(2, "cpu")
    with pytest.raises(ValueError):
        sp.absorb(torch.zeros((3, 32), dtype=torch.uint8))
    with pytest.raises(ValueError):
        sp.absorb(torch.zeros((2, 32), dtype=torch.int32))
    with pytest.raises(ValueError):
        sp.absorb(torch.zeros((2, 32), dtype=torch.uint8),
                  alpha=torch.zeros(2, dtype=torch.int64))


# -- K8 for forests -----------------------------------------------------------


def _j_level_digests(rows) -> np.ndarray:
    """A stark_tpu forest level (32 arrays, proof-major lanes) -> (B w, 32)."""
    return np.stack([np.asarray(r).reshape(-1) for r in rows], axis=1)


@pytest.mark.parametrize("b", [1, 2, 4])
@pytest.mark.parametrize("n", [2, 16, 256])
@pytest.mark.parametrize("kind", ["values", "rows"])
def test_forest_matches_stark_tpu_batched_trees(kind, n, b):
    # Every level of the forest's stack and the paths K13 reads from it
    # (gather_plain over GatherPlan.paths with the forest's depth) against
    # stark_tpu's BatchedTrees levels and open_batch_dev.
    import jax.numpy as jnp

    from stark_tpu.batch import BatchedTrees
    from stark_tpu_torch.ops import gather as G

    rng = np.random.default_rng(n * 10 + b)
    if kind == "values":
        vals = rand_field(rng, (b, n))
        ours = TForest.from_values(to_torch(vals))
        ref = BatchedTrees.from_values(vals, b, n)
    else:
        vals = rand_field(rng, (b, 3, n))
        ours = TForest.from_rows(to_torch(vals))
        ref = BatchedTrees.from_rows(vals, b, 3, n)
    assert (ours.B, ours.n, ours.depth) == (b, n, n.bit_length() - 1)
    want = np.concatenate([_j_level_digests(rows) for rows, _ in ref.levels])
    np.testing.assert_array_equal(ours.stack.numpy(), want)
    np.testing.assert_array_equal(ours.roots_dev().numpy(),
                                  np.asarray(ref.root_bytes_dev()))

    idx = rng.integers(0, n, size=(b, 5)).astype(np.int32)
    plan = G.GatherPlan()
    slot = plan.paths(ours.stack, ours.global_index(idx).reshape(-1), ours.depth)
    got = slot.take(G.gather_plain(plan).numpy().view(np.uint32))
    ref_paths = np.asarray(ref.open_batch_dev(jnp.asarray(idx)))  # (depth, B, k, 32)
    np.testing.assert_array_equal(got.reshape(b, 5, ours.depth, 32),
                                  ref_paths.transpose(1, 2, 0, 3))


@pytest.mark.parametrize("b,lg_n", [(2, 1), (3, 4), (4, 10), (2, 11), (8, 12)])
def test_forest_tail_is_each_trees_tail(b, lg_n):
    # forest_tail_plain against the trees one at a time, and each tree of
    # the forest against its own MerkleTree; its launch decomposition.
    n = 1 << lg_n
    leaves = torch.from_numpy(np.random.default_rng(lg_n).integers(
        0, 256, size=(b * n, 32), dtype=np.uint8))
    forest = TForest(torch.cat([leaves, THB.merkle_forest(leaves, b)]), b)
    for t in range(b):
        tree = TTree.from_leaf_digests(leaves[t * n : (t + 1) * n])
        assert torch.equal(forest.tree(t)._stack, tree._stack)
    launches = list(THB.tail_launches((b * n).bit_length() - 1, None, lg_n))
    assert sum(sub + top for sub, top in launches) == lg_n
    assert all(1 <= sub <= THB.TAIL_MAX_LG and top <= THB.TAIL_MAX_LG
               for sub, top in launches)


def test_forest_build_uses_the_level_kernel_above_the_cutover(monkeypatch):
    # Wide levels go to K7 (pairs never cross a tree's edge), the rest to
    # K8-forest: the stack equals the trees built one by one.
    monkeypatch.setattr(THB, "TAIL_CUTOVER", 8)
    b, n = 4, 64
    vals = to_torch(rand_field(np.random.default_rng(3), (b, n)))
    forest = TForest.from_values(vals)
    for t in range(b):
        assert torch.equal(forest.tree(t)._stack,
                           TTree.from_leaf_values(vals[t])._stack)


def test_forest_wrappers_reject_bad_operands():
    good = torch.zeros((8, 32), dtype=torch.uint8)
    with pytest.raises(ValueError):
        THB.merkle_forest(good, 3)          # 8 leaves are not 3 trees
    with pytest.raises(ValueError):
        THB.merkle_forest(torch.zeros((12, 32), dtype=torch.uint8), 2)  # width 6
    with pytest.raises(ValueError):
        THB.forest_build(torch.zeros((15, 32), dtype=torch.uint8), 2)   # 2W - B rows
    with pytest.raises(ValueError):
        THB.merkle_forest(torch.zeros((8, 32), dtype=torch.uint8, device="meta"), 2)


@pytest.mark.gpu
@pytest.mark.parametrize("b", [8, 32])
@pytest.mark.parametrize("lg_n", [1, 4, 9, 10, 11, 14, 16])
def test_forest_kernel_matches_plain_on_card(cuda_device, b, lg_n):
    n = 1 << lg_n
    leaves = torch.from_numpy(np.random.default_rng(lg_n).integers(
        0, 256, size=(b * n, 32), dtype=np.uint8)).to(cuda_device)
    want = THB.forest_tail_plain(leaves.cpu(), b)
    before = cuda.launch_counts()["merkle_forest"]
    for _ in range(2):  # the tickets are left at zero
        assert torch.equal(THB.merkle_forest(leaves, b).cpu(), want)
    assert cuda.launch_counts()["merkle_forest"] > before


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 8, 32])
@pytest.mark.parametrize("length", [0, 1, 31, 32, 80, 95])
def test_sponge_kernel_matches_plain_on_card(cuda_device, b, length):
    rng = np.random.default_rng(b * 100 + length)
    prefix = torch.from_numpy(rng.integers(0, 256, size=(b, length), dtype=np.uint8))
    card, plain = THB.Sponge(b, cuda_device), THB.Sponge(b, "cpu")
    card.absorb(prefix.to(cuda_device))
    plain.absorb(prefix)
    for _ in range(3):
        root = torch.from_numpy(rng.integers(0, 256, size=(b, 32), dtype=np.uint8))
        a = torch.empty(b, dtype=torch.int32, device=cuda_device)
        c = torch.empty((b, 32), dtype=torch.uint8, device=cuda_device)
        want = torch.empty(b, dtype=torch.int32)
        card.absorb(root.to(cuda_device), c, a)
        plain.absorb(root, alpha=want)
        assert torch.equal(a.cpu(), want) and torch.equal(c.cpu(), root)
        assert torch.equal(card.state.cpu(), plain.state)


@pytest.mark.gpu
@pytest.mark.parametrize("lanes", [1, 4, 8])
@pytest.mark.parametrize("lg_sub", [None, 1, 6])
@pytest.mark.parametrize("lg_w", [1, 2, 5, 6, 9, 10, 11, 16, 17, 20])
def test_tail_kernel_at_every_lane_count_on_card(cuda_device, lg_w, lg_sub, lanes):
    w = 1 << lg_w
    nodes = torch.from_numpy(np.random.default_rng(w + lanes).integers(
        0, 256, size=(w, 32), dtype=np.uint8)).to(cuda_device)
    want = THB.merkle_tail_plain(nodes, lg_sub)
    for _ in range(2):
        assert torch.equal(THB.merkle_tail(nodes, lg_sub=lg_sub, lanes=lanes), want)


@pytest.mark.gpu
@pytest.mark.parametrize("lanes", [1, 4, 8])
@pytest.mark.parametrize("b, lg_n", [(8, 1), (8, 5), (8, 13), (32, 4), (32, 11), (3, 9)])
def test_forest_kernel_at_every_lane_count_on_card(cuda_device, b, lg_n, lanes):
    leaves = torch.from_numpy(np.random.default_rng(b * lg_n + lanes).integers(
        0, 256, size=(b << lg_n, 32), dtype=np.uint8)).to(cuda_device)
    want = THB.forest_tail_plain(leaves.cpu(), b)
    for _ in range(2):  # the tickets are left at zero
        assert torch.equal(THB.merkle_forest(leaves, b, lanes=lanes).cpu(), want)


@pytest.mark.gpu
@pytest.mark.parametrize("lanes", [4, 8])
def test_split_levels_on_two_streams_on_card(cuda_device, lanes):
    # Trees and forests on two streams at once, the narrow levels split.
    rng = np.random.default_rng(lanes)
    nodes = [torch.from_numpy(rng.integers(0, 256, size=(1 << 12, 32), dtype=np.uint8)
                              ).to(cuda_device) for _ in range(2)]
    want = [THB.merkle_tail_plain(nodes[0]), THB.forest_tail_plain(nodes[1].cpu(), 8)]
    streams = [torch.cuda.Stream(cuda_device) for _ in range(2)]
    torch.cuda.synchronize()
    got = [[], []]
    for _ in range(20):
        with torch.cuda.stream(streams[0]):
            got[0].append(THB.merkle_tail(nodes[0], lanes=lanes))
        with torch.cuda.stream(streams[1]):
            got[1].append(THB.merkle_forest(nodes[1], 8, lanes=lanes))
    torch.cuda.synchronize()
    assert all(torch.equal(g, want[0]) for g in got[0])
    assert all(torch.equal(g.cpu(), want[1]) for g in got[1])
