"""The port's commitment hash and Merkle trees against stark_tpu.

Golden digests; the native C engine against the numpy engine; the stacked
uint8 torch hash (ops/hash_batch) against stark_tpu's numpy leaf / row /
combine cores; tree levels, roots and authentication paths against
stark_tpu.merkle.MerkleTree at widths 2^4..2^12 (both sides of the 1024-wide
device/host cutover).  Tolerance zero: bytes must match.
"""

import numpy as np
import pytest
import torch

from stark_tpu_torch import native
from stark_tpu_torch.hashfn import Hash as THash
from stark_tpu_torch.hashfn import hash_bytes, hash_bytes_np
from stark_tpu_torch.merkle import MerkleTree as TTree
from stark_tpu_torch.ops import hash_batch as THB
from torch_port_support import rand_field, to_torch

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
    want = jHB.leaf_hash_core(np, v)
    got = THB.leaf_hash(to_torch(v)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(THB.digests_to_bytes(THB.leaf_hash(to_torch(v))),
                                  native.hash_u64s(v.astype(np.uint64)))


@pytest.mark.parametrize("c", [1, 2, 3, 4, 5, 8])
def test_row_hash_matches_stark_tpu(jHB, c):
    v = rand_field(np.random.default_rng(c), (c, 300))
    np.testing.assert_array_equal(
        THB.row_hash(to_torch(v)).numpy(), jHB.row_hash_core(np, v)
    )


def test_combine_matches_stark_tpu(jHB):
    rng = np.random.default_rng(3)
    left = rng.integers(0, 256, size=(32, 500), dtype=np.uint8)
    right = rng.integers(0, 256, size=(32, 500), dtype=np.uint8)
    got = THB.combine(torch.from_numpy(left), torch.from_numpy(right)).numpy()
    np.testing.assert_array_equal(got, jHB.combine_core(np, left, right))
    np.testing.assert_array_equal(
        THB.merkle_level(torch.from_numpy(left)).numpy(),
        jHB.merkle_level_np(left),
    )
    np.testing.assert_array_equal(
        THB.digests_to_bytes(torch.from_numpy(left)), jHB.digests_to_bytes(left)
    )
    np.testing.assert_array_equal(THB.bytes_to_digests(left.T).numpy(), left)


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
    tt = TTree.from_leaf_digests(THB.row_hash(to_torch(v)))
    assert tt.root.data == jt.root.data
    host_bytes = THB.digests_to_bytes(THB.row_hash(to_torch(v)))
    assert TTree.from_leaf_digests(host_bytes, device="cpu").root == tt.root
    idx = [1, n - 2, 77]
    for got, want in zip(tt.open_batch(idx), jt.open_batch(idx)):
        assert [h.data for h in got] == [h.data for h in want]


def test_scalar_tree_constructor():
    leaves = [THash.from_u64(i) for i in range(8)]
    tree = TTree(leaves)
    assert TTree.commit(leaves) == tree.root
    for i in range(8):
        assert TTree.verify(leaves[i], i, tree.open(i), tree.root)
