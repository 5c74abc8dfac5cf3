"""The port's small API surfaces against stark_tpu: the package's exports,
``Hash.ZERO``, ``MerkleTree.leaf``, ``_Domain.znum_at`` / ``excluded_at``
and the parity structs ``FriProof`` / ``QueryData``.  Inputs from a numpy
seed through both packages; tolerance zero."""

import dataclasses

import numpy as np
import pytest

import stark_tpu_torch
from stark_tpu_torch.hashfn import Hash
from stark_tpu_torch.merkle import MerkleTree
from stark_tpu_torch.models import get_model
from stark_tpu_torch.ops.fieldops import P
from stark_tpu_torch.stark import StarkConfig, _Domain
from torch_port_support import rand_field

LEAVES = 64
MODELS = ["fib", "fib2", "square", "cube", "mds"]


def test_exports_match_stark_tpu():
    import stark_tpu

    assert set(stark_tpu_torch.__all__) == set(stark_tpu.__all__)
    for name in stark_tpu_torch.__all__:
        assert getattr(stark_tpu_torch, name) is not None


def test_hash_zero_matches_stark_tpu():
    from stark_tpu.hashfn import Hash as JHash

    assert Hash.ZERO.data == JHash.ZERO.data == b"\x00" * 32


@pytest.fixture(scope="module")
def trees():
    from stark_tpu.merkle import MerkleTree as JTree

    values = rand_field(np.random.default_rng(64), (LEAVES,))
    return MerkleTree.from_leaf_values(values), JTree.from_leaf_values(values)


@pytest.mark.parametrize("index", range(LEAVES))
def test_merkle_leaf_matches_stark_tpu(trees, index):
    ours, theirs = trees
    assert ours.leaf(index).data == theirs.leaf(index).data


def test_merkle_leaf_counts_from_the_end_and_checks_its_range(trees):
    ours, _ = trees
    assert ours.leaf(-1) == ours.leaf(LEAVES - 1)
    for bad in (LEAVES, -LEAVES - 1):
        with pytest.raises(IndexError):
            ours.leaf(bad)


@pytest.mark.parametrize("model", MODELS)
def test_domain_znum_and_excluded_match_stark_tpu(model):
    from stark_tpu.models import get_model as jget_model
    from stark_tpu.stark import StarkConfig as JConfig
    from stark_tpu.stark import _Domain as JDomain

    air, _, blowup = get_model(model)
    cfg = dict(trace_length=64, blowup=blowup, num_colinearity_tests=4)
    ours = _Domain(StarkConfig(**cfg), air)
    theirs = JDomain(JConfig(**cfg), jget_model(model)[0])
    rng = np.random.default_rng(100)
    # 100 points: 0, 1, the trace domain's excluded rows, the rest seeded.
    points = [0, 1, *ours.excluded]
    points += rng.integers(0, P, size=100 - len(points)).tolist()
    assert [ours.znum_at(x) for x in points] == [theirs.znum_at(x) for x in points]
    assert [ours.excluded_at(x) for x in points] == \
        [theirs.excluded_at(x) for x in points]


@pytest.mark.parametrize("name", ["FriProof", "QueryData"])
def test_parity_structs_match_stark_tpu(name):
    import stark_tpu.fri as jfri

    import stark_tpu_torch.fri as tfri

    ours, theirs = getattr(tfri, name), getattr(jfri, name)
    assert [(f.name, f.default) for f in dataclasses.fields(ours)] == \
        [(f.name, f.default) for f in dataclasses.fields(theirs)]
    args = [[1, 2], [3], [4]][: len(dataclasses.fields(ours))]
    assert dataclasses.asdict(ours(*args)) == dataclasses.asdict(theirs(*args))
