"""The plain reference against the program's CPU path at tiny sizes: the
same proof bytes (this test may import both; the reference imports nothing
of the program)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark.reference import prover as R
from benchmark.reference.airs import fibonacci as RF
from stark_tpu_torch import BatchStarkProver, StarkConfig, StarkProver
from stark_tpu_torch.models import get_model
from stark_tpu_torch.models.fibonacci import fibonacci_trace_mod_p


def reference(mod, T, tests=16):
    return R.prove(R.Statement(mod, T, 4, tests), torch.from_numpy(mod.trace(T).astype(np.int64)))


@pytest.mark.parametrize("T,tests", [(64, 16), (1024, 16), (256, 64), (2048, 64)])
def test_single_prove(T, tests):
    cfg = StarkConfig(trace_length=T, blowup=4, num_colinearity_tests=tests)
    want = StarkProver(get_model("fib")[0], cfg, device="cpu").prove(trace_cols=RF.trace(T))
    assert reference(RF, T, tests) == want


@pytest.mark.parametrize("T,tests", [(64, 16), (256, 64)])
def test_batch_of_two(T, tests):
    cfg = StarkConfig(trace_length=T, blowup=4, num_colinearity_tests=tests)
    cols = torch.from_numpy(RF.trace(T).view(np.int32))
    got = BatchStarkProver(get_model("fib")[0], cfg, 2, device="cpu").prove_batch(
        traces_cols=[cols, cols])
    assert got == [reference(RF, T, tests)] * 2


def test_witness_is_the_programs():
    assert np.array_equal(RF.trace(4096), fibonacci_trace_mod_p(4096).T)


def test_fewer_tests_change_the_bytes():
    assert reference(RF, 256, 63) != reference(RF, 256, 64)


def test_hash_matches_the_rust_reference_vectors():
    """hash.rs's algorithm (tests/ref_oracle's scalar transliteration,
    re-stated here): one-message and many-message forms agree."""
    msgs = [bytes(range(n)) for n in (0, 1, 31, 32, 33, 64)]
    for m in msgs:
        one = R.hash_bytes(m)
        assert len(one) == 32
    many = R.hash_messages(torch.tensor([list(range(64))] * 3, dtype=torch.int32).T)
    assert bytes(many[:, 1].tolist()) == R.hash_bytes(bytes(range(64)))
