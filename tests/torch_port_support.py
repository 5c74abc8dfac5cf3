"""Shared pieces of the port's tests (tests/test_torch_*.py).

The port's test files import torch and stark_tpu_torch at the top and the
JAX package only inside fixtures, so the kernel-on-card tests (marker
``gpu``) can be collected on a machine that has a CUDA card but no jax:

    python -m pytest --noconftest -o addopts="" -m gpu tests/test_torch_*.py
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from stark_tpu_torch.models import get_model
from stark_tpu_torch.ops.fieldops import P

# sha256 of stark_tpu's proofs of witnesses(model, T, 2, seed=T): the
# model's trace, then random rows (StarkProver.prove, blowup as get_model
# gives it, 4 tests).
PINNED_PAIRS = {
    ("fib", 64): ("0fbe172505bfeaaefa39b0fe788e0e84c845958ff92fdc1330338bfc4d31335c",
                  "280fa344049d69a312c830563bb4feba9fafe239160c742ca01173b6aa2697d4"),
    ("mds", 32): ("96923f8de37f8dbf40eeff4f4976402c2df0d0a22aec37d483ef279fe18c605c",
                  "22c05026389f6ae089efe75274f815f8e176a7092105e41f245f20582961b55d"),
    ("fib2", 128): ("afbb76e8614e5cf6e0017c4d29cd9d63a094e1cd148685ba26e524de502da28c",
                    "f22235ad9b0f3f226fd063d7528a63e797bd52bda4fb179db7c862c1ed150461"),
}


@pytest.fixture
def cuda_device() -> torch.device:
    """The card, or a skip: decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("kernel-on-card test: needs a CUDA device")
    return torch.device("cuda")


def rand_field(rng: np.random.Generator, shape) -> np.ndarray:
    """uint32 values in [0, p), with 0 and p-1 planted at the front."""
    vals = rng.integers(0, P, size=shape, dtype=np.uint64).astype(np.uint32)
    flat = vals.reshape(-1)
    flat[: min(2, flat.size)] = [0, P - 1][: min(2, flat.size)]
    return vals


def to_torch(values: np.ndarray, device="cpu") -> torch.Tensor:
    """uint32 numpy values in [0, p) -> int32 tensor (the port's storage)."""
    return torch.from_numpy(np.asarray(values, dtype=np.int64)).to(torch.int32).to(device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().astype(np.uint32)


def witnesses(model: str, trace_length: int, count: int, seed: int) -> list:
    """The model's own trace rows, then ``count - 1`` rows of random field
    values (a prove needs no valid witness to be held byte for byte)."""
    air, trace_fn, _ = get_model(model)
    rng = np.random.default_rng(seed)
    rows = [np.asarray(trace_fn(trace_length), dtype=np.int64) % P]
    rows += [rng.integers(0, P, size=(trace_length, air.num_registers), dtype=np.int64)
             for _ in range(count - 1)]
    return rows
