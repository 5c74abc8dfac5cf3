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

from stark_tpu_torch.ops.fieldops import P


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
