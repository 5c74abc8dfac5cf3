"""The port's verifier is a total function of the proof bytes, as stark_tpu's
is (tests/test_verifier_totality.py holds stark_tpu alone): seeded
mutations of valid proofs of the five example models at T=64 (bit flips,
truncations, appended bytes, overwritten spans; 640 in all) go through
both packages' ``verify`` and ``verify_batch``, which must give the same
verdict on every one and never raise.  The proofs are the port's, which
equal stark_tpu's byte for byte (tests/test_torch_cli.py)."""

import numpy as np
import pytest

from stark_tpu_torch import StarkConfig, StarkProver, StarkVerifier
from stark_tpu_torch.models import get_model

MODELS = ["fib", "fib2", "square", "cube", "mds"]
KINDS = ["flip", "truncate", "append", "overwrite"]
PER_KIND = 16


def _cfg(model):
    return dict(trace_length=64, blowup=get_model(model)[2], num_colinearity_tests=4)


@pytest.fixture(scope="module")
def proofs():
    out = {}
    for model in MODELS:
        air, trace_fn, _ = get_model(model)
        out[model] = StarkProver(air, StarkConfig(**_cfg(model)), device="cpu") \
            .prove(trace_fn(64))
    return out


def _mutations(proof: bytes, kind: str, seed: int) -> list:
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(PER_KIND):
        data = bytearray(proof)
        if kind == "flip":
            pos = int(rng.integers(0, len(data)))
            data[pos] ^= 1 << int(rng.integers(0, 8))
        elif kind == "truncate":
            data = data[: int(rng.integers(0, len(data)))]
        elif kind == "append":
            data += rng.integers(0, 256, size=int(rng.integers(1, 65)), dtype=np.uint8).tobytes()
        else:
            size = int(rng.integers(1, 41))
            pos = int(rng.integers(0, len(data) - size))
            data[pos : pos + size] = rng.integers(0, 256, size=size, dtype=np.uint8).tobytes()
        out.append(bytes(data))
    return out


def _verifiers(model):
    from stark_tpu import StarkConfig as JConfig
    from stark_tpu import StarkVerifier as JVerifier
    from stark_tpu.models import get_model as jget_model

    cfg = _cfg(model)
    return (StarkVerifier(get_model(model)[0], StarkConfig(**cfg)),
            JVerifier(jget_model(model)[0], JConfig(**cfg)))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("model", MODELS)
def test_verify_matches_stark_tpu_on_mutations(proofs, model, kind):
    ours, theirs = _verifiers(model)
    mutated = _mutations(proofs[model], kind, MODELS.index(model) * 10 + KINDS.index(kind))
    got = [ours.verify(p) for p in mutated]  # raising fails the test
    assert all(isinstance(v, bool) for v in got)
    assert got == [theirs.verify(p) for p in mutated]
    if kind in ("flip", "truncate"):
        assert not any(got)


@pytest.mark.parametrize("model", MODELS)
def test_verify_batch_matches_stark_tpu_on_mutations(proofs, model):
    ours, theirs = _verifiers(model)
    batch = [proofs[model]] + [p for kind in KINDS for p in _mutations(
        proofs[model], kind, 100 + MODELS.index(model) * 10 + KINDS.index(kind))]
    got = ours.verify_batch(batch)
    assert got == theirs.verify_batch(batch)
    assert got == [ours.verify(p) for p in batch]
    assert got[0] is True
