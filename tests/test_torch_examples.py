"""The port's example AIRs (models/examples.py) against stark_tpu: the
two-register Fibonacci, SquareAir (degree 2) and CubeAir (degree 3, which
widens the FRI target and needs blowup 8) prove at T=64 to the same bytes as
stark_tpu, each package's verifier accepts the other's proof, and a
tampered proof and a wrong witness are rejected.  MdsSquareAir has its own
file (test_torch_mds.py).  Tolerance zero: bytes.  On a card, the same
proofs through the kernels."""

import hashlib

import numpy as np
import pytest

from stark_tpu_torch import StarkConfig, StarkProver, StarkVerifier
from stark_tpu_torch.models import MODEL_NAMES, get_model
from stark_tpu_torch.ops import cuda
from stark_tpu_torch.ops.fieldops import P
from torch_port_support import cuda_device  # noqa: F401

MODELS = ["fib2", "square", "cube"]
T = 64
# sha256 of stark_tpu's proofs at T=1024, 16 tests (blowup 8 for cube).
PINNED_1024 = {
    "fib2": "8aa084f58d892fecc475421ff3a70b103680b3ba9d6ac8504c7deaf898367411",
    "square": "f6ba13984ae58983cbdc11555d66a17c20136ea2a746bdd86221b254aca69084",
    "cube": "50c33d4c401ba5bbf71b2139e08aea70001fc0d1254ec111490f150525b7758e",
}


def config(model: str, trace_length: int, tests: int = 4) -> dict:
    return dict(trace_length=trace_length, blowup=get_model(model)[2],
                num_colinearity_tests=tests)


def port_prove(model: str, cfg: dict, trace, device="cpu") -> bytes:
    return StarkProver(get_model(model)[0], StarkConfig(**cfg), device=device).prove(trace)


def port_verify(model: str, cfg: dict, proof: bytes) -> bool:
    return StarkVerifier(get_model(model)[0], StarkConfig(**cfg)).verify(proof)


def reference_prove(model: str, cfg: dict) -> bytes:
    from stark_tpu import StarkConfig as JConfig
    from stark_tpu import StarkProver as JProver
    from stark_tpu.models import get_model as j_get_model

    air, trace_fn, _ = j_get_model(model)
    return JProver(air, JConfig(**cfg)).prove(trace_fn(cfg["trace_length"]))


def reference_verify(model: str, cfg: dict, proof: bytes) -> bool:
    from stark_tpu import StarkConfig as JConfig
    from stark_tpu import StarkVerifier as JVerifier
    from stark_tpu.models import get_model as j_get_model

    return JVerifier(j_get_model(model)[0], JConfig(**cfg)).verify(proof)


def wrong_witness(trace, row: int):
    bad = np.array(trace, dtype=np.uint64)
    bad[row, 0] = (int(bad[row, 0]) + 1) % P
    return bad


@pytest.fixture(scope="module")
def reference_proofs():
    """One stark_tpu proof per AIR, made on first use."""
    made: dict[str, bytes] = {}

    def get(model: str) -> bytes:
        if model not in made:
            made[model] = reference_prove(model, config(model, T))
        return made[model]

    return get


def test_registry_names_every_model():
    assert MODEL_NAMES == ("fib", "fib2", "square", "cube", "mds")
    for name in MODEL_NAMES:
        air, trace_fn, min_blowup = get_model(name)
        rows = np.asarray(trace_fn(8))
        assert rows.shape == (8, air.num_registers)
        assert min_blowup == (8 if name == "cube" else 4)


@pytest.mark.parametrize("model", MODELS)
def test_trace_generators_match_stark_tpu(model):
    from stark_tpu.models import get_model as j_get_model

    want = np.asarray(j_get_model(model)[1](T), dtype=np.uint64)
    np.testing.assert_array_equal(np.asarray(get_model(model)[1](T), dtype=np.uint64), want)


@pytest.mark.parametrize("model", MODELS)
def test_proof_bytes_equal_stark_tpu(reference_proofs, model):
    cfg = config(model, T)
    assert port_prove(model, cfg, get_model(model)[1](T)) == reference_proofs(model)


@pytest.mark.parametrize("model", MODELS)
def test_each_verifier_accepts_the_others_proof(reference_proofs, model):
    cfg = config(model, T)
    assert port_verify(model, cfg, reference_proofs(model))
    assert reference_verify(model, cfg, port_prove(model, cfg, get_model(model)[1](T)))


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("where", [100, -3])
def test_tampered_byte_rejected(model, where):
    cfg = config(model, T)
    bad = bytearray(port_prove(model, cfg, get_model(model)[1](T)))
    bad[where] ^= 1
    assert not port_verify(model, cfg, bytes(bad))


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("row", [1, 40])
def test_wrong_witness_rejected(model, row):
    cfg = config(model, T)
    trace = wrong_witness(get_model(model)[1](T), row)
    assert not port_verify(model, cfg, port_prove(model, cfg, trace))


@pytest.mark.parametrize("model", MODELS)
def test_lazy_ntt_gives_the_same_proof(model):
    cfg = config(model, T)
    air, trace_fn, _ = get_model(model)
    lazy = StarkProver(air, StarkConfig(**cfg), device="cpu", lazy_ntt=True)
    assert lazy.prove(trace_fn(T)) == port_prove(model, cfg, trace_fn(T))


@pytest.mark.parametrize("model", MODELS)
def test_pinned_t1024(model):
    cfg = config(model, 1024, tests=16)
    proof = port_prove(model, cfg, get_model(model)[1](1024))
    assert hashlib.sha256(proof).hexdigest() == PINNED_1024[model]
    assert port_verify(model, cfg, proof)


def test_cube_needs_blowup_8():
    with pytest.raises(ValueError, match="blowup >= 8"):
        StarkProver(get_model("cube")[0],
                    StarkConfig(trace_length=T, blowup=4, num_colinearity_tests=4),
                    device="cpu")


@pytest.mark.gpu
@pytest.mark.parametrize("model", MODELS)
def test_card_proof_bytes(cuda_device, model):
    cfg = config(model, 1024, tests=16)
    trace = get_model(model)[1](1024)
    cuda.reset_launches()
    proof = port_prove(model, cfg, trace, cuda_device)
    counts = cuda.launch_counts()
    assert all(counts[k] > 0 for k in ("hash_rows", "merkle_tail", "fri_fold_dyn",
                                       "sponge_absorb", "ntt_pass1"))
    assert counts["compose"] == 1
    assert hashlib.sha256(proof).hexdigest() == PINNED_1024[model]
    assert port_verify(model, cfg, proof)
    assert not port_verify(
        model, cfg, port_prove(model, cfg, wrong_witness(trace, 3), cuda_device))
