"""The port's whole slice, StarkProver.prove -> StarkVerifier.verify for
FibonacciAir, against stark_tpu: the golden T=64 proof, byte-equal proofs
at T=256, each package's verifier accepting the other's proof, and the
tampered-byte and cheating-witness probes rejected.  On a card, the same
proofs through the kernels."""

import hashlib

import numpy as np
import pytest
import torch

from stark_tpu_torch import StarkConfig, StarkProver, StarkVerifier, convert
from stark_tpu_torch.models import FibonacciAir, fibonacci_trace_mod_p
from stark_tpu_torch.ops import cuda
from stark_tpu_torch.ops.fieldops import P
from torch_port_support import cuda_device  # noqa: F401

GOLDEN_T64 = "0fbe172505bfeaaefa39b0fe788e0e84c845958ff92fdc1330338bfc4d31335c"
CFG_256 = dict(trace_length=256, blowup=4, num_colinearity_tests=4)


def _prove(cfg_kw, trace, device="cpu"):
    return StarkProver(FibonacciAir(), StarkConfig(**cfg_kw), device=device).prove(trace)


def _verify(cfg_kw, proof):
    return StarkVerifier(FibonacciAir(), StarkConfig(**cfg_kw)).verify(proof)


def _cheat(trace, row):
    bad = trace.copy()
    bad[row, 0] = (int(bad[row, 0]) + 1) % P
    return bad


def test_stark_proof_bytes_golden():
    proof = _prove(dict(trace_length=64, blowup=4, num_colinearity_tests=4),
                   fibonacci_trace_mod_p(64))
    assert len(proof) == 15598
    assert hashlib.sha256(proof).hexdigest() == GOLDEN_T64


@pytest.fixture(scope="module")
def proofs_256():
    """(port proof, stark_tpu proof) of the honest T=256 witness."""
    from stark_tpu import StarkConfig as JConfig
    from stark_tpu import StarkProver as JProver
    from stark_tpu.models.fibonacci import FibonacciAir as JAir

    trace = fibonacci_trace_mod_p(256)
    reference = JProver(JAir(), JConfig(**CFG_256)).prove(trace)
    return _prove(CFG_256, trace), reference


def test_stark_proof_bytes_equal_stark_tpu(proofs_256):
    port, reference = proofs_256
    assert port == reference


def test_each_verifier_accepts_the_others_proof(proofs_256):
    from stark_tpu import StarkConfig as JConfig
    from stark_tpu import StarkVerifier as JVerifier
    from stark_tpu.models.fibonacci import FibonacciAir as JAir

    port, reference = proofs_256
    assert _verify(CFG_256, reference)
    assert JVerifier(JAir(), JConfig(**CFG_256)).verify(port)


@pytest.mark.parametrize("where", [5, 100, 5000, -3])
def test_tampered_byte_rejected_by_both(proofs_256, where):
    from stark_tpu import StarkConfig as JConfig
    from stark_tpu import StarkVerifier as JVerifier
    from stark_tpu.models.fibonacci import FibonacciAir as JAir

    bad = bytearray(proofs_256[0])
    bad[where] ^= 1
    assert not _verify(CFG_256, bytes(bad))
    assert not JVerifier(JAir(), JConfig(**CFG_256)).verify(bytes(bad))


@pytest.mark.parametrize("row", [0, 1, 100, 255])
def test_cheating_witness_rejected(row):
    trace = _cheat(fibonacci_trace_mod_p(256), row)
    assert not _verify(CFG_256, _prove(CFG_256, trace))


def test_verify_skill_smoke_t1024():
    cfg = dict(trace_length=1024, blowup=4, num_colinearity_tests=16)
    proof = _prove(cfg, fibonacci_trace_mod_p(1024))
    assert _verify(cfg, proof)
    assert hashlib.sha256(proof).hexdigest() == (
        "db5758edd257e895c25f040e3952b6aaebc8e3c5d25ef1408713b3710d2d5559"
    )


def test_witness_conversion_round_trip():
    rows = np.array([[1, 2], [P, P + 3], [5, 0]], dtype=np.uint64)
    cols = convert.witness_to_device(rows, "cpu")
    assert cols.dtype == torch.int32 and tuple(cols.shape) == (2, 3)
    np.testing.assert_array_equal(
        convert.witness_to_numpy(cols), (rows % P).astype(np.uint32)
    )
    ints = [[1 << 40], [7]]  # exact-integer path (trace.rs:29-34 cast)
    np.testing.assert_array_equal(
        convert.witness_to_device(ints, "cpu").numpy(), [[(1 << 40) % P, 7]]
    )
    proof = b"\x00\x01\xff"
    assert convert.proof_from_numpy(convert.proof_to_numpy(proof)) == proof


def test_default_device_requires_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        StarkProver(FibonacciAir(), StarkConfig(**CFG_256))


@pytest.mark.gpu
@pytest.mark.parametrize("T,tests,want", [
    (64, 4, GOLDEN_T64),
    (1024, 16, "db5758edd257e895c25f040e3952b6aaebc8e3c5d25ef1408713b3710d2d5559"),
])
def test_card_proof_bytes(cuda_device, T, tests, want):
    cfg = dict(trace_length=T, blowup=4, num_colinearity_tests=tests)
    cuda.reset_launches()
    proof = _prove(cfg, fibonacci_trace_mod_p(T), cuda_device)
    assert all(c > 0 for c in cuda.launch_counts().values())
    assert hashlib.sha256(proof).hexdigest() == want
    assert _verify(cfg, proof)
    assert not _verify(cfg, _prove(cfg, _cheat(fibonacci_trace_mod_p(T), 3), cuda_device))
