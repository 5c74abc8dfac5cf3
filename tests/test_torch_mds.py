"""The port's wide AIR, MdsSquareAir (8 registers, 8 degree-2 constraints),
against stark_tpu: the row hash absorbs two 32-byte chunks per leaf and the
composer sees degree-2 constraints.  Proof bytes at T=64 and T=256 equal
stark_tpu's, each package's verifier accepts the other's proof, a tampered
proof and a wrong witness are rejected, and T=1024 and T=4096 match sha256
pinned from stark_tpu.  Tolerance zero: bytes.  On a card, the same proofs
through the kernels."""

import hashlib

import numpy as np
import pytest

from stark_tpu_torch.models import get_model
from stark_tpu_torch.models.examples import _MDS, _RC
from stark_tpu_torch.ops import cuda
from stark_tpu_torch.ops.fieldops import P
from test_torch_examples import (
    config,
    port_prove,
    port_verify,
    reference_prove,
    reference_verify,
    wrong_witness,
)
from torch_port_support import cuda_device  # noqa: F401

SIZES = [64, 256]
# sha256 of stark_tpu's proofs, blowup 4, 16 tests.
PINNED = {
    1024: "97cf6cf94a41c0df3c285c34e497c315a14e4083e3897632b1d76e39109f61a6",
    4096: "fa5fdeb1274b56feea0a8ddd897be2d02ec6db51eea9b9b692a2e3c445fb6c9a",
}


def trace(T: int) -> np.ndarray:
    return get_model("mds")[1](T)


@pytest.fixture(scope="module")
def reference_proofs():
    """One stark_tpu proof per size, made on first use."""
    made: dict[int, bytes] = {}

    def get(T: int) -> bytes:
        if T not in made:
            made[T] = reference_prove("mds", config("mds", T))
        return made[T]

    return get


def test_constants_and_trace_match_stark_tpu():
    from stark_tpu.models import examples as jex

    assert _MDS == jex._MDS and _RC == jex._RC
    assert all(isinstance(v, int) for row in _MDS for v in row)
    np.testing.assert_array_equal(trace(300), jex.mds_square_trace(300))
    rows = trace(3).astype(object)
    mixed = [sum(_MDS[i][j] * rows[0][j] for j in range(8)) % P for i in range(8)]
    assert [int(v) for v in rows[1]] == [(m * m + _RC[i]) % P for i, m in enumerate(mixed)]


@pytest.mark.parametrize("T", SIZES)
def test_proof_bytes_equal_stark_tpu(reference_proofs, T):
    assert port_prove("mds", config("mds", T), trace(T)) == reference_proofs(T)


@pytest.mark.parametrize("T", SIZES)
def test_each_verifier_accepts_the_others_proof(reference_proofs, T):
    cfg = config("mds", T)
    assert port_verify("mds", cfg, reference_proofs(T))
    assert reference_verify("mds", cfg, port_prove("mds", cfg, trace(T)))


@pytest.mark.parametrize("T", SIZES)
@pytest.mark.parametrize("where", [100, 9000, -3])
def test_tampered_byte_rejected(T, where):
    cfg = config("mds", T)
    bad = bytearray(port_prove("mds", cfg, trace(T)))
    bad[where] ^= 1
    assert not port_verify("mds", cfg, bytes(bad))


@pytest.mark.parametrize("T", SIZES)
@pytest.mark.parametrize("row", [0, 33])
def test_wrong_witness_rejected(T, row):
    cfg = config("mds", T)
    assert not port_verify("mds", cfg, port_prove("mds", cfg, wrong_witness(trace(T), row)))


@pytest.mark.parametrize("T", sorted(PINNED))
def test_pinned_sha256(T):
    cfg = config("mds", T, tests=16)
    proof = port_prove("mds", cfg, trace(T))
    assert hashlib.sha256(proof).hexdigest() == PINNED[T]
    assert port_verify("mds", cfg, proof)


@pytest.mark.gpu
@pytest.mark.parametrize("T", sorted(PINNED))
def test_card_proof_bytes(cuda_device, T):
    cfg = config("mds", T, tests=16)
    cuda.reset_launches()
    proof = port_prove("mds", cfg, trace(T), cuda_device)
    counts = cuda.launch_counts()
    assert all(counts[k] > 0 for k in ("hash_rows", "merkle_tail", "fri_fold_dyn",
                                       "sponge_absorb", "ntt_pass1"))
    assert counts["compose"] == 1
    assert hashlib.sha256(proof).hexdigest() == PINNED[T]
    assert port_verify("mds", cfg, proof)
    assert not port_verify(
        "mds", cfg, port_prove("mds", cfg, wrong_witness(trace(T), 3), cuda_device))
