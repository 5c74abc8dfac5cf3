"""The port's FRI (classic flow, fold on kernel K4's plain version) against
stark_tpu: the golden n=32 proof, byte-equal proofs at n=4096, and the
verifier's accept / reject cases in both directions."""

import hashlib

import numpy as np
import pytest

from stark_tpu_torch.fri import Fri as TFri
from stark_tpu_torch.ops import ntt as TN
from stark_tpu_torch.ops.fieldops import primitive_nth_root
from stark_tpu_torch.stream import ProofStream as TStream
from stark_tpu_torch.transcript import FiatShamir as TFS
from stark_tpu_torch.field import FiniteField as TField
from torch_port_support import rand_field, to_torch


def _tfri(n, tests, expansion=4):
    return TFri(
        omega=primitive_nth_root(n), offset=3, domain_length=n,
        expansion_factor=expansion, num_colinearity_tests=tests,
    )


def _low_degree_codeword(n, degree, seed):
    coeffs = np.zeros(n, dtype=np.uint32)
    coeffs[: degree + 1] = rand_field(np.random.default_rng(seed), degree + 1)
    return coeffs


def _tprove(fri, coeffs):
    codeword = TN.coset_eval(to_torch(coeffs), 3)
    stream = TStream()
    fri.prove(codeword, TFS(), stream)
    return stream.serialize()


def _tverify(fri, proof):
    return fri.verify(TStream.deserialize(proof, TField()), TFS(), [])


def test_fri_proof_bytes_golden():
    coeffs = np.zeros(32, dtype=np.uint32)
    coeffs[0] = 7
    proof = _tprove(_tfri(32, 2), coeffs)
    assert len(proof) == 1219
    assert proof[:64].hex() == (
        "00fb7c5c1cde49c9fbbcb272c3e01985f04799d86118311fbcd2014c1179f6f6"
        "d30068c7106dba00d029d39a1d232b5cea31dda357fc9f74ae7d66e8a5f72515"
    )
    assert (
        hashlib.sha256(proof).hexdigest()
        == "1a3eb1d640cc53b4d8cd764064bd7de5708cc8df4a51e7eb23852989cacc370b"
    )


@pytest.fixture(scope="module")
def proofs_4096():
    """(port proof, stark_tpu proof) of one low-degree codeword, n=4096."""
    from stark_tpu.fri import Fri as JFri
    from stark_tpu.ops import ntt as JN
    from stark_tpu.stream import ProofStream as JStream
    from stark_tpu.transcript import FiatShamir as JFS

    n = 4096
    coeffs = _low_degree_codeword(n, n // 4 - 1, 1)
    jfri = JFri(
        omega=primitive_nth_root(n), offset=3, domain_length=n,
        expansion_factor=4, num_colinearity_tests=8,
    )
    jstream = JStream()
    jfri.prove(JN.coset_eval(coeffs, 3), JFS(), jstream)
    return _tprove(_tfri(n, 8), coeffs), jstream.serialize()


def test_fri_proof_bytes_equal_stark_tpu(proofs_4096):
    port, reference = proofs_4096
    assert port == reference


def test_fri_cross_verification(proofs_4096):
    from stark_tpu.field import FiniteField as JField
    from stark_tpu.fri import Fri as JFri
    from stark_tpu.stream import ProofStream as JStream
    from stark_tpu.transcript import FiatShamir as JFS

    port, reference = proofs_4096
    n = 4096
    jfri = JFri(
        omega=primitive_nth_root(n), offset=3, domain_length=n,
        expansion_factor=4, num_colinearity_tests=8,
    )
    assert _tverify(_tfri(n, 8), reference)
    assert jfri.verify(JStream.deserialize(port, JField()), JFS(), [])


@pytest.mark.parametrize("n,tests,expansion", [(64, 2, 4), (256, 4, 8), (1024, 4, 4)])
def test_fri_accepts_low_degree(n, tests, expansion):
    fri = _tfri(n, tests, expansion)
    values = []
    proof = _tprove(fri, _low_degree_codeword(n, n // expansion - 1, n))
    assert fri.verify(TStream.deserialize(proof, TField()), TFS(), values)
    assert len(values) == 2 * tests


def test_fri_rejects_high_degree():
    n = 256
    fri = _tfri(n, 4)
    proof = _tprove(fri, _low_degree_codeword(n, n // 2, 9))
    assert not _tverify(fri, proof)


@pytest.mark.parametrize("where", [50, 400, -20])
def test_fri_rejects_tampered_bytes(where):
    n = 256
    fri = _tfri(n, 4)
    proof = bytearray(_tprove(fri, _low_degree_codeword(n, n // 4 - 1, 10)))
    proof[where] ^= 1
    assert not _tverify(fri, bytes(proof))


def test_fri_rejects_truncated_proof():
    n = 256
    fri = _tfri(n, 4)
    proof = _tprove(fri, _low_degree_codeword(n, n // 4 - 1, 11))
    assert not _tverify(fri, proof[: len(proof) // 2])
    assert not _tverify(fri, b"")


def test_fri_num_rounds_matches_stark_tpu():
    from stark_tpu.fri import Fri as JFri

    for n in (32, 64, 1 << 10, 1 << 22):
        for tests in (2, 4, 16):
            kw = dict(
                omega=primitive_nth_root(n), offset=3, domain_length=n,
                expansion_factor=4, num_colinearity_tests=tests,
            )
            assert TFri(**kw).num_rounds() == JFri(**kw).num_rounds()


def test_sample_indices_match_stark_tpu():
    from stark_tpu.fri import Fri as JFri

    kw = dict(
        omega=primitive_nth_root(64), offset=3, domain_length=64,
        expansion_factor=4, num_colinearity_tests=4,
    )
    seed = bytes(range(32))
    for size, reduced, number in [(32, 16, 4), (1 << 21, 128, 16), (1000, 50, 50)]:
        assert TFri(**kw).sample_indices(seed, size, reduced, number) == JFri(
            **kw
        ).sample_indices(seed, size, reduced, number)
