"""The port's host control plane and field ops against stark_tpu.

Field arithmetic (ops/fieldops: int64 torch ops), the scalar field, the
transcript and the proof stream must agree with the JAX package bit for
bit on the same numpy inputs (tolerance zero: everything is integer).
Also: importing the port must not import jax.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from stark_tpu_torch import field as tfield
from stark_tpu_torch import stream as tstream
from stark_tpu_torch.ops import fieldops as TF
from stark_tpu_torch.ops.fieldops import P
from stark_tpu_torch.transcript import FiatShamir as TFiatShamir
from torch_port_support import rand_field, to_numpy, to_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jF():
    from stark_tpu.ops import fieldops

    return fieldops


def _pair(seed, n=4096):
    rng = np.random.default_rng(seed)
    return rand_field(rng, n), rand_field(rng, n)


@pytest.mark.parametrize("op", ["addmod", "submod", "mulmod"])
def test_binary_ops_match_stark_tpu(jF, op):
    a, b = _pair(1)
    want = np.asarray(getattr(jF, op)(a, b))
    got = to_numpy(getattr(TF, op)(to_torch(a), to_torch(b)))
    np.testing.assert_array_equal(got, want)


def test_negmod_matches_stark_tpu(jF):
    a, _ = _pair(2)
    np.testing.assert_array_equal(
        to_numpy(TF.negmod(to_torch(a))), np.asarray(jF.negmod(a))
    )


@pytest.mark.parametrize("e", [0, 1, 2, 5, 65537, P - 2, (1 << 40) + 3])
def test_powmod_matches_stark_tpu(jF, e):
    a, _ = _pair(3, 512)
    np.testing.assert_array_equal(
        to_numpy(TF.powmod(to_torch(a), e)), np.asarray(jF.powmod(a, e))
    )


def test_invmod_matches_stark_tpu_including_zero(jF):
    a, _ = _pair(4, 512)
    a[:3] = [0, 1, P - 1]
    got = to_numpy(TF.invmod(to_torch(a)))
    np.testing.assert_array_equal(got, np.asarray(jF.invmod(a)))
    assert got[0] == 0  # inv(0) = 0 (PARITY row 2)
    nz = a != 0
    assert np.all(got[nz].astype(np.uint64) * a[nz] % P == 1)


def test_host_helpers_match_stark_tpu(jF):
    for lg in range(0, 24):
        assert TF.primitive_nth_root(1 << lg) == jF.primitive_nth_root(1 << lg)
    for base, n, scale in [(3, 1, 1), (5, 1000, 7), (P - 1, 4096, 2)]:
        np.testing.assert_array_equal(
            TF.host_powers(base, n, scale), jF.host_powers(base, n, scale)
        )
        np.testing.assert_array_equal(
            to_numpy(TF.powers(base, n, scale)), np.asarray(jF.powers(base, n, scale))
        )
    w = rand_field(np.random.default_rng(5), 1000)
    np.testing.assert_array_equal(TF.shoup_precompute(w), jF.shoup_precompute(w))


def test_u32_to_i32_keeps_the_bits():
    vals = np.array([0, 1, (1 << 31) - 1, 1 << 31, (1 << 32) - 1], dtype=np.uint64)
    got = TF.u32_to_i32(torch.from_numpy(vals.astype(np.int64)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().view(np.uint32), vals.astype(np.uint32))


def test_scalar_field_matches_stark_tpu():
    from stark_tpu import field as jfield

    jf, tf = jfield.FiniteField(), tfield.FiniteField()
    rng = np.random.default_rng(6)
    raw = [0, 1, P - 1, P, P + 5, (1 << 64) - 1] + [
        int(v) for v in rng.integers(0, 1 << 63, size=20, dtype=np.uint64)
    ]
    for x in raw:
        for y in raw[:8]:
            jx, jy = jf.new_element(x), jf.new_element(y)
            tx, ty = tf.new_element(x), tf.new_element(y)
            assert (tx + ty).value == (jx + jy).value
            assert (tx - ty).value == (jx - jy).value
            assert (tx * ty).value == (jx * jy).value
            assert (-tx).value == (-jx).value
            assert (tx ^ y).value == (jx ^ y).value
            if y % P:
                assert (tx / ty).value == (jx / jy).value
    assert tf.sample(b"seed bytes").value == jf.sample(b"seed bytes").value
    assert tf.prim_nth_root(1 << 20).value == jf.prim_nth_root(1 << 20).value


def test_transcript_matches_stark_tpu():
    from stark_tpu.field import FiniteField as JField
    from stark_tpu.transcript import FiatShamir as JFiatShamir

    jfs, tfs = JFiatShamir(), TFiatShamir()
    for chunk in [b"hello world", bytes(range(64)), b"", b"\xff" * 33]:
        jfs.absorb(chunk)
        tfs.absorb(chunk)
        assert tfs.challenge(tfield.FiniteField()).value == jfs.challenge(JField()).value
    fs = TFiatShamir()
    fs.absorb(b"hello world")
    assert fs.challenge(tfield.FiniteField()).value == 5661645321078721431


def test_proof_stream_bytes_match_stark_tpu():
    from stark_tpu import field as jfield
    from stark_tpu import hashfn as jhash
    from stark_tpu import stream as jstream

    def build(S, F, H):
        ps = S.ProofStream()
        f = F.FiniteField()
        ps.push(S.MerkleRoot(H.Hash.from_bytes(b"root")))
        ps.push(S.FieldElementObj(f.new_element((1 << 64) - 1)))
        ps.push(S.FieldElements((f.new_element(3), f.new_element(P + 1))))
        ps.push(S.MerklePath((H.Hash.from_bytes(b"a"), H.Hash.from_bytes(b"b"))))
        return ps.serialize()

    from stark_tpu_torch import hashfn as thash

    want = build(jstream, jfield, jhash)
    got = build(tstream, tfield, thash)
    assert got == want
    # Tolerant parse: truncated and unknown-tag tails, as stream.rs:66-168.
    for data in (want, want[:-5], want + b"\x07junk"):
        jobjs = jstream.ProofStream.deserialize(data, jfield.FiniteField()).objects
        tobjs = tstream.ProofStream.deserialize(data, tfield.FiniteField()).objects
        assert len(tobjs) == len(jobjs)
        assert tstream.ProofStream(tobjs).serialize() == jstream.ProofStream(jobjs).serialize()


def test_import_leaves_jax_out():
    code = (
        "import sys; import stark_tpu_torch; "
        "from stark_tpu_torch import stark, fri, merkle, convert; "
        "from stark_tpu_torch.ops import ntt_fused, fold, cuda; "
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'stark_tpu.'))"
        " or m == 'stark_tpu']; "
        "print(bad); sys.exit(1 if bad else 0)"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
