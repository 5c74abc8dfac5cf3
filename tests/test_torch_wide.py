"""AIRs wider than the native path verifier takes (more than 64 registers):
the trace opening's leaves are rows of 65 values, which the C engine's
batched check refuses, so the verifier checks those paths one by one, as
stark_tpu does.  Against stark_tpu on the CPU, with a test-local
65-register AIR of degree 1 defined once against each package's ``Air``:
the proof's sha256 is stark_tpu's (pinned), ``verify`` and
``verify_batch`` give stark_tpu's results on the proof and on tampered
copies, and the path check alone returns stark_tpu's first failing
position.  On a card, the same proof
through the kernels (the row hash at c = 65, the gather's wide value
requests).  Tolerance zero: bytes."""

import hashlib

import numpy as np
import pytest

from stark_tpu_torch import StarkConfig, StarkProver, StarkVerifier
from stark_tpu_torch.fri import _verify_paths_batch
from stark_tpu_torch.hashfn import Hash
from stark_tpu_torch.merkle import MerkleTree
from stark_tpu_torch.models.air import Air, BoundaryConstraint
from stark_tpu_torch.ops import cuda
from stark_tpu_torch.ops.fieldops import P
from stark_tpu_torch.stream import MerklePath
from torch_port_support import cuda_device, rand_field, to_torch  # noqa: F401

WIDTH = 65  # one more register than the native batched path check takes
CFG = dict(trace_length=64, blowup=4, num_colinearity_tests=4)
# sha256 of stark_tpu's proof of wide_trace(64) under WideCounterAir, CFG,
# made with stark_tpu.StarkProver on the CPU, its trace tree's row digests
# taken from stark_tpu's own Hash.from_field_elements (CHANGES.md has the
# command): XLA:CPU did not finish compiling stark_tpu's jitted row hash of
# 65-value rows (520 bytes) in 90 minutes, so neither that nor a test here
# runs it.
WIDE_64 = "df59d3629e2620a1db59dc8373932f7db8de7b39faf9b56ed4d88924e1bdffa8"


def wide_air(base, boundary):
    """Register i counts up by i + 1 a row from i: degree 1, one boundary
    constraint a register, written once for either package's Air."""

    class WideCounterAir(base):
        num_registers = WIDTH
        frame_offsets = (0, 1)
        constraint_degree = 1

        def transition_constraints(self, frame, ops):
            return [ops.sub(ops.sub(frame[1][i], frame[0][i]), ops.const(i + 1, frame[0][i]))
                    for i in range(WIDTH)]

        def boundary_constraints(self, trace_length):
            return [boundary(row=0, register=i, value=i) for i in range(WIDTH)]

    return WideCounterAir()


def wide_trace(length: int) -> np.ndarray:
    t = np.arange(length, dtype=np.int64)[:, None]
    i = np.arange(WIDTH, dtype=np.int64)[None, :]
    return ((i + t * (i + 1)) % P).astype(np.uint64)


@pytest.fixture(scope="module")
def proofs():
    """(the port's proof, stark_tpu's verifier)."""
    from stark_tpu import StarkConfig as JConfig
    from stark_tpu import StarkVerifier as JVerifier
    from stark_tpu.models.air import Air as JAir
    from stark_tpu.models.air import BoundaryConstraint as JBoundary

    proof = StarkProver(wide_air(Air, BoundaryConstraint), StarkConfig(**CFG),
                        device="cpu").prove(wide_trace(CFG["trace_length"]))
    return proof, JVerifier(wide_air(JAir, JBoundary), JConfig(**CFG))


def _verifier():
    return StarkVerifier(wide_air(Air, BoundaryConstraint), StarkConfig(**CFG))


def _tampered(proof: bytes, where: int) -> bytes:
    bad = bytearray(proof)
    bad[where] ^= 1
    return bytes(bad)


def _trace_sibling_byte(proof: bytes) -> int:
    """The position of a sibling byte of a trace opening's path: the last
    path the verifier checks (its leaf is a row of 65 values)."""
    sink: list = []
    assert _verifier().verify(proof, path_sink=sink)
    label, _, row, _, path = sink[-1]
    assert isinstance(row, (list, tuple)) and len(row) == WIDTH, label
    return proof.rindex(path.raw_bytes())


def test_wide_proof_equals_stark_tpu(proofs):
    assert hashlib.sha256(proofs[0]).hexdigest() == WIDE_64


@pytest.mark.parametrize("case", ["good", "trace sibling", "byte 100"])
def test_wide_verify_agrees_with_stark_tpu(proofs, case):
    good, j_verifier = proofs
    proof = {"good": good,
             "trace sibling": _tampered(good, _trace_sibling_byte(good)),
             "byte 100": _tampered(good, 100)}[case]
    got = _verifier().verify(proof)
    assert got == j_verifier.verify(proof)
    assert got == (case == "good")


def test_wide_verify_batch_agrees_with_stark_tpu(proofs):
    good, j_verifier = proofs
    batch = [good, _tampered(good, _trace_sibling_byte(good)), good, _tampered(good, 100)]
    got = _verifier().verify_batch(batch)
    assert got == [True, False, True, False]
    assert got == j_verifier.verify_batch(batch)


def _four_leaf_triples(index_order, bad_sibling=None):
    """Triples over a 4-leaf tree of 65-value rows, one per index in
    ``index_order``; ``bad_sibling``: (triple, level) whose sibling gets
    one byte flipped."""
    rows = rand_field(np.random.default_rng(65), (4, WIDTH))
    tree = MerkleTree.from_rows(to_torch(rows.T.copy()))
    triples = []
    for q, idx in enumerate(index_order):
        path = list(tree.open(idx))
        if bad_sibling is not None and bad_sibling[0] == q:
            level = bad_sibling[1]
            flipped = bytearray(path[level].data)
            flipped[0] ^= 1
            path[level] = Hash(bytes(flipped))
        triples.append((f"q{q}", idx, [int(v) for v in rows[idx]], tree.root, path))
    return triples


def _port_triples(triples):
    return [(lb, i, v, root, MerklePath(path)) for lb, i, v, root, path in triples]


def _reference_triples(triples):
    from stark_tpu.fri import _verify_paths_batch as j_verify
    from stark_tpu.hashfn import Hash as JHash
    from stark_tpu.stream import MerklePath as JPath

    def j(h):
        return JHash(h.data)

    return j_verify, [(lb, i, v, j(root), JPath(tuple(j(h) for h in path)))
                      for lb, i, v, root, path in triples]


def test_wide_paths_at_index_1_verify():
    triples = _four_leaf_triples([1])
    assert _verify_paths_batch(_port_triples(triples)) is None
    j_verify, j_triples = _reference_triples(triples)
    assert j_verify(j_triples) is None


@pytest.mark.parametrize("bad", [(0, 0), (2, 1), (3, 0)])
def test_wide_paths_first_failure_equals_stark_tpu(bad):
    """Among mixed leaf widths: a narrow group (1 value, native) beside the
    wide one, so the first failure is the minimum over both groups."""
    triples = _four_leaf_triples([1, 0, 3, 2], bad_sibling=bad)
    narrow = MerkleTree.from_leaf_values(to_torch(np.arange(4, dtype=np.uint32) + 7))
    triples.insert(1, ("narrow", 2, 9, narrow.root, list(narrow.open(2))))
    want_pos = bad[0] + (1 if bad[0] >= 1 else 0)
    got = _verify_paths_batch(_port_triples(triples))
    j_verify, j_triples = _reference_triples(triples)
    assert got == j_verify(j_triples) == want_pos


# -- on the card -------------------------------------------------------------------


@pytest.mark.gpu
def test_card_wide_proof(cuda_device):
    trace = wide_trace(CFG["trace_length"])
    host = StarkProver(wide_air(Air, BoundaryConstraint), StarkConfig(**CFG),
                       device="cpu").prove(trace)
    cuda.reset_launches()
    proof = StarkProver(wide_air(Air, BoundaryConstraint), StarkConfig(**CFG),
                        device=cuda_device).prove(trace)
    counts = cuda.launch_counts()
    assert proof == host
    assert hashlib.sha256(proof).hexdigest() == WIDE_64
    assert counts["hash_rows"] > 0 and counts["query_gather"] == 1
    assert counts["compose"] == 1
    assert _verifier().verify(proof)
