"""An AIR of 3,633 constraint terms: 7,266 constraint challenges, two past
the 7,264 that K15 drew on a card when a block kept a whole chain's raw
draws in shared memory (it now keeps a window of them,
ops/hash_batch.CHALLENGE_WINDOW, and the count has no bound).  A
test-local AIR defined once against each package's ``Air``: one register
counting up by one, 3,632 transition constraints (its step times 1, 2,
.., 3,632: a distinct linear form for each) and one boundary constraint,
on one row, so the composition keeps one boundary table.  Its straight-line
K11 source would be 21,795 lines, which nvcc did not finish in 14 minutes:
the generator writes it in the table form (ops/compose.py TABLE_LINES).

On the CPU the port's default prove (the single-fetch path, K15's plain
version) gives the bytes of stark_tpu's proof (its sha256 pinned: stark_tpu
proves this AIR on its host-drawn challenges, the same bytes as its
device chain, whose challenge function unrolls one traced step a
challenge, with its composition run eagerly; CHANGES.md has the
command), and both verifiers accept it; the table form built with the
host C++ compiler equals the eager compose.  On a card (marker ``gpu``):
the same bytes through K15 and K11's table form, one read from the card.
Tolerance zero: bytes."""

import hashlib

import numpy as np
import pytest

from stark_tpu_torch import StarkConfig, StarkProver, StarkVerifier
from stark_tpu_torch.models.air import Air, BoundaryConstraint
from stark_tpu_torch.ops import cuda
from stark_tpu_torch.ops import gather as G
from stark_tpu_torch.ops import hash_batch as HB
from stark_tpu_torch.ops.fieldops import P
from torch_port_support import cuda_device  # noqa: F401

TRANSITIONS = 3632
TERMS = TRANSITIONS + 1  # and the boundary constraint
CFG = dict(trace_length=64, blowup=4, num_colinearity_tests=4)
START = 5
# sha256 of stark_tpu's proof of counter_trace(64) under ManyTermsAir, CFG,
# made with stark_tpu.StarkProver on the CPU with fri.fused_round = False
# (host-drawn constraint challenges) and its composition function run
# without jit (the same integer operations: XLA:CPU was still tracing the
# jitted one after 5 minutes); CHANGES.md has the command.
MANY_TERMS_64 = "2f632b074ddaa6339b87a83fb45ed7e0f9fa501aacedbb1cf1ba551188575e61"


def many_terms_air(base, boundary):
    """x' = x + 1: the step x' - x - 1 times 1, 2, .., TRANSITIONS (a
    distinct linear form for each constraint), and x = START at row 0;
    written once for either package's Air."""

    class ManyTermsAir(base):
        num_registers = 1
        frame_offsets = (0, 1)
        constraint_degree = 1

        def transition_constraints(self, frame, ops):
            x0, x1 = frame[0][0], frame[1][0]
            step = ops.sub(ops.sub(x1, x0), ops.const(1, x0))
            return [ops.mul(ops.const(i + 1, x0), step) for i in range(TRANSITIONS)]

        def boundary_constraints(self, trace_length):
            return [boundary(row=0, register=0, value=START)]

    return ManyTermsAir()


def counter_trace(length: int) -> np.ndarray:
    return ((START + np.arange(length, dtype=np.uint64)) % P)[:, None]


def _sha(proof: bytes) -> str:
    return hashlib.sha256(proof).hexdigest()


@pytest.fixture(scope="module")
def cpu_proof():
    return StarkProver(many_terms_air(Air, BoundaryConstraint), StarkConfig(**CFG),
                       device="cpu").prove(counter_trace(CFG["trace_length"]))


def test_the_air_draws_past_the_old_card_limit():
    air = many_terms_air(Air, BoundaryConstraint)
    terms = air.num_transition_constraints() + len(air.boundary_constraints(64))
    assert terms == TERMS and 2 * terms == 7266 > HB.CHALLENGE_WINDOW
    assert {b.row for b in air.boundary_constraints(64)} == {0}


def test_the_air_takes_the_table_form():
    from stark_tpu_torch.ops import compose as CO

    prog = StarkProver(many_terms_air(Air, BoundaryConstraint), StarkConfig(**CFG),
                       device="cpu").program
    assert prog.table and prog.lines > CO.TABLE_LINES and "kTable = true" in prog.source
    # A step each: the two inputs, the constant 1, the step's two
    # subtractions and one product a constraint (its factor a constant of
    # the step), added as its term at once: two slots a point.
    assert f"kSteps = {5 + TRANSITIONS};" in prog.source and "kSlots = 2;" in prog.source


def test_many_terms_proof_equals_stark_tpu(cpu_proof):
    assert _sha(cpu_proof) == MANY_TERMS_64


def test_many_terms_proof_verifies_in_both_packages(cpu_proof):
    from stark_tpu import StarkConfig as JConfig
    from stark_tpu import StarkVerifier as JVerifier
    from stark_tpu.models.air import Air as JAir
    from stark_tpu.models.air import BoundaryConstraint as JBoundary

    assert StarkVerifier(many_terms_air(Air, BoundaryConstraint), StarkConfig(**CFG)).verify(
        cpu_proof)
    assert JVerifier(many_terms_air(JAir, JBoundary), JConfig(**CFG)).verify(cpu_proof)


def test_host_built_body_with_rolled_sums_matches_eager():
    # The table form (compose.cuh compose_points_table: its step stream in
    # a rolled loop) built with the host C++ compiler: the per-point
    # function equals the eager compose at every point, B = 2.
    import torch
    from test_torch_compose import host_compose

    from torch_port_support import rand_field

    prover = StarkProver(many_terms_air(Air, BoundaryConstraint), StarkConfig(**CFG),
                         device="cpu")
    assert prover.program.terms == TERMS
    rng = np.random.default_rng(TERMS)
    lde = rand_field(rng, (2, 1, prover.dom.N))
    alphas, betas = (rand_field(rng, (2, TERMS)) for _ in range(2))
    want = prover._compose(torch.from_numpy(lde.astype(np.int32)), alphas, betas).numpy()
    got = host_compose(prover.program, prover.tables, lde, alphas, betas, CFG["blowup"])
    np.testing.assert_array_equal(got, want.astype(np.uint32))


@pytest.mark.gpu
def test_card_many_terms_proof(cuda_device, monkeypatch):
    # The single-fetch path through K15 at 7,266 challenges and K11's table
    # form: the pinned bytes, one read from the card, K15 and K11 once.
    reads = []
    to_host = G.to_host
    monkeypatch.setattr(G, "to_host", lambda t, **kw: reads.append(1) or to_host(t, **kw))
    prover = StarkProver(many_terms_air(Air, BoundaryConstraint), StarkConfig(**CFG),
                         cuda_device)
    cuda.reset_launches()
    proof = prover.prove(counter_trace(CFG["trace_length"]))
    counts = cuda.launch_counts()
    assert _sha(proof) == MANY_TERMS_64 and len(reads) == 1
    assert counts["constraint_challenges"] == 1 and counts["compose"] == 1
