"""Each served proof has a statement of its own: the plain reference with
public inputs against the program, and the comparison of proofs whose
statements differ.

On the CPU: the reference with start pairs other than (1, 1) against the
program's CPU ``StarkProver`` over a FibonacciAir whose boundary is that
pair (a subclass made here), at T=64 with 16 tests and T=256 with 64; the
default statement's bytes pinned to what the reference gave before it took
public inputs.  Through a copy of the benchmark (``tiny``, T=256): a
stand-in driver served by the reference, each proof's start pair drawn
from the seed.  Sound, it reads ``correct``; handing out its first proof
for every statement, or with two statements' proofs swapped, it reads as
mismatched on exactly the proofs it got wrong.

Marked ``gpu``: the stand-in at T=2^20 on a card, sound and handing out its
first proof, with the reference's seconds a statement printed (``python3 -m
pytest -o addopts= -p no:cacheprovider -m gpu -s benchmark`` on a card); it
skips where no card is visible.
"""

from __future__ import annotations

import hashlib
import json
import random
import time

import numpy as np
import pytest
import torch

from benchmark import harness as H
from benchmark import run as RUN
from benchmark.conftest import TINY_T, make_tiny
from benchmark.reference import prover as R
from benchmark.reference.airs import fibonacci as RF
from stark_tpu_torch import StarkConfig, StarkProver
from stark_tpu_torch.models.air import BoundaryConstraint
from stark_tpu_torch.models.fibonacci import FibonacciAir

P = RF.P
PAIRS = [(2, 3), (0, 1), (P - 1, 5), (123456789, 987654321)]
#: sha256 of the reference's proof of the default statement, (T, tests),
#: as the reference gave it before it took public inputs
PINNED = {(64, 16): "e4cd3d35ad86a7a15402e653f5e6823e2fe52f009f29a18734682d78d7ee6e7b",
          (256, 64): "2b16f61ac593c835fa7a110bbff2a23cc005b274c100048e98525a349fe3f423"}
SEED = 2**31 + 101
#: what the stand-in served in its last run: the record, its first
#: statement, the two statements it swaps
LAST: dict = {}


class StartPairAir(FibonacciAir):
    """The program's FibonacciAir with the boundary t(0), t(1) = ``public``."""

    def __init__(self, public):
        self.public = public

    def boundary_constraints(self, trace_length: int):
        return [BoundaryConstraint(row=0, register=0, value=self.public[0]),
                BoundaryConstraint(row=1, register=0, value=self.public[1])]


def reference(st: R.Statement) -> bytes:
    return R.prove(st, torch.from_numpy(st.witness().astype(np.int64)))


@pytest.mark.parametrize("public", PAIRS)
@pytest.mark.parametrize("T,tests", [(64, 16), (256, 64)])
def test_a_start_pair_proves_as_the_program(T, tests, public):
    st = R.Statement(RF, T, 4, tests, public)
    assert st.witness()[0, :2].tolist() == [v % P for v in public]
    cfg = StarkConfig(trace_length=T, blowup=4, num_colinearity_tests=tests)
    want = StarkProver(StartPairAir(public), cfg, device="cpu").prove(trace_cols=st.witness())
    assert reference(st) == want


@pytest.mark.parametrize("T,tests", sorted(PINNED))
def test_the_default_statement_keeps_its_bytes(T, tests):
    assert RF.PUBLIC == (1, 1)
    for public in (None, RF.PUBLIC):
        assert H.sha(reference(R.Statement(RF, T, 4, tests, public))) == PINNED[(T, tests)]


def test_the_sample_keeps_the_same_positions_with_statements():
    """The reservoir's draws do not depend on the statements: the same
    proofs as the sample kept before it held statements (pinned)."""
    plain, tagged = H.Sample(2**31 + 17), H.Sample(2**31 + 17)
    for i in range(1000):
        plain.offer(b"%d" % i)
        tagged.offer(b"%d" % i, (i, i + 1))
    kept = [proof for _, proof in tagged.kept]
    assert kept == [proof for _, proof in plain.kept]
    assert hashlib.sha256(b",".join(kept)).hexdigest() == (
        "10353eb2eae2b789ff0e2cb77f706895ec2cfd20bc4fb35e3cea8956c9886c20")
    assert all(public == (int(p), int(p) + 1) for public, p in tagged.kept)
    assert all(public is None for public, _ in plain.kept)


def test_statements_are_drawn_from_the_seed(monkeypatch):
    monkeypatch.setattr(H, "REFERENCE_STATEMENTS", 3)
    rec = H.Record(proof_publics=[(i % 5, 1) for i in range(20)], proof_shas=["x"] * 20)
    got = H.statements(rec, SEED)
    assert len(set(got)) == 3 and set(got) <= {(i, 1) for i in range(5)}
    assert got == H.statements(rec, SEED)
    assert any(set(H.statements(rec, s)) != set(got) for s in range(SEED + 1, SEED + 20))
    few = H.Record(proof_publics=[(2, 1), (1, 1), (2, 1)], proof_shas=["x"] * 3)
    assert H.statements(few, SEED) == [(1, 1), (2, 1)]
    assert H.statements(H.Record(proof_publics=[None] * 4, proof_shas=["x"] * 4), 1) == [None]


def test_each_proof_is_held_to_its_own_statement():
    rec = H.Record(proof_shas=["a", "b", "a", "c", "b"],
                   proof_publics=[(1, 1), (2, 1), (1, 1), (3, 1), (1, 1)])
    got = H.judge(rec, {(1, 1): "a", (2, 1): "b"})
    assert {k: v["value"] for k, v in got.items()} == {
        "mismatched_proofs": 1, "failed_proofs": 0, "compared_proofs": 4,
        "compared_statements": 2}
    assert not H.holds(got)
    assert H.holds(H.judge(rec, {(1, 1): "a", (3, 1): "c"})) is False
    assert H.holds(H.judge(rec, {(3, 1): "c"}))
    assert not H.holds(H.judge(rec, {(9, 9): "c"}))  # nothing compared


def standin(cell, seed, seconds, trace, started, device="cuda"):
    """A driver for these tests: the traffic's ``proofs`` proofs, spread
    evenly over ``statements`` start pairs drawn from the seed, in an order
    drawn from it, each served by the plain reference, with the traffic's
    ``fault``: ``reuse`` hands out the first proof for every statement,
    ``swap`` serves the first two statements each other's proofs."""
    traffic = cell.traffic
    rng = random.Random(seed)
    starts = [(rng.randrange(P), rng.randrange(P)) for _ in range(traffic["statements"])]
    order = [starts[i % len(starts)] for i in range(traffic["proofs"])]
    rng.shuffle(order)
    dev = torch.device(device, 0) if device == "cuda" else torch.device(device)
    t0 = time.time()
    proofs = H.reference_proofs(cell, starts, dev)
    rec = H.Record(setup_s=time.time() - t0)
    served = {"reuse": {s: proofs[order[0]] for s in starts},
              "swap": {**proofs, starts[0]: proofs[starts[1]], starts[1]: proofs[starts[0]]}
              }.get(traffic["fault"], proofs)
    sample = H.Sample(seed)
    for public in order:
        rec.attempted += 1
        rec.latencies_s.append(0.0)
        sample.offer(served[public], public)
    rec.completed = len(order)
    sample.fill(rec)
    LAST.update(rec=rec, first=order[0], swapped={starts[0], starts[1]},
                seconds_a_statement=rec.setup_s / len(starts))
    return rec


def standin_cell(spec_path, base, fault="none", statements=4, proofs=16, trace_length=TINY_T):
    (base / "drivers" / "standin.py").write_text(
        "from benchmark.test_benchmark_statements import standin as run  # noqa: F401\n")
    (base / "traffic" / "standin.json").write_text(json.dumps({
        "driver": "standin", "trace_length": trace_length, "statements": statements,
        "proofs": proofs, "fault": fault}))
    spec = json.loads(spec_path.read_text())
    spec["workloads"].append({"name": "fib.standin", "config": "fibonacci",
                              "traffic": "standin", "chips": 1, "why": "a stand-in"})
    spec_path.write_text(json.dumps(spec))
    return H.load_cell("fib.standin", spec_path, base)


def test_statements_drawn_from_the_seed_read_correct(tiny, monkeypatch):
    monkeypatch.setattr(H, "REFERENCE_STATEMENTS", 3)
    cell = standin_cell(*tiny, statements=5, proofs=20)
    checks = RUN.measure(cell, SEED, 0.1, False, device="cpu", started=0.0)["checks"]
    chosen = set(H.statements(LAST["rec"], SEED))
    assert H.holds(checks), checks
    assert checks["compared_statements"]["value"] == 3
    assert checks["compared_proofs"]["value"] == 12 == sum(
        p in chosen for p in LAST["rec"].proof_publics)


def test_a_proof_handed_out_for_another_statement_fails(tiny):
    cell = standin_cell(*tiny, "reuse")
    out = RUN.measure(cell, SEED, 0.1, False, device="cpu", started=0.0)
    checks, rec = out["checks"], LAST["rec"]
    assert not out["correct"]
    assert checks["compared_statements"]["value"] == 4 and checks["compared_proofs"]["value"] == 16
    assert checks["mismatched_proofs"]["value"] == 12 == sum(
        p != LAST["first"] for p in rec.proof_publics)


def test_two_statements_proofs_swapped_fail(tiny):
    cell = standin_cell(*tiny, "swap")
    out = RUN.measure(cell, SEED, 0.1, False, device="cpu", started=0.0)
    rec = LAST["rec"]
    assert not out["correct"]
    assert out["checks"]["mismatched_proofs"]["value"] == 8 == sum(
        p in LAST["swapped"] for p in rec.proof_publics)


@pytest.mark.gpu
@pytest.mark.parametrize("fault", ["none", "reuse"])
def test_the_standin_at_a_segments_size(tmp_path, fault):
    """T=2^20 (a zkVM segment), 10 statements, 40 proofs: the reference
    proves every statement for the stand-in, then REFERENCE_STATEMENTS of
    them for the comparison."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the stand-in at a segment's size runs on a card")
    cell = standin_cell(*make_tiny(tmp_path), fault, statements=10, proofs=40,
                        trace_length=1 << 20)
    for seed in (2**31 + 201, 4_000_000_017):
        out = RUN.measure(cell, seed, 0.1, False, device="cuda", started=0.0)
        info = out["_info"]
        print(f"standin {fault} seed {seed}: correct {out['correct']} checks "
              f"{ {k: v['value'] for k, v in out['checks'].items()} } reference "
              f"{info['reference_s']:.3f} s for {info['statements']} statements "
              f"({info['reference_s'] / info['statements']:.3f} s each); the stand-in's "
              f"{LAST['seconds_a_statement']:.3f} s a statement")
        assert out["correct"] == (fault == "none")
        assert out["checks"]["compared_statements"]["value"] == H.REFERENCE_STATEMENTS
        if fault == "reuse":
            assert out["checks"]["mismatched_proofs"]["value"] == sum(
                p != LAST["first"] for p in LAST["rec"].proof_publics
                if p in set(H.statements(LAST["rec"], seed)))
