"""The control of the comparison that decides ``correct``: the reference
put in the program's place with one of the configuration's guarantees
broken, which the comparison has to fail.

The statement states no precision: its answers are exact bytes.  So the
control breaks the soundness it states: the same statement proved with one
colinearity test fewer (``num_colinearity_tests`` - 1, a weaker proof a
later change might be tempted to serve).  Its reading is the harness's own
comparison (harness.judge) of a run's worth of its proofs (a sample's
size) with the reference's proof.  test_benchmark_control.py reads it at
each cell's own size on a card (marked ``gpu``) and at T=256 on the CPU.
The statement's witness does not depend on the seed (PERF.md), so the
seeds read alike.
"""

from __future__ import annotations

import time

from benchmark import harness as H


def statement(cell: H.Cell, tests_less: int = 0):
    from benchmark.reference import prover as R

    return R.Statement(cell.reference_air, cell.trace_length, cell.config["blowup"],
                       cell.config["num_colinearity_tests"] - tests_less)


def reading(cell: H.Cell, seed: int, device="cuda") -> dict:
    """The checks of a run served by the control, at the cell's size, on
    ``device``: the control's proof offered for every proof of a sample
    (drawn from the seed: all alike), compared with the reference's."""
    import torch

    from benchmark.reference import prover as R

    dev = torch.device(device, 0) if device == "cuda" else torch.device(device)
    cols = torch.from_numpy(cell.reference_air.trace(cell.trace_length).astype("int64")).to(dev)
    t0 = time.time()
    with torch.no_grad():
        control = R.prove(statement(cell, 1), cols)
        reference = R.prove(statement(cell), cols)
    sample = H.Sample(seed)
    for _ in range(H.SAMPLE):
        sample.offer(control)
    rec = H.Record(attempted=H.SAMPLE, completed=H.SAMPLE,
                   proof_shas=[H.sha(p) for p in sample.kept])
    checks = H.judge(rec, H.sha(reference))
    return {"workload": cell.name, "seed": seed, "checks": checks, "holds": H.holds(checks),
            "seconds": time.time() - t0}
