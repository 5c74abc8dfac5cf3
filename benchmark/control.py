"""The control of the comparison that decides ``correct``: the reference
put in the program's place with one of the configuration's guarantees
broken, which the comparison has to fail.

The statement states no precision: its answers are exact bytes.  So the
control breaks the soundness it states: the same statement proved with one
colinearity test fewer (``num_colinearity_tests`` - 1, a weaker proof a
later change might be tempted to serve).  Its reading is the harness's own
comparison (harness.judge) of a run's worth of its proofs (a sample's
size) with the reference's proof of the same statement, the
configuration's default one.  test_benchmark_control.py reads it at each
cell's own size on a card (marked ``gpu``) and at T=256 on the CPU.
"""

from __future__ import annotations

import time

from benchmark import harness as H


def reading(cell: H.Cell, seed: int, device="cuda") -> dict:
    """The checks of a run served by the control, at the cell's size, on
    ``device``: the control's proof offered for every proof of a sample
    (drawn from the seed: all alike), compared with the reference's."""
    import torch

    dev = torch.device(device, 0) if device == "cuda" else torch.device(device)
    t0 = time.time()
    control = H.reference_proofs(cell, [None], dev, tests_less=1)[None]
    reference = H.reference_proofs(cell, [None], dev)
    sample = H.Sample(seed)
    for _ in range(H.SAMPLE):
        sample.offer(control)
    rec = H.Record(attempted=H.SAMPLE, completed=H.SAMPLE)
    sample.fill(rec)
    checks = H.judge(rec, {public: H.sha(proof) for public, proof in reference.items()})
    return {"workload": cell.name, "seed": seed, "checks": checks, "holds": H.holds(checks),
            "seconds": time.time() - t0}
