"""A closed loop of one client, one proof in flight: each proof's witness,
made in the timed path, and ``StarkProver.prove`` until its bytes are
returned, then the next, for the window's seconds.

Each proof's latency is the host clock from the call to its bytes.  A
traced run times each proof's witness (a span that ends in a synchronize)
and its phases (``PhaseTimer`` with a synchronize: ``fri_fetch`` +
``fri_emit`` are the host's emission after the read).  A proof that raises
has failed, and the loop goes on.
"""

from __future__ import annotations

import time

from benchmark import harness as H


def run(cell: H.Cell, seed: int, seconds: float, trace: bool, started: float,
        device="cuda") -> H.Record:
    import torch

    from stark_tpu_torch import StarkProver

    rec = H.Record()
    marks = rec.setup_marks
    device = torch.device(device)
    marks["imports"] = time.time() - started
    if device.type == "cuda":
        torch.cuda.init()
    marks["context"] = time.time() - started
    make = H.port_function(cell.config["device_witness"])
    prover = StarkProver(H.port_air(cell), H.stark_config(cell), device=device)
    marks["prover"] = time.time() - started

    def witness():
        return make(cell.trace_length, device=device)

    for i in range(H.WARMUP_PROOFS):
        prover.prove(trace_cols=witness())
        marks[f"warmup{i + 1}"] = time.time() - started
    step = H.ClosedLoop(prover, witness, device, trace)
    window = H.TRACED_SECONDS if trace else seconds
    sample = H.Sample(seed)
    rec.setup_s = time.time() - started
    with H.Trace(trace and device.type == "cuda") as tr:
        while time.perf_counter() - tr.t0 < window:
            step(rec, sample)
    rec.window_s = tr.t1 - tr.t0
    rec.completed = rec.traced_proofs = len(rec.latencies_s)
    if device.type == "cuda":
        rec.memory_peak_bytes = torch.cuda.max_memory_allocated(device)
    if trace:
        rec.spans = step.spans
        if tr.prof is not None:
            rec.traces = [tr.summary()]
    rec.proof_shas = [H.sha(p) for p in sample.kept]
    prover.close()
    del prover, step
    H.release(device)
    return rec
