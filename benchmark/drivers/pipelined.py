"""A closed loop that never lets the pipeline drain: a stream of distinct
statements, each proof's start pair drawn from the seed (uniform in [0,
p)^2) and its device witness made in the timed path from it (the
configuration's ``device_witness``: ``(columns, end pair) =
make(T, start, device)``), fed to ``BatchStarkProver.prove_stream`` in
batches of the traffic's ``batch`` with ``depth`` batches in flight, for
the window's seconds.  The statement of a proof is its public inputs
(start, end pair), which go to the sample with its bytes.

Set-up warms every slot of the ring: its first batch runs the body
eagerly, its second captures the graph, then one batch more replays.
The stream runs on from set-up into the window, so the window opens on a
full pipeline; the proofs yielded in it are completed, and when it closes
the feed stops and the batches still in flight are drained uncounted.  A
proof's latency runs from its batch's first witness call to the moment
its batch's bytes are yielded.  A batch that raises ends the window: it
and the batches in flight behind it count as failed.
"""

from __future__ import annotations

import collections
import random
import time

from benchmark import harness as H

P = 998244353


class Feed:
    """The statements, drawn as the prover pulls them: (columns, public
    inputs) pairs.  ``batches``: for each batch drawn and not yet yielded,
    its first witness call's time and its statements, in order.  Setting
    ``stop`` ends the feed at the next batch's start."""

    def __init__(self, make, length: int, device, seed: int, batch: int):
        self.make, self.length, self.device, self.batch = make, length, device, batch
        self.rng = random.Random(f"segments {seed}")
        self.batches: collections.deque = collections.deque()
        self.stop = False

    def __iter__(self):
        i = 0
        while not (self.stop and i % self.batch == 0):
            if i % self.batch == 0:
                self.batches.append((time.perf_counter(), []))
            start = (self.rng.randrange(P), self.rng.randrange(P))
            cols, end = self.make(self.length, start, device=self.device)
            public = (*start, *end)
            self.batches[-1][1].append(public)
            yield cols, public
            i += 1


def run(cell: H.Cell, seed: int, seconds: float, trace: bool, started: float,
        device="cuda") -> H.Record:
    import torch

    from stark_tpu_torch.batch import BatchStarkProver

    rec = H.Record()
    marks = rec.setup_marks
    device = torch.device(device)
    marks["imports"] = time.time() - started
    if device.type == "cuda":
        torch.cuda.init()
    marks["context"] = time.time() - started
    batch, depth = int(cell.traffic["batch"]), int(cell.traffic["depth"])
    prover = BatchStarkProver(H.port_air(cell), H.stark_config(cell), batch=batch,
                              device=device)
    marks["prover"] = time.time() - started
    feed = Feed(H.port_function(cell.config["device_witness"]), cell.trace_length, device,
                seed, batch)
    stream = prover.prove_stream(feed, depth)
    ring = max(1, depth) + 1
    for i in range(2 * ring + 1):
        next(stream)
        feed.batches.popleft()
        marks[f"warmup{i + 1}"] = time.time() - started
    window = H.TRACED_SECONDS if trace else seconds
    sample = H.Sample(seed)
    rec.setup_s = time.time() - started
    with H.Trace(trace and device.type == "cuda") as tr:
        while True:
            try:
                proofs = next(stream)
            except Exception as e:  # noqa: BLE001 - failed proofs are counted, not fatal
                H.note_failure(rec, e, batch * len(feed.batches))
                break
            now = time.perf_counter()
            first, publics = feed.batches.popleft()
            for proof, public in zip(proofs, publics, strict=True):
                rec.latencies_s.append(now - first)
                sample.offer(proof, public)
            if now - tr.t0 >= window:
                break
    rec.window_s = tr.t1 - tr.t0
    rec.completed = rec.traced_proofs = len(rec.latencies_s)
    rec.attempted = rec.completed + rec.failed
    feed.stop = True
    if not rec.failed:
        for _ in stream:
            pass
    if device.type == "cuda":
        rec.memory_peak_bytes = torch.cuda.max_memory_allocated(device)
    if trace and tr.prof is not None:
        rec.traces = [tr.summary()]
    sample.fill(rec)
    prover.close()
    del prover, stream
    H.release(device)
    return rec
