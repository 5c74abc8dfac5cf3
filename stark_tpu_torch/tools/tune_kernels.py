"""The sweep behind the column NTT's launch shape, and what ``ptxas``
reports for every kernel.  Needs a CUDA card and nvcc.

    python3 -m stark_tpu_torch.tools.tune_kernels [--seed N]

Prints, in this order:

* the card's name and power limit;
* ``ptxas``: registers, spills and static shared memory of every kernel as
  built for the port (``nvcc -Xptxas -v``): the figures in the head
  comments of csrc/ntt.cu and csrc/hash.cu;
* ``ntt``: K1's and K2's device time, strict and lazy, at the shapes of
  the two full-width proves, for every tile width and thread count the
  kernels accept, each first held against the plain version.  The rule in
  ``ntt_fused._launch_shape`` was read off these lines.

(K8's subtree size, ``hash_batch.tail_sub_lg``, and ``TAIL_CUTOVER`` have
their sweeps in chip_smoke.py.)

Times are device time per call (``device_us``); every call takes the next
of several sets of buffers, at least 128 MiB apart, so the operands come
from device memory.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys

import numpy as np
import torch

from stark_tpu_torch.ops import cuda
from stark_tpu_torch.ops import ntt_fused as NTF

CYCLE_BYTES = 128 << 20
# (batch, n, inverse) of the transforms of FibonacciAir T=2^20 and
# MdsSquareAir T=2^16 at blowup 4.
PASS_SHAPES = ((1, 1 << 20, True), (1, 1 << 22, False),
               (8, 1 << 16, True), (8, 1 << 18, False))
THREADS = (128, 256, 512, 1024)
SMEM_BYTES = 227 * 1024  # csrc/ntt.cu kSmemMax


def device_us(fn, reps: int) -> float:
    """Device time per call of ``fn`` in us: ``reps`` calls captured into a
    CUDA graph, the replay timed between two events.  No host work lies
    between the kernels, only the graph's own step from one node to the
    next, so a few-us kernel reads about a us longer than a profile of it
    shows (torch.profiler itself stops recording a minute or so into a
    process on some machines, too soon for this sweep)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) * 1e3 / reps


def cycled(fn, args_list):
    """``fn`` on the next set of ``args_list`` at each call."""
    calls = [0]

    def call():
        fn(*args_list[calls[0] % len(args_list)])
        calls[0] += 1

    return call


def sets(nbytes: int, *tensors):
    count = -(-CYCLE_BYTES // nbytes) + 1
    return [tensors] + [tuple(t.clone() for t in tensors) for _ in range(count - 1)]


def ptxas() -> dict:
    """{kernel: "N regs, spill S/L B, smem M B"} for every kernel."""
    found = {}
    for source in cuda.SOURCES:
        proc = subprocess.run(
            [cuda._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
             "-std=c++17", "-O3", "-Xptxas", "-v", "-cubin", "-o", os.devnull,
             os.path.join(cuda.CSRC, source)],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source}:\n{proc.stderr}")
        name = None
        spill = ""
        for line in proc.stderr.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                name = m.group(1)
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m:
                spill = f"spill {m.group(1)}/{m.group(2)} B"
            m = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?", line)
            if m and name:
                found[name] = f"{m.group(1)} regs, {spill}, smem {m.group(2) or 0} B"
    return found


def launch_pass(name: str, x3, out, plan, lazy: bool, lg_tc: int, threads: int) -> None:
    """K1 (``pass1``) or K2 on ``x3`` into ``out`` with the given tile
    width and thread count in place of ``_launch_shape``'s."""
    batch = x3.shape[0]
    if name == "pass1":
        (NTF.PASS1_LAZY if lazy else NTF.PASS1).launch(
            x3.device, x3.data_ptr(), out.data_ptr(), plan.tw1.data_ptr(),
            plan.tw1_shoup.data_ptr(), plan.wm.data_ptr(), batch, plan.lg1,
            plan.n2, lg_tc, threads)
    else:
        (NTF.PASS2_LAZY if lazy else NTF.PASS2).launch(
            x3.device, x3.data_ptr(), out.data_ptr(), plan.tw2.data_ptr(),
            plan.tw2_shoup.data_ptr(), batch, plan.lg2, plan.n1, lg_tc, threads)


def tune_ntt(rng, dev) -> None:
    for batch, n, inverse in PASS_SHAPES:
        plan = NTF.get_plan(n, inverse, dev)
        vals = rng.integers(0, 998244353, size=(batch, plan.n1, plan.n2))
        x3 = torch.from_numpy(vals).to(torch.int32).to(dev)
        # every set: an operand and an output buffer of its own
        xs = sets(8 * batch * n, x3, torch.empty_like(x3))
        yts = []
        for x, _ in xs:
            yt = NTF.ntt_transpose(NTF.ntt_pass1(x, plan))
            yts.append((yt, torch.empty_like(yt)))
        for name, args, lg_r, cols in (("pass1", xs, plan.lg1, plan.n2),
                                       ("pass2", yts, plan.lg2, plan.n1)):
            first, out = args[0]
            want = (NTF.pass1_plain if name == "pass1" else NTF.pass2_plain)(first, plan)
            table = {}
            for lg_tc in range(2, 8):
                # the twiddle pairs, the tile and at most a quarter of padding
                words = (1 << lg_r) + (1 << (lg_r + lg_tc)) * 1.25
                if (1 << lg_tc) > cols or words * 4 > SMEM_BYTES:
                    continue
                for threads in THREADS:
                    times = []
                    for lazy in (False, True):
                        out.zero_()
                        launch_pass(name, first, out, plan, lazy, lg_tc, threads)
                        torch.cuda.synchronize()
                        if not torch.equal(out, want):
                            raise AssertionError(
                                f"{name} n={n} tile {1 << lg_tc} x {threads} threads "
                                f"lazy={lazy} != plain")
                        times.append(round(device_us(cycled(
                            lambda a, o, lazy=lazy: launch_pass(
                                name, a, o, plan, lazy, lg_tc, threads),
                            args), 30), 2))
                    table[f"{1 << lg_tc}x{threads}"] = times
            used = NTF._launch_shape(lg_r, cols, batch)
            print(f"ntt {name} batch={batch} n=2^{n.bit_length() - 1} (lg_r={lg_r}; "
                  f"in use tile {1 << used[0]} x {used[1]} threads) us [strict, lazy] "
                  f"by tile columns x threads: {json.dumps(table)}", flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("tune_kernels: no CUDA device visible", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    print("ptxas: " + json.dumps(ptxas(), indent=1), flush=True)
    tune_ntt(np.random.default_rng(args.seed), torch.device("cuda"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
