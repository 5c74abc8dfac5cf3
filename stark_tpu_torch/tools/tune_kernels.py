"""The sweeps behind the NTT kernels' launch shapes, what bounds the column
kernels, and what ``ptxas`` reports for every kernel.  Needs a CUDA card and
nvcc.

    python3 -m stark_tpu_torch.tools.tune_kernels [--seed N]

Prints, in this order:

* the card's name and power limit;
* ``ptxas``: registers, spills and static shared memory of every kernel as
  built for the port (``nvcc -Xptxas -v``): the figures in the head
  comments of csrc/ntt.cu and csrc/hash.cu;
* ``floor``: the time of an empty kernel (built here from a two-line
  source, not part of the port) at the grids and block sizes that K2 and
  K3 launch with: what a launch costs before it moves a byte;
* ``parts``: K1 and K2 timed with parts of their work taken out - the
  butterflies, the loads from device memory, the stores to it - in a copy
  of csrc/ntt.cu that this tool patches and builds into a temporary
  directory (the port's library is not touched): what the kernels' time is
  made of, and how much of the memory traffic the arithmetic hides;
* ``ntt pass1``, ``ntt pass2``: K1's and K2's device time, strict and lazy,
  at the shapes of the two full-width proves, for every tile width and
  thread count the kernels accept, each first held against the plain
  version.  The rule in ``ntt_fused._launch_shape`` was read off these
  lines;
* ``ntt transpose``: K3's vector route, its edge route (4-byte accesses
  through a shared tile) on the same shape, and the library call
  ``x3.transpose(1, 2).contiguous()`` on the same operands, each twice;
* ``sponge split`` (first): K9 as it was before its redesign, as an empty
  kernel with its parameters, with its mixes taken out and whole, then
  the kernel in use, in turn and back, for B in {1, 8, 32}: what its time
  is made of (``--only sponge`` runs that alone).

(K8's subtree size, ``hash_batch.tail_sub_lg``, and ``TAIL_CUTOVER`` have
their sweeps in chip_smoke.py.)  ``fib_expand_before`` builds K12
``fib_expand`` as it was before its redesign (one thread an element, three
Montgomery products), and ``sponge_before`` K9 as it was (byte loads and
stores), which chip_smoke.py times beside the kernels in use.

Times are device time per call (``device_us``); every call takes the next
of several sets of buffers, at least 128 MiB apart, so the operands come
from device memory.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile

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

# What ``parts`` takes out of the column kernels, as bits of a mode word
# that the patched launcher passes in the upper bits of pad_shift.
NO_BUTTERFLIES, NO_LOADS, NO_STORES = 1, 2, 4
PARTS = {
    "whole": 0,
    "no butterflies": NO_BUTTERFLIES,
    "no device memory": NO_LOADS | NO_STORES,
    "neither (tile, twiddles, barriers, indices)": NO_BUTTERFLIES | NO_LOADS | NO_STORES,
    "no loads": NO_LOADS,
    "no stores": NO_STORES,
}
# (text of csrc/ntt.cu, its replacement); each must occur exactly once.
PARTS_PATCHES = (
    ("constexpr int kNoPad = 31;", "constexpr int kNoPad = 31;\nint g_mode = 0;"),
    ("    int cols, int lg_tc, int pad_shift, int s0, bool first, bool last) {\n"
     "  constexpr int kM = 1 << Q;",
     "    int cols, int lg_tc, int pad_shift_mode, int s0, bool first, bool last) {\n"
     "  const int mode = pad_shift_mode >> 8;\n"
     "  const int pad_shift = pad_shift_mode & 255;\n"
     "  constexpr int kM = 1 << Q;"),
    ("      if (first) {\n        const uint32_t src",
     "      if (first && (mode & 2)) {\n"
     "        for (int m = 0; m < kM; ++m) v[m] = u + m;\n"
     "      } else if (first) {\n        const uint32_t src"),
    ("    if (!mine) continue;\n#pragma unroll",
     "    if (!mine) continue;\n    if (!(mode & 1))\n#pragma unroll"),
    ("        out[off] = y;", "        if (!(mode & 4) || y == 0xDEADBEEFu) out[off] = y;"),
    ("lg_r, cols, lg_tc, pad_shift);\n  return (int)cudaGetLastError();",
     "lg_r, cols, lg_tc, pad_shift | (g_mode << 8));\n  return (int)cudaGetLastError();"),
    ("const char* stark_cuda_error_string(int code) {",
     "void stark_set_mode(int mode) { g_mode = mode; }\n\n"
     "const char* stark_cuda_error_string(int code) {"),
)

FLOOR_SOURCE = """
#include <cuda_runtime.h>
__global__ void floor_kernel() {}
extern "C" int floor_launch(int blocks, int threads, int smem, void* stream) {
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(floor_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  floor_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
"""


# K12 fib_expand before its redesign: one thread an element, the grid
# capped at 4,096 x 256 threads, three Montgomery products an element.
FIB_EXPAND_BEFORE_SOURCE = """
#include <cuda_runtime.h>
#include <stdint.h>
#include "field.cuh"
using stark::add_mod;
using stark::kP;
using stark::mont_mul;
constexpr uint64_t kR1 = (1ull << 32) % kP;
constexpr uint32_t kR2 = static_cast<uint32_t>(kR1 * kR1 % kP);
extern "C" {
__global__ void fib_expand_before_kernel(const uint32_t* __restrict__ seeds,
                                         uint32_t* __restrict__ out, int nb,
                                         int lg_b, long long length) {
  const uint32_t* s0 = seeds;
  const uint32_t* s1 = seeds + nb;
  const uint32_t* u0 = seeds + 2 * nb;
  const uint32_t* u1 = u0 + (1 << lg_b);
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < length; i += stride) {
    const long long k = i >> lg_b;
    const int j = (int)(i & ((1 << lg_b) - 1));
    out[i] = mont_mul(add_mod(mont_mul(s1[k], u1[j]), mont_mul(s0[k], u0[j])),
                      kR2);
  }
}
int fib_expand_before(const void* seeds, void* out, int nb, int lg_b,
                      long long length, void* stream) {
  long long blocks = (length + 255) / 256;
  if (blocks > 4096) blocks = 4096;
  fib_expand_before_kernel<<<(unsigned)blocks, 256, 0, (cudaStream_t)stream>>>(
      static_cast<const uint32_t*>(seeds), static_cast<uint32_t*>(out), nb,
      lg_b, length);
  return (int)cudaGetLastError();
}
}
"""


# K9 sponge_absorb before its redesign (as csrc/hash.cu had it): byte
# loads of the state, the pending tail and the data, each chunk byte behind
# two compares, byte loops for the new tail and the copy.  kMode 0 is the
# kernel as it was, 1 the same with its mixes taken out (the chunk absorbs,
# loads and stores stay), 2 an empty kernel with its parameters: the three
# parts of its time.
SPONGE_BEFORE_SOURCE = """
#include <cuda_runtime.h>
#include <stdint.h>
#include "field.cuh"
#include "hash.cuh"
using namespace stark;
__device__ __forceinline__ void sponge_chunk(uint32_t (&w)[8], const uint8_t* pend,
                                             int q, const uint8_t* in, int c,
                                             int total) {
#pragma unroll
  for (int k = 0; k < 8; ++k) w[k] = 0;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int x = c + i;
    const uint32_t byte = x >= total ? 0u : x < q ? pend[x] : in[x - q];
    w[i >> 2] |= byte << (8 * (i & 3));
  }
}
template <int kPos>
__device__ __forceinline__ void absorb_prefix(uint32_t (&s)[32],
                                              const uint32_t (&w)[8], int len) {
  if constexpr (kPos < 32) {
    if (kPos < len) {
      absorb_byte<kPos>(s, w[kPos >> 2] >> (8 * (kPos & 3)));
      absorb_prefix<kPos + 1>(s, w, len);
    }
  }
}
template <int kMode>
__global__ void sponge_before_kernel(uint8_t* state, uint8_t* pending, int q,
                                     int fresh, const uint8_t* __restrict__ data,
                                     int m, uint8_t* copy, uint32_t* alpha,
                                     int lanes) {
  if (kMode == 2) return;
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  uint8_t* st = state + 32 * lane;
  uint8_t* pend = pending + 32 * lane;
  const uint8_t* in = data + (long long)m * lane;
  uint32_t s[32];
  if (fresh) {
    hash_init(s);
  } else {
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = st[i];
  }
  const int total = q + m;
  int c = 0;
  uint32_t w[8];
  for (; c + 32 <= total; c += 32) {
    sponge_chunk(w, pend, q, in, c, total);
    absorb_prefix<0>(s, w, 32);
    if (kMode == 0) mix(s);
  }
  const int rest = total - c;
  sponge_chunk(w, pend, q, in, c, total);
#pragma unroll
  for (int i = 0; i < 32; ++i) st[i] = (uint8_t)s[i];
  for (int i = 0; i < rest; ++i) pend[i] = (uint8_t)(w[i >> 2] >> (8 * (i & 3)));
  if (copy != nullptr)
    for (int i = 0; i < m; ++i) copy[(long long)m * lane + i] = in[i];
  if (alpha == nullptr) return;
  if (rest > 0) {
    absorb_prefix<0>(s, w, rest);
    if (kMode == 0) mix(s);
  }
  if (kMode == 0) hash_finish<Form::kOwed>(s);
  uint64_t v = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) v |= (uint64_t)(s[i] & 0xFFu) << (8 * i);
  alpha[lane] = (uint32_t)(v % kP);
}
extern "C" int sponge_before(int mode, void* state, void* pending, int q, int fresh,
                             const void* data, int m, void* copy, void* alpha,
                             int lanes, void* stream) {
  if (q < 0 || q > 31 || m < 0 || lanes < 1 || (fresh && q))
    return (int)cudaErrorInvalidValue;
  const int threads = lanes < 128 ? lanes : 128;
  const int blocks = (lanes + threads - 1) / threads;
  auto* k = mode == 0 ? sponge_before_kernel<0>
            : mode == 1 ? sponge_before_kernel<1> : sponge_before_kernel<2>;
  k<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      static_cast<uint8_t*>(state), static_cast<uint8_t*>(pending), q, fresh,
      static_cast<const uint8_t*>(data), m, static_cast<uint8_t*>(copy),
      static_cast<uint32_t*>(alpha), lanes);
  return (int)cudaGetLastError();
}
"""
#: sponge_before's modes, as ``sponge_split`` names them.
SPONGE_PARTS = {"empty kernel": 2, "no mixes": 1, "whole": 0}


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


def ptxas(sources=cuda.SOURCES, by_source: bool = False) -> dict:
    """{kernel: "N regs, spill S/L B, smem M B"} for every kernel of
    ``sources`` (csrc/ file names, or paths such as a generated K11
    source), one nvcc per source, all at once; ``by_source``: {source:
    {kernel: ...}} (K11's sources name their kernels alike)."""
    procs = [
        subprocess.Popen(
            [cuda._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
             "-std=c++17", "-O3", "-Xptxas", "-v", "-cubin", "-o", os.devnull,
             "-I", cuda.CSRC, os.path.join(cuda.CSRC, source)],
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
        for source in sources
    ]
    found = {}
    for source, proc in zip(sources, procs):
        stderr = proc.communicate()[1]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source}:\n{stderr}")
        name = None
        spill = ""
        if by_source:
            found[source] = {}
        for line in stderr.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                name = m.group(1)
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m:
                spill = f"spill {m.group(1)}/{m.group(2)} B"
            m = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?", line)
            if m and name:
                (found[source] if by_source else found)[name] = (
                    f"{m.group(1)} regs, {spill}, smem {m.group(2) or 0} B")
    return found


def launch_pass(name: str, x3, out, plan, lazy: bool, lg_tc: int, threads: int,
                lib=None) -> None:
    """K1 (``pass1``) or K2 on ``x3`` into ``out`` with the given tile
    width and thread count in place of ``_launch_shape``'s; through the
    port's wrapper, or through ``lib``, a library built by ``parts_library``."""
    batch = x3.shape[0]
    if name == "pass1":
        kernel = NTF.PASS1_LAZY if lazy else NTF.PASS1
        args = (x3.data_ptr(), out.data_ptr(), plan.tw1.data_ptr(),
                plan.tw1_shoup.data_ptr(), plan.wm.data_ptr(), batch, plan.lg1,
                plan.n2, lg_tc, threads)
    else:
        kernel = NTF.PASS2_LAZY if lazy else NTF.PASS2
        args = (x3.data_ptr(), out.data_ptr(), plan.tw2.data_ptr(),
                plan.tw2_shoup.data_ptr(), batch, plan.lg2, plan.n1, lg_tc, threads)
    if lib is None:
        kernel.launch(x3.device, *args)
    elif getattr(lib, kernel.symbol)(
            *args, torch.cuda.current_stream(x3.device).cuda_stream) != 0:
        raise RuntimeError(f"{kernel.symbol} of the patched library failed")


def timed(launch, args, want, what: str, reps: int = 30) -> float:
    """us per call of ``launch(operand, out)`` over the sets ``args``, after
    holding its result on the first set against ``want``."""
    first, out = args[0]
    out.zero_()
    launch(first, out)
    torch.cuda.synchronize()
    if not torch.equal(out, want):
        raise AssertionError(f"{what} != plain")
    return round(device_us(cycled(launch, args), reps), 2)


def build_temporary(source: str, name: str) -> ctypes.CDLL:
    """``source`` compiled beside the port's headers in a temporary
    directory and loaded (the mapping outlives the directory)."""
    with tempfile.TemporaryDirectory() as tmp:
        src, lib = os.path.join(tmp, name + ".cu"), os.path.join(tmp, name + ".so")
        with open(src, "w") as f:
            f.write(source)
        subprocess.run([cuda._nvcc(), *cuda.NVCC_FLAGS, "-I", cuda.CSRC, "-o", lib, src],
                       check=True)
        return ctypes.CDLL(lib)


def parts_library() -> ctypes.CDLL:
    """csrc/ntt.cu with ``PARTS_PATCHES`` applied: the same kernels, which
    leave out what ``stark_set_mode``'s bits name."""
    with open(os.path.join(cuda.CSRC, "ntt.cu")) as f:
        source = f.read()
    for old, new in PARTS_PATCHES:
        if source.count(old) != 1:
            raise RuntimeError(f"csrc/ntt.cu has moved on: {old!r} occurs "
                               f"{source.count(old)} times")
        source = source.replace(old, new)
    lib = build_temporary(source, "ntt_parts")
    for kernel in (NTF.PASS1, NTF.PASS1_LAZY, NTF.PASS2, NTF.PASS2_LAZY):
        getattr(lib, kernel.symbol).argtypes = [*kernel.argtypes, ctypes.c_void_p]
    lib.stark_set_mode.argtypes = [ctypes.c_int]
    lib.stark_set_mode.restype = None
    return lib


def fib_expand_before():
    """A call ``(seeds, nb, length) -> (1, length) int32`` of K12
    fib_expand as it was before its redesign, built here (not part of the
    port): the yardstick of the redesign."""
    fn = build_temporary(FIB_EXPAND_BEFORE_SOURCE, "fib_before").fib_expand_before
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_longlong,
                                                                 ctypes.c_void_p]

    def call(seeds, nb, length):
        out = torch.empty((1, length), dtype=torch.int32, device=seeds.device)
        lg_b = ((seeds.shape[0] - 2 * nb) // 2).bit_length() - 1
        if fn(seeds.data_ptr(), out.data_ptr(), nb, lg_b, length,
              torch.cuda.current_stream(seeds.device).cuda_stream) != 0:
            raise RuntimeError("fib_expand_before failed")
        return out

    return call


def sponge_before():
    """A call ``(sponge, data, copy, alpha, mode=0)`` that absorbs ``data``
    into an ``ops.hash_batch.Sponge`` as ``Sponge.absorb`` does, through K9
    as it was before its redesign (built here, not part of the port), or
    with parts of it taken out (``mode``, see SPONGE_PARTS)."""
    fn = build_temporary(SPONGE_BEFORE_SOURCE, "sponge_before").sponge_before
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2
                   + [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 2
                   + [ctypes.c_int, ctypes.c_void_p])

    def call(sp, data, copy=None, alpha=None, mode=0):
        m = int(data.shape[1])
        if fn(mode, sp.state.data_ptr(), sp.pending.data_ptr(), sp.q, int(sp.fresh),
              data.data_ptr(), m, None if copy is None else copy.data_ptr(),
              None if alpha is None else alpha.data_ptr(), sp.lanes,
              torch.cuda.current_stream(data.device).cuda_stream) != 0:
            raise RuntimeError("sponge_before failed")
        sp.advance(m)
        return alpha

    return call


def sponge_split(rng, dev, lanes=(1, 8, 32)) -> dict:
    """K9's time split: per B, a root absorbed after a 16-byte tail (the
    Fibonacci prove's round) by the design before as an empty kernel, with
    its mixes taken out, whole, then by the kernel in use, and back in
    reverse order; us per call."""
    from stark_tpu_torch.ops import hash_batch as HB

    before = sponge_before()
    table = {}
    for b in lanes:
        sp = HB.Sponge(b, dev)
        sp.absorb(torch.from_numpy(rng.integers(0, 256, (b, 80), dtype=np.uint8)).to(dev))
        root = torch.from_numpy(rng.integers(0, 256, (b, 32), dtype=np.uint8)).to(dev)
        copy = torch.empty((b, 32), dtype=torch.uint8, device=dev)
        alpha = torch.empty(b, dtype=torch.int32, device=dev)
        calls = {f"before, {part}": (lambda mode=mode: before(sp, root, copy, alpha, mode))
                 for part, mode in SPONGE_PARTS.items()}
        calls["in use"] = lambda: sp.absorb(root, copy, alpha)
        order = list(calls) + list(reversed(calls))
        times = {}
        for key in order:
            times.setdefault(key, []).append(round(device_us(calls[key], 50), 3))
        table[f"B={b}"] = times
    return table


def tune_floor(dev) -> None:
    fn = build_temporary(FLOOR_SOURCE, "floor").floor_launch
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    table = {}
    for batch, n, inverse in PASS_SHAPES:
        plan = NTF.get_plan(n, inverse, dev)
        lg_tc, threads = NTF._launch_shape(plan.lg2, plan.n1, batch)
        shapes = {
            "pass2": (batch * (plan.n1 >> lg_tc), threads, NTF._block_bytes(plan.lg2, lg_tc)),
            "transpose": (batch * -(-plan.n1 // 32) * -(-plan.n2 // 128), 256, 0),
        }
        for key, shape in shapes.items():
            def launch(shape=shape):
                if fn(*shape, torch.cuda.current_stream(dev).cuda_stream) != 0:
                    raise RuntimeError(f"floor kernel refused {shape}")

            table[f"batch={batch} n=2^{n.bit_length() - 1} {key} {shape[0]}x{shape[1]}"] = (
                round(device_us(launch, 30), 2))
    print("floor: us per launch of an empty kernel, blocks x threads (and shared "
          "memory) as in use: " + json.dumps(table), flush=True)


def operands(rng, dev, batch: int, n: int, plan):
    """Sets of (operand, output) for pass 1, the transpose and pass 2."""
    vals = rng.integers(0, 998244353, size=(batch, plan.n1, plan.n2))
    x3 = torch.from_numpy(vals).to(torch.int32).to(dev)
    xs = sets(8 * batch * n, x3, torch.empty_like(x3))
    ys, yts = [], []
    for x, _ in xs:
        y = NTF.ntt_pass1(x, plan)
        yt = NTF.ntt_transpose(y)
        ys.append((y, torch.empty_like(yt)))
        yts.append((yt, torch.empty_like(yt)))
    return xs, ys, yts


def tune_parts(rng, dev) -> None:
    lib = parts_library()
    for batch, n, inverse in PASS_SHAPES:
        plan = NTF.get_plan(n, inverse, dev)
        xs, _, yts = operands(rng, dev, batch, n, plan)
        for name, args, lg_r, cols in (("pass1", xs, plan.lg1, plan.n2),
                                       ("pass2", yts, plan.lg2, plan.n1)):
            shape = NTF._launch_shape(lg_r, cols, batch)
            table = {}
            for lazy in (False, True):
                row = {}
                for part, mode in PARTS.items():
                    lib.stark_set_mode(mode)
                    row[part] = round(device_us(cycled(
                        lambda a, o: launch_pass(name, a, o, plan, lazy, *shape, lib=lib),
                        args), 30), 2)
                lib.stark_set_mode(0)
                table["lazy" if lazy else "strict"] = row
            print(f"parts {name} batch={batch} n=2^{n.bit_length() - 1} (tile "
                  f"{1 << shape[0]} x {shape[1]} threads) us: {json.dumps(table)}",
                  flush=True)


def tune_ntt(rng, dev) -> None:
    for batch, n, inverse in PASS_SHAPES:
        plan = NTF.get_plan(n, inverse, dev)
        xs, ys, yts = operands(rng, dev, batch, n, plan)
        size = f"batch={batch} n=2^{n.bit_length() - 1}"
        for name, args, lg_r, cols in (("pass1", xs, plan.lg1, plan.n2),
                                       ("pass2", yts, plan.lg2, plan.n1)):
            want = (NTF.pass1_plain if name == "pass1" else NTF.pass2_plain)(
                args[0][0], plan)
            table = {}
            for lg_tc in range(2, 8):
                if (1 << lg_tc) > cols or NTF._block_bytes(lg_r, lg_tc) > NTF.SMEM_BYTES:
                    continue
                for threads in THREADS:
                    table[f"{1 << lg_tc}x{threads}"] = [
                        timed(lambda a, o, lazy=lazy: launch_pass(
                            name, a, o, plan, lazy, lg_tc, threads), args, want,
                            f"{name} {size} tile {1 << lg_tc} x {threads} lazy={lazy}")
                        for lazy in (False, True)]
            used = NTF._launch_shape(lg_r, cols, batch)
            print(f"ntt {name} {size} (lg_r={lg_r}; in use tile {1 << used[0]} x "
                  f"{used[1]} threads) us [strict, lazy] by tile columns x threads: "
                  f"{json.dumps(table)}", flush=True)

        # K3: the vector route, the edge route, the library call.
        want = NTF.transpose_plain(ys[0][0])
        b, r, c = ys[0][0].shape

        def transpose(vector):
            return lambda a, o: NTF.TRANSPOSE.launch(
                a.device, a.data_ptr(), o.data_ptr(), b, r, c, vector)

        routes = {"vector route": transpose(1), "edge route": transpose(0),
                  "library": lambda a, o: o.copy_(a.transpose(1, 2))}
        table = {key: [timed(fn, ys, want, f"transpose {size} {key}") for _ in range(2)]
                 for key, fn in routes.items()}
        print(f"ntt transpose {size} ({b}, {r}, {c}) us, each twice: "
              f"{json.dumps(table)}", flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--only", choices=("sponge", "floor", "parts", "ntt"),
                        help="run one sweep (after ptxas)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("tune_kernels: no CUDA device visible", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    print("ptxas: " + json.dumps(ptxas(), indent=1), flush=True)
    dev = torch.device("cuda")
    rng = np.random.default_rng(args.seed)
    if args.only in (None, "sponge"):
        print("sponge split, us per call, each in turn and back (CUDA-graph replay): "
              + json.dumps(sponge_split(rng, dev)), flush=True)
    if args.only in (None, "floor"):
        tune_floor(dev)
    if args.only in (None, "parts"):
        tune_parts(rng, dev)
    if args.only in (None, "ntt"):
        tune_ntt(rng, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
