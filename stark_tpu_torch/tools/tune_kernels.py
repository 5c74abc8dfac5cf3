"""The sweeps behind the NTT kernels' launch shapes, what bounds the column
kernels, and what ``ptxas`` reports for every kernel.  Needs a CUDA card and
nvcc.

    python3 -m stark_tpu_torch.tools.tune_kernels [--seed N] [--only SWEEP]

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
* ``hash latency`` (first): one warp hashing a chain of combines with 1,
  2, 4 or 8 lanes a hash, whole, its absorbs alone and its mixes alone:
  what a level of K8 near a root costs (``--only latency``);
* ``forest turns``: K8 at W = 2^16 and K8-forest at (32, 2^11) and (8,
  2^13), the design before (one lane a hash), the design in use and the
  same with the other form between mix rounds, in turn and back, then by
  the most lanes a hash (``--only forest``);
* ``tail in prove``: each K8 launch of profiled Fibonacci T=2^20 proves,
  width and device time (``--only tail-in-prove``; run by path with
  another checkout first on ``PYTHONPATH`` it measures that checkout);
* ``compose turns``: K11 at Fibonacci T=2^20, MDS T=2^16 and batch8's (8,
  1, 2^16), the design before (eager sums), the design in use (lazy sums
  in the generated body), the same AIR in the table form, the table form
  before its redesign (``table_before``), the straight-line form in
  ``__noinline__`` pieces (``compose_pieces``, not kept) and the redesign
  tried and not kept (the coset computed in the kernel,
  ``compose_coset``), then ``distinct_air`` at 1,024 and 3,632
  constraints in the table form, the one before and the pieces, each in turn and
  back with its bound; then ``compose builds``: nvcc's seconds for K11's
  source of ``distinct_air`` at several sizes, in the table form, the
  pieces and the straight-line form (``--only compose``);
* ``lde turns``: pass 1 of the LDE at Fibonacci T=2^20's, MDS T=2^16's
  and batch8's shapes, strict and lazy: K14 then K1 (the design before),
  K1 of an LDE in use (s^e from two short tables) and with one (T, 2)
  table (``lde_one_table``, a patched copy of csrc/ntt.cu), in turn and
  back with the bound; then ``lde phase turns``: a Fibonacci T=2^20
  prove's lde phase (the iNTT, then the LDE) with each design in turn
  (``--only lde``);
* ``fold turns``: K4-dyn at every (B, half) of the device chain's rounds,
  the K9 + fold pair before its redesign and the launch in use, in turn
  and back (``--only fold``);
* ``sponge split``: K9 as it was before its redesign, as an empty
  kernel with its parameters, with its mixes taken out and whole, then
  the kernel in use, in turn and back, for B in {1, 8, 32}: what its time
  is made of (``--only sponge`` runs that alone);
* ``chain split``: K15 (the constraint challenges) at (1, 32), MdsSquareAir's
  32 challenges, whole and with its mixes, the absorbs of its draws' bytes
  or its reductions taken out (a patched copy of csrc/hash.cu in a
  temporary directory), beside the design before its redesign and an
  empty launch, in turn and back: what bounds the kernel; then ``chain
  turns``: K15 at (1, 6), (1, 32), (8, 6) and (1, 7,266), the design
  before (the whole chain's raw draws in shared memory) and the window in
  use, in turn and back (``--only chain``);
* ``witness turns``: K12's Fibonacci entry at T = 2^20 and 2^21, the
  seeds design before the basis and the basis entry in use, in turn and
  back, with the bound and the shares (``--only witness``).

(K8's subtree size, ``hash_batch.tail_sub_lg``, and ``TAIL_CUTOVER`` have
their sweeps in chip_smoke.py.)  ``fib_expand_before`` builds K12
``fib_expand`` as it was before its redesign (one thread an element, three
Montgomery products), ``fib_expand_seeds`` as it was before the basis (the
host's seeds of each run), ``sponge_before`` K9 as it was (byte loads and
stores), ``forest_before`` K8 and K8-forest as they were (one lane a hash
at every level), ``compose_before`` K11 as it was (every sum eager),
``fold_dyn_before`` the pair K9 + K4-dyn as it was (alpha through device
memory, two launches a round), ``table_before`` K11's table form as it
was (a slot a step in local memory), ``challenges_before`` K15 as it was
before its window (the whole chain's raw draws in shared memory, at most
7,264 challenges), ``sample_before`` K10 as it was (one lane a hash),
``floor_kernel`` an empty kernel:
chip_smoke.py times them beside the kernels in use.

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
import time

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


# K15 and K10 before their latest redesigns, as csrc/hash.cu had them: K15
# with the sponge over 8 lanes but the whole chain's raw draws in shared
# memory (at most 7,264 challenges), before the window; K10 one warp a
# proof, the seed's chain repeated in every lane, every candidate's whole
# hash at one lane.  The entries take the port's arguments (hash.cu's
# stark_constraint_challenges and stark_sample_indices).
CHAIN_BEFORE_SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
#include "field.cuh"
#include "hash.cuh"
using stark::hash_finish;
using stark::hash_init;
using stark::mix;
using stark::pack_digest;
extern "C" {
// K15 before its window: a block keeps its 4 proofs' raw draws, the whole
// chain's, in dynamic shared memory (32 bytes a challenge, at most the
// card's 227 KB: 7,264 challenges), and writes the digests and weight
// words after the last draw.
constexpr int kChallengeProofs = 4;
constexpr int kChallengesMax = (227 << 10) / (8 * kChallengeProofs);

__global__ void __launch_bounds__(8 * kChallengeProofs)
    challenges_before_kernel(const uint8_t* __restrict__ roots,
                             uint32_t* state, uint32_t* pending, uint8_t* copy,
                             uint32_t* digests, uint32_t* weights,
                             int challenges, int lanes) {
  extern __shared__ uint32_t raws[];  // [group][challenge][2]: low word, high word
  const int group = threadIdx.x >> 3;
  const long long lane = (long long)blockIdx.x * kChallengeProofs + group;
  const bool mine = lane < lanes;
  const stark::SpongeLanes ln(threadIdx.x & 7);
  uint32_t* raw = raws + 2 * challenges * group;
  uint32_t* kept = raw + (ln.r & 1);
  const bool keeps = ln.r < 2;
  uint32_t root = 0;
  if (mine) {
    const uint8_t* at = roots + 32 * lane + 4 * ln.r;
    uint8_t* to = copy + 32 * lane + 4 * ln.r;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint8_t byte = at[i];
      to[i] = byte;
      root |= (uint32_t)byte << (8 * i);
    }
  }
  uint32_t a[4], s[4];
  stark::split_init<8>(a, ln);
  const uint32_t chunk[1] = {root};
  stark::split_absorb<8>(a, chunk, ln);
  stark::split_mix<8, stark::Form::kBytes, stark::Form::kBytes>(a, ln);
#pragma unroll
  for (int j = 0; j < 4; ++j) s[j] = a[j];
  uint32_t pend = 0;
  for (int k = 0; k < challenges; ++k) {
    const int q = (8 * k) & 31;
    const uint32_t word = stark::split_word(a);
    const uint32_t at0 = __shfl_sync(ln.mask, word, q >> 2, 8);
    const uint32_t at1 = __shfl_sync(ln.mask, word, (q >> 2) + 1, 8);
    uint32_t c[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) c[j] = a[j];
    stark::split_close(c, ln, q ? 9 : 8);
    const uint32_t dig = stark::split_word(c);
    const uint32_t d0 = __shfl_sync(ln.mask, dig, 0, 8);
    const uint32_t d1 = __shfl_sync(ln.mask, dig, 1, 8);
    if (keeps) kept[2 * k] = dig;
    stark::split_absorb_short<8>(a, at0, at1, d0, d1, q, ln);
    const uint32_t delta = (uint32_t)(ln.r - (q >> 2)) & 7u;
    pend = stark::select_bits(0u - (uint32_t)(delta == 0), d0,
                              stark::select_bits(0u - (uint32_t)(delta == 1), d1, pend));
    if (q == 24) {
      stark::split_mix<8, stark::Form::kBytes, stark::Form::kBytes>(a, ln);
#pragma unroll
      for (int j = 0; j < 4; ++j) s[j] = a[j];
      pend = 0;
    }
  }
  if (mine) {
    state[8 * lane + ln.r] = stark::split_word(s);
    pending[8 * lane + ln.r] = pend;
  }
  __syncwarp();
  if (!mine) return;
  constexpr uint32_t kR1 = (uint32_t)((1ull << 32) % stark::kP);
  constexpr uint32_t kR2 = (uint32_t)((uint64_t)kR1 * kR1 % stark::kP);
  for (int j = ln.r; 2 * j < challenges; j += 8) {
    const uint64_t x0 = raw[4 * j] | (uint64_t)raw[4 * j + 1] << 32;
    const uint64_t x1 = raw[4 * j + 2] | (uint64_t)raw[4 * j + 3] << 32;
    const uint32_t wa = (uint32_t)(x0 % stark::kP * kR2 % stark::kP);
    const uint32_t wb = (uint32_t)(x1 % stark::kP * kR1 % stark::kP);
    uint32_t* d = digests + 2 * challenges * lane + 4 * j;
    uint32_t* w = weights + 2 * challenges * lane + 4 * j;
#pragma unroll
    for (int i = 0; i < 4; ++i) d[i] = raw[4 * j + i];
    w[0] = wa;
    w[1] = (uint32_t)(((uint64_t)wa << 32) / stark::kP);
    w[2] = wb;
    w[3] = (uint32_t)(((uint64_t)wb << 32) / stark::kP);
  }
}


constexpr int kSampleMaxReduced = 1 << 14;

__global__ void __launch_bounds__(32)
    sample_before_kernel(const uint4* state, const uint4* pending,
                                int q, uint32_t size_mask, uint32_t reduced,
                                int number, int m, uint32_t* out,
                                uint32_t* count) {
  __shared__ uint32_t seen[kSampleMaxReduced / 32];
  const int b = blockIdx.x;
  const int t = threadIdx.x;
  for (uint32_t i = t; i < (reduced + 31) / 32; i += 32) seen[i] = 0u;
  // The seed challenge (every lane the same chain) and the seed.
  stark::SpongeIn v;
  uint64_t raw = 0;
  stark::sponge_load(v, state + 2 * b, pending + 2 * b, q, false, nullptr, 0,
                     false);
  stark::sponge_step(v, nullptr, nullptr, false, q, false, nullptr, 0, false,
                     nullptr, false, true, &raw);
  uint32_t s[32];
  hash_init(s);
  stark::absorb_word<0>(s, (uint32_t)raw);
  stark::absorb_word<4>(s, (uint32_t)(raw >> 32));
  mix(s);
  hash_finish<stark::Form::kOwed>(s);
  uint4 seed_lo, seed_hi;
  pack_digest(s, seed_lo, seed_hi);
  __syncwarp();
  int found = 0;  // the same in every lane
  uint32_t* row = out + (long long)b * number;
  for (int base = 0; base < m && found < number; base += 32) {
    const uint32_t c = (uint32_t)(base + t);
    hash_init(s);
    stark::absorb_digest(s, seed_lo, seed_hi);
    mix(s);
    stark::absorb_word<0>(s, c);
    mix(s);
    hash_finish<stark::Form::kOwed>(s);
    const uint32_t low32 = (s[28] & 0xFFu) << 24 | (s[29] & 0xFFu) << 16 |
                           (s[30] & 0xFFu) << 8 | (s[31] & 0xFFu);
    const bool valid = (int)c < m;
    const uint32_t red = low32 & (reduced - 1);
    // Lanes past m match only one another (no reduced index is all ones).
    const unsigned same = __match_any_sync(0xFFFFFFFFu, valid ? red : 0xFFFFFFFFu);
    const bool first = valid && (__ffs(same) - 1) == t;
    const bool ok = first && !((seen[red >> 5] >> (red & 31)) & 1u);
    const unsigned accepted = __ballot_sync(0xFFFFFFFFu, ok);
    const int pos = found + __popc(accepted & ((1u << t) - 1u));
    if (ok && pos < number) row[pos] = low32 & size_mask;
    __syncwarp();
    if (ok) atomicOr(&seen[red >> 5], 1u << (red & 31));
    __syncwarp();
    found += __popc(accepted);
  }
  if (found > number) found = number;
  for (int i = found + t; i < number; i += 32) row[i] = 0u;
  if (t == 0) count[b] = (uint32_t)found;
}

int challenges_before(const void* roots, void* state, void* pending,
                                void* copy, void* digests, void* weights,
                                int challenges, int lanes, void* stream) {
  if (challenges < 0 || challenges % 2 || challenges > kChallengesMax || lanes < 1)
    return (int)cudaErrorInvalidValue;
  if (((reinterpret_cast<uintptr_t>(state) | reinterpret_cast<uintptr_t>(pending)) & 15) ||
      ((reinterpret_cast<uintptr_t>(digests) | reinterpret_cast<uintptr_t>(weights)) & 3))
    return (int)cudaErrorMisalignedAddress;
  const int smem = 8 * kChallengeProofs * challenges;
  if (smem > (48 << 10)) {
    const cudaError_t err = cudaFuncSetAttribute(
        challenges_before_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  challenges_before_kernel<<<(lanes + kChallengeProofs - 1) / kChallengeProofs,
                             8 * kChallengeProofs, smem, (cudaStream_t)stream>>>(
      static_cast<const uint8_t*>(roots), static_cast<uint32_t*>(state),
      static_cast<uint32_t*>(pending), static_cast<uint8_t*>(copy),
      static_cast<uint32_t*>(digests), static_cast<uint32_t*>(weights), challenges,
      lanes);
  return (int)cudaGetLastError();
}

int sample_before(const void* state, const void* pending, int q,
                         long long size, long long reduced, int number, int m,
                         void* out, void* count, int lanes, void* stream) {
  if (q < 0 || q > 31 || lanes < 1 || number < 1 || m < 0 || size < 1 ||
      (size & (size - 1)) || size > (1LL << 31) || reduced < 1 ||
      (reduced & (reduced - 1)) || reduced > kSampleMaxReduced || number > reduced)
    return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(state) | reinterpret_cast<uintptr_t>(pending)) & 15)
    return (int)cudaErrorMisalignedAddress;
  sample_before_kernel<<<lanes, 32, 0, (cudaStream_t)stream>>>(
      static_cast<const uint4*>(state), static_cast<const uint4*>(pending), q,
      (uint32_t)(size - 1), (uint32_t)reduced, number, m,
      static_cast<uint32_t*>(out), static_cast<uint32_t*>(count));
  return (int)cudaGetLastError();
}
}
"""

# K15 with parts of its work taken out (``chain_split``): csrc/hash.cu with
# these patches, each (text, replacement) occurring exactly once; the mode
# rides in the top bits of ``challenges``: 1 no mixes (neither a draw's nor
# a chunk's), 2 no absorb of a draw's bytes (one XOR keeps the draws a
# chain), 4 no reductions.
CHAIN_PATCHES = (
    ("constexpr int kChallengeProofs = 4;",
     "constexpr int kChallengeProofs = 4;\nint g_chain_mode = 0;"),
    ("    int challenges, int lanes) {\n  extern __shared__",
     "    int challenges_mode, int lanes) {\n  const int mode = challenges_mode >> 24;\n"
     "  const int challenges = challenges_mode & 0xFFFFFF;\n  extern __shared__"),
    ("      stark::split_close(c, ln, q ? 9 : 8);",
     "      if (!(mode & 1)) stark::split_close(c, ln, q ? 9 : 8);"),
    ("      stark::split_absorb_short<8>(a, at0, at1, d0, d1, q, ln);",
     "      if (!(mode & 2)) stark::split_absorb_short<8>(a, at0, at1, d0, d1, q, ln);\n"
     "      else a[0] ^= d0 ^ d1 ^ at0 ^ at1;"),
    ("      if (q == 24) {  // a full chunk",
     "      if (q == 24 && !(mode & 1)) {  // a full chunk"),
    ("    if (mine) {\n      const long long at",
     "    if (mine && !(mode & 4)) {\n      const long long at"),
    ("      static_cast<uint32_t*>(digests), static_cast<uint32_t*>(weights), challenges,\n"
     "      lanes);",
     "      static_cast<uint32_t*>(digests), static_cast<uint32_t*>(weights),\n"
     "      challenges | g_chain_mode << 24, lanes);"),
    ("}  // extern \"C\"",
     "void stark_set_chain_mode(int mode) { g_chain_mode = mode; }\n}  // extern \"C\""),
)
#: chain_split's modes: what each leaves in.
CHAIN_PARTS = {"whole": 0, "no reductions": 4, "no mixes": 1, "no absorbs": 2,
               "mixes alone": 2 | 4, "neither (loads, shuffles, stores)": 1 | 2 | 4}


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


# K12 fib_expand before the basis (as csrc/witness.cu had it): the same
# grid and walk, from the seeds s0 | s1 | u0 | u1 of one run, which the host
# made and uploaded for every witness (models/fibonacci.fibonacci_seeds).
FIB_EXPAND_SEEDS_SOURCE = """
#include <cuda_runtime.h>
#include <stdint.h>
#include "field.cuh"
using stark::add_mod;
using stark::kP;
using stark::mont_mul;
constexpr uint64_t kR1 = (1ull << 32) % kP;
constexpr uint32_t kR2 = static_cast<uint32_t>(kR1 * kR1 % kP);
extern "C" {
// fib_expand: one CTA of kFibThreads per SM; a thread owns kFibCols
// columns and takes its rows kFibRows at a time.
constexpr int kFibThreads = 256;
constexpr int kFibCols = 8;
constexpr int kFibRows = 4;

// seeds: s0 (nb), s1 (nb), u0 (B), u1 (B), one after the other; B = 2^lg_b.
// The grid's thread count is a multiple of B / kFibCols (fib_expand_seeds).
__global__ void __launch_bounds__(kFibThreads)
    fib_expand_seeds_kernel(const uint32_t* __restrict__ seeds,
                            uint32_t* __restrict__ out, int nb, int lg_b,
                            long long length) {
  const uint32_t* s0 = seeds;
  const uint32_t* s1 = seeds + nb;
  const uint32_t* u0 = seeds + 2 * nb;
  const uint32_t* u1 = u0 + (1 << lg_b);
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long threads = (long long)gridDim.x * blockDim.x;
  if (lg_b < 3) {  // blocks of 1, 2 or 4 columns: an element a step
    for (long long i = tid; i < length; i += threads) {
      const long long k = i >> lg_b;
      const int j = (int)(i & ((1 << lg_b) - 1));
      out[i] = add_mod(mont_mul(s1[k], mont_mul(u1[j], kR2)),
                       mont_mul(s0[k], mont_mul(u0[j], kR2)));
    }
    return;
  }
  const int lg_groups = lg_b - 3;  // column groups of kFibCols
  const int j0 = (int)(tid & ((1 << lg_groups) - 1)) * kFibCols;
  const long long lanes = threads >> lg_groups;
  // Every load a thread makes is issued before it computes: its u values
  // and the seeds of its first kFibRows rows (one trip to memory, where
  // a load at the top of each row's step would make a chain of them).
  uint32_t m0[kFibCols], m1[kFibCols];
#pragma unroll
  for (int c = 0; c < kFibCols; ++c) {
    m0[c] = u0[j0 + c];
    m1[c] = u1[j0 + c];
  }
  long long k0 = tid >> lg_groups;
  uint32_t a[kFibRows], b[kFibRows];
#pragma unroll
  for (int r = 0; r < kFibRows; ++r) {
    const long long k = k0 + r * lanes;
    a[r] = k < nb ? s0[k] : 0u;
    b[r] = k < nb ? s1[k] : 0u;
  }
  // u 2^32 mod p: mont_mul(s, that) = s u mod p.
#pragma unroll
  for (int c = 0; c < kFibCols; ++c) {
    m0[c] = mont_mul(m0[c], kR2);
    m1[c] = mont_mul(m1[c], kR2);
  }
  for (; k0 < nb; k0 += kFibRows * lanes) {
#pragma unroll
    for (int r = 0; r < kFibRows; ++r) {
      const long long k = k0 + r * lanes;
      if (k >= nb) break;
      uint32_t v[kFibCols];
#pragma unroll
      for (int c = 0; c < kFibCols; ++c)
        v[c] = add_mod(mont_mul(b[r], m1[c]), mont_mul(a[r], m0[c]));
      const long long first = (k << lg_b) + j0;
      if (first + kFibCols <= length) {
        uint4* dst = reinterpret_cast<uint4*>(out + first);
        dst[0] = make_uint4(v[0], v[1], v[2], v[3]);
        dst[1] = make_uint4(v[4], v[5], v[6], v[7]);
      } else {
#pragma unroll
        for (int c = 0; c < kFibCols; ++c)
          if (first + c < length) out[first + c] = v[c];
      }
    }
#pragma unroll
    for (int r = 0; r < kFibRows; ++r) {  // the next rows' seeds
      const long long k = k0 + (kFibRows + r) * lanes;
      a[r] = k < nb ? s0[k] : 0u;
      b[r] = k < nb ? s1[k] : 0u;
    }
  }
}

// out must be 16-byte aligned.  sms: the card's SM count (the grid).
int fib_expand_seeds(const void* seeds, void* out, int nb, int lg_b,
                     long long length, int sms, void* stream) {
  long long blocks = sms;
  if (lg_b >= 3) {
    // a whole number of rows of column groups: threads % (B / 8) == 0
    const long long groups = 1LL << (lg_b - 3);
    const long long per_block = groups > kFibThreads ? groups / kFibThreads : 1;
    blocks = (blocks + per_block - 1) / per_block * per_block;
  }
  fib_expand_seeds_kernel<<<(unsigned)blocks, kFibThreads, 0,
                            (cudaStream_t)stream>>>(
      static_cast<const uint32_t*>(seeds), static_cast<uint32_t*>(out), nb,
      lg_b, length);
  return (int)cudaGetLastError();
}
}
"""


# K9 sponge_absorb before its redesign (as csrc/hash.cu had it): byte
# loads of the state, the pending tail and the data, each chunk byte behind
# two compares, byte loops for the new tail and the copy (its absorb of a
# partial chunk, absorb_prefix, is hash.cuh's).  kMode 0 is the
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
# K4-dyn before its redesign (csrc/fold.cu as it was): the fold alone, one
# alpha a row read from device memory, where K9 (Sponge.absorb with
# alpha=) wrote it in a launch of its own; one thread an element, the grid
# capped at 4,096 blocks of 256 threads.
FOLD_DYN_BEFORE_SOURCE = """
#include <cuda_runtime.h>
#include <stdint.h>
#include "field.cuh"
using namespace stark;
constexpr uint64_t kR1 = (1ull << 32) % kP;
constexpr uint32_t kR2 = static_cast<uint32_t>(kR1 * kR1 % kP);
constexpr int kFoldThreads = 256;
__device__ __forceinline__ uint32_t fold_one(uint32_t av, uint32_t bv, uint32_t t,
                                             uint32_t inv2, uint32_t inv2_s) {
  const uint32_t u = mont_mul(t, sub_mod(av, bv));
  return shoup_mul(add_mod(add_mod(av, bv), u), inv2, inv2_s);
}
__global__ void fold_dyn_before_kernel(const uint32_t* __restrict__ codewords,
                                       const uint32_t* __restrict__ inv_x_mont,
                                       const uint32_t* __restrict__ alpha,
                                       uint32_t* __restrict__ out, long long half,
                                       int rows, uint32_t inv2, uint32_t inv2_s) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (int r = blockIdx.y; r < rows; r += gridDim.y) {
    const uint32_t am = mont_mul(alpha[r], kR2);
    const uint32_t* a = codewords + 2 * half * r;
    const uint32_t* b = a + half;
    uint32_t* o = out + half * r;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < half; i += stride)
      o[i] = fold_one(a[i], b[i], mont_mul(inv_x_mont[i], am), inv2, inv2_s);
  }
}
extern "C" int fold_dyn_before(const void* codewords, const void* inv_x_mont,
                               const void* alpha, void* out, long long half, int rows,
                               unsigned inv2, unsigned inv2_s, void* stream) {
  if (rows < 1 || rows > 65535) return (int)cudaErrorInvalidValue;
  long long per_row = (half + kFoldThreads - 1) / kFoldThreads;
  long long cap = 4096 / rows > 0 ? 4096 / rows : 1;
  if (per_row > cap) per_row = cap;
  fold_dyn_before_kernel<<<dim3((unsigned)per_row, (unsigned)rows), kFoldThreads, 0,
                           (cudaStream_t)stream>>>(
      static_cast<const uint32_t*>(codewords), static_cast<const uint32_t*>(inv_x_mont),
      static_cast<const uint32_t*>(alpha), static_cast<uint32_t*>(out), half, rows,
      inv2, inv2_s);
  return (int)cudaGetLastError();
}
"""
# K8 and K8-forest before their redesign (csrc/hash.cu as it was): every
# level one lane a hash, whatever its width.  Its forest entry takes a
# single tree as a forest of one.
FOREST_BEFORE_SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
#include "field.cuh"
#include "hash.cuh"
using namespace stark;
namespace {
constexpr int kTailMaxLg = 10;
constexpr int kTailThreads = 256;
__device__ __forceinline__ void tail_walk(const uint4* src, uint4* out,
                                          long long width, int l0, int lg_n,
                                          long long b, uint4* buf_a,
                                          uint4* buf_b) {
  const uint4* below = nullptr;
  for (int k = 1; k <= lg_n; ++k) {
    const int count = 1 << (lg_n - k);
    uint4* mine = (k & 1) ? buf_a : buf_b;
    const long long first = width - (width >> (l0 + k - 1)) + b * count;
    for (int j = threadIdx.x; j < count; j += blockDim.x) {
      uint4 l_lo, l_hi, r_lo, r_hi;
      if (k == 1) {
        l_lo = __ldcg(src + 4 * j);
        l_hi = __ldcg(src + 4 * j + 1);
        r_lo = __ldcg(src + 4 * j + 2);
        r_hi = __ldcg(src + 4 * j + 3);
      } else {
        l_lo = below[4 * j];
        l_hi = below[4 * j + 1];
        r_lo = below[4 * j + 2];
        r_hi = below[4 * j + 3];
      }
      uint32_t s[32];
      hash_combine<stark::Form::kOwed>(s, l_lo, l_hi, r_lo, r_hi);
      uint4 lo, hi;
      pack_digest(s, lo, hi);
      mine[2 * j] = lo;
      mine[2 * j + 1] = hi;
      out[2 * (first + j)] = lo;
      out[2 * (first + j) + 1] = hi;
    }
    __syncthreads();
    below = mine;
  }
}
__device__ __forceinline__ void tail_body(const uint4* __restrict__ nodes,
                                          uint4* out, long long width,
                                          int lg_sub, int lg_top,
                                          unsigned int* tickets,
                                          uint4* buf_a, uint4* buf_b) {
  __shared__ bool last;
  const long long b = blockIdx.x;
  tail_walk(nodes + 2 * (b << lg_sub), out, width, 0, lg_sub, b, buf_a, buf_b);
  if (lg_top == 0) return;
  const long long tree = b >> lg_top;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(tickets + tree, 1u) == (1u << lg_top) - 1;
    if (last) tickets[tree] = 0;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  const long long roots = width - (width >> (lg_sub - 1)) + (tree << lg_top);
  tail_walk(out + 2 * roots, out, width, lg_sub, lg_top, tree, buf_a, buf_b);
}
}  // namespace
extern "C" {
__global__ void __launch_bounds__(kTailThreads)
    forest_before_kernel(const uint4* __restrict__ nodes, uint4* out,
                               long long width, int lg_sub, int lg_top,
                               unsigned int* tickets) {
  __shared__ uint4 buf_a[1 << kTailMaxLg];
  __shared__ uint4 buf_b[1 << (kTailMaxLg - 1)];
  tail_body(nodes, out, width, lg_sub, lg_top, tickets, buf_a, buf_b);
}
int forest_before(const void* nodes, void* out, long long width,
                        int lg_sub, int lg_top, void* tickets, void* stream) {
  if (lg_sub < 1 || lg_sub > kTailMaxLg || lg_top < 0 ||
      lg_top > kTailMaxLg || (width & ((1LL << (lg_sub + lg_top)) - 1)) ||
      (lg_top > 0 && !tickets))
    return (int)cudaErrorInvalidValue;
  int threads = 1 << ((lg_sub > lg_top ? lg_sub : lg_top) - 1);
  if (threads < 32) threads = 32;
  if (threads > kTailThreads) threads = kTailThreads;
  forest_before_kernel<<<(unsigned)(width >> lg_sub), threads, 0,
                               (cudaStream_t)stream>>>(
      static_cast<const uint4*>(nodes), static_cast<uint4*>(out), width,
      lg_sub, lg_top, static_cast<unsigned int*>(tickets));
  return (int)cudaGetLastError();
}
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
    """{kernel: "N regs, spill S/L B, stack F B, smem M B"} for every kernel of
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
        spill = stack = ""
        if by_source:
            found[source] = {}
        for line in stderr.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                name = m.group(1)
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                          r"(\d+) bytes spill loads", line)
            if m:
                stack = f"stack {m.group(1)} B"
                spill = f"spill {m.group(2)}/{m.group(3)} B"
            m = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?", line)
            if m and name:
                (found[source] if by_source else found)[name] = (
                    f"{m.group(1)} regs, {spill}, {stack}, smem {m.group(2) or 0} B")
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


def build_temporary(source: str, name: str, headers: dict | None = None) -> ctypes.CDLL:
    """``source`` compiled beside the port's headers (and ``headers``,
    {file name: text}, written beside it) in a temporary directory and
    loaded (the mapping outlives the directory)."""
    with tempfile.TemporaryDirectory() as tmp:
        src, lib = os.path.join(tmp, name + ".cu"), os.path.join(tmp, name + ".so")
        for file, text in {**(headers or {}), name + ".cu": source}.items():
            with open(os.path.join(tmp, file), "w") as f:
                f.write(text)
        subprocess.run([cuda._nvcc(), *cuda.NVCC_FLAGS, "-I", tmp, "-I", cuda.CSRC, "-o",
                        lib, src], check=True)
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


def fib_expand_seeds():
    """A call ``(seeds, nb, length) -> (1, length) int32`` of K12
    fib_expand as it was before the basis (the seeds of one run made on
    the host), built here (not part of the port): the yardstick of the
    basis entry."""
    fn = build_temporary(FIB_EXPAND_SEEDS_SOURCE, "fib_seeds").fib_expand_seeds
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]

    def call(seeds, nb, length):
        out = torch.empty((1, length), dtype=torch.int32, device=seeds.device)
        lg_b = ((seeds.shape[0] - 2 * nb) // 2).bit_length() - 1
        if fn(seeds.data_ptr(), out.data_ptr(), nb, lg_b, length, cuda.sm_count(seeds.device),
              torch.cuda.current_stream(seeds.device).cuda_stream) != 0:
            raise RuntimeError("fib_expand_seeds failed")
        return out

    return call


def witness_turns(rng, dev, lengths=(1 << 20, 1 << 21), reps: int = 50) -> dict:
    """K12's Fibonacci entry at the two Fibonacci cells' lengths: the design
    before the basis (fib_expand_seeds, on the default run's seeds) and the
    basis entry in use (a seeded start pair's seeds formed in the kernel),
    each first held against the plain version, then in turn and back
    (before, in use, in use, before); us per call, the bound (4 T bytes
    written at 3.35 TB/s) and each one's share of it (its mean)."""
    from stark_tpu_torch.models import fibonacci as FIB
    from stark_tpu_torch.ops import witness as W

    before = fib_expand_seeds()
    dev = cuda.device_or_raise(dev, "witness_turns")
    table = {}
    for length in lengths:
        seeds, nb = FIB.fibonacci_seeds(length)
        seeds = torch.from_numpy(seeds.view(np.int32)).to(dev)
        basis, _, nb = FIB._basis(length, dev)
        start = tuple(int(v) for v in rng.integers(0, 998244353, 2))
        if not (torch.equal(before(seeds, nb, length),
                            W.fib_expand_plain(basis, nb, length, (1, 1)))
                and torch.equal(W.fib_expand(basis, nb, length, start),
                                W.fib_expand_plain(basis, nb, length, start))):
            raise AssertionError(f"fib_expand at T={length} != plain")
        calls = {"before": lambda: before(seeds, nb, length),
                 "in use": lambda: W.fib_expand(basis, nb, length, start)}
        times = {}
        for key in ("before", "in use", "in use", "before"):
            times.setdefault(key, []).append(round(device_us(calls[key], reps), 2))
        bound = 4 * length / 3.35e12 * 1e6
        table[f"2^{length.bit_length() - 1}"] = {
            **times, "bound_us": round(bound, 3),
            "share_%": {k: round(100 * bound * len(v) / sum(v), 1) for k, v in times.items()}}
    return table


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


def fold_dyn_before():
    """A call ``(codewords, inv_x_mont, sponge, roots, copy, alpha) -> out``
    that computes what ops.fold.fold_dyn
    does by the pair of launches the device chain ran before K4-dyn's
    redesign: K9 absorbs the roots and writes alpha (Sponge.absorb), then
    K4-dyn as it was (FOLD_DYN_BEFORE_SOURCE, built here, not part of the
    port) folds with alpha read from device memory."""
    from stark_tpu_torch.ops import fold as FOLD

    fn = build_temporary(FOLD_DYN_BEFORE_SOURCE, "fold_dyn_before").fold_dyn_before
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int] \
        + [ctypes.c_uint] * 2 + [ctypes.c_void_p]

    def call(codewords, inv_x_mont, sponge, roots, copy, alpha):
        rows, half = codewords.shape[0], codewords.shape[1] // 2
        dev = codewords.device
        out = torch.empty((rows, half), dtype=torch.int32, device=dev)
        sponge.absorb(roots, copy, alpha)
        if fn(codewords.data_ptr(), inv_x_mont.data_ptr(), alpha.data_ptr(), out.data_ptr(),
              half, rows, FOLD.INV2, FOLD.INV2_SHOUP,
              torch.cuda.current_stream(dev).cuda_stream) != 0:
            raise RuntimeError("fold_dyn_before failed")
        return out

    return call


def challenges_before():
    """A call ``(roots, challenges, sponge, copy, digests, weights)`` that
    does what ops.hash_batch.constraint_challenges does, through K15 as it
    was before its window (CHAIN_BEFORE_SOURCE, built here, not part of
    the port; at most BEFORE_CHALLENGES_MAX challenges): the yardstick of
    the window."""
    fn = build_temporary(CHAIN_BEFORE_SOURCE, "challenges_before").challenges_before
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2 + [ctypes.c_void_p]

    def call(roots, challenges, sponge, copy, digests, weights):
        if fn(roots.data_ptr(), sponge.state.data_ptr(), sponge.pending.data_ptr(),
              copy.data_ptr(), digests.data_ptr(), weights.data_ptr(), challenges,
              sponge.lanes, torch.cuda.current_stream(roots.device).cuda_stream) != 0:
            raise RuntimeError("challenges_before failed")
        sponge.q = 8 * challenges % 32
        sponge.fresh = False

    return call


def sample_before():
    """A call ``(sponge, size, reduced, number, m, out, count)`` that does
    what ops.hash_batch.sample_indices does, through K10 as it was before
    its redesign (CHAIN_BEFORE_SOURCE, built here, not part of the port)."""
    fn = build_temporary(CHAIN_BEFORE_SOURCE, "sample_before").sample_before
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
                                           ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 2 \
        + [ctypes.c_int, ctypes.c_void_p]

    def call(sponge, size, reduced, number, m, out, count):
        if fn(sponge.state.data_ptr(), sponge.pending.data_ptr(), sponge.q, size, reduced,
              number, m, out.data_ptr(), count.data_ptr(), sponge.lanes,
              torch.cuda.current_stream(out.device).cuda_stream) != 0:
            raise RuntimeError("sample_before failed")

    return call


def _patched_hash(patches, name: str) -> ctypes.CDLL:
    """csrc/hash.cu with ``patches`` applied (each (text, replacement)
    occurring exactly once), built into a temporary library; its K15 entry
    typed."""
    with open(os.path.join(cuda.CSRC, "hash.cu")) as f:
        source = f.read()
    for old, new in patches:
        if source.count(old) != 1:
            raise RuntimeError(f"csrc/hash.cu has moved on: {old!r} occurs "
                               f"{source.count(old)} times")
        source = source.replace(old, new)
    lib = build_temporary(source, name)
    lib.stark_constraint_challenges.argtypes = \
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    return lib


#: K15's shapes in chain_turns: Fibonacci's, MdsSquareAir's and a batch's,
#: then 3,633 terms (past what the design before takes).
CHAIN_TURN_SHAPES = ((1, 6), (1, 32), (8, 6), (1, 7266))
#: The most challenges the design before draws: its block keeps 4 proofs'
#: whole chains, 32 bytes a challenge, in at most 227 KB of shared memory.
BEFORE_CHALLENGES_MAX = (227 << 10) // 32


def chain_turns(rng, dev, shapes=CHAIN_TURN_SHAPES, reps: int = 50) -> dict:
    """K15 at each (B, challenges) of ``shapes``: the design before (the
    whole chain in shared memory, where the count allows it) and the
    kernel in use (a window), each first held against the plain version,
    then timed in turn and back (before, window, window, before;
    CUDA-graph replay); us a call."""
    from stark_tpu_torch.ops import hash_batch as HB

    designs = {"before": challenges_before(), "window": HB.constraint_challenges}
    out = {}
    for b, ch in shapes:
        roots = torch.from_numpy(rng.integers(0, 256, (b, 32), dtype=np.uint8)).to(dev)
        sp = HB.Sponge(b, dev)
        copy = torch.empty((b, 32), dtype=torch.uint8, device=dev)
        digests = torch.empty((b, ch, 8), dtype=torch.uint8, device=dev)
        weights = torch.empty((b, 2 * ch), dtype=torch.int32, device=dev)
        want = HB.constraint_challenges_plain(roots.cpu(), ch)
        names = [k for k in designs if k != "before" or ch <= BEFORE_CHALLENGES_MAX]
        for key in names:
            for t in (sp.state, sp.pending, digests, weights):
                t.zero_()
            designs[key](roots, ch, sp, copy, digests, weights)
            got = (sp.state.cpu(), sp.pending.cpu(), digests.cpu(), weights.cpu())
            q = sp.q
            if not all(torch.equal(g[:, :q] if i == 1 else g, w[:, :q] if i == 1 else w)
                       for i, (g, w) in enumerate(zip(got, want))):
                raise AssertionError(f"K15 {key} at ({b}, {ch}) != plain")
        times: dict = {}
        for key in names + names[::-1]:
            call = (lambda key=key: designs[key](roots, ch, sp, copy, digests, weights))
            times.setdefault(key, []).append(round(device_us(call, reps), 3))
        out[f"({b}, {ch})"] = times
    return out


def chain_split(rng, dev, b: int = 1, challenges: int = 32) -> dict:
    """K15's time at (B, challenges) split into its parts: the kernel built
    from csrc/hash.cu with CHAIN_PATCHES (a temporary library, the port's
    untouched), run whole and with the mixes, the absorbs of the draws'
    bytes or the reductions taken out (CHAIN_PARTS), beside the design
    before and an empty launch, each in turn and back; us per call."""
    from stark_tpu_torch.ops import hash_batch as HB

    lib = _patched_hash(CHAIN_PATCHES, "hash_chain")
    fn = lib.stark_constraint_challenges
    lib.stark_set_chain_mode.argtypes = [ctypes.c_int]
    lib.stark_set_chain_mode.restype = None
    before, floor = challenges_before(), floor_kernel()
    roots = torch.from_numpy(rng.integers(0, 256, (b, 32), dtype=np.uint8)).to(dev)
    sp = HB.Sponge(b, dev)
    copy = torch.empty((b, 32), dtype=torch.uint8, device=dev)
    digests = torch.empty((b, challenges, 8), dtype=torch.uint8, device=dev)
    weights = torch.empty((b, 2 * challenges), dtype=torch.int32, device=dev)
    want = HB.constraint_challenges_plain(roots.cpu(), challenges)[3]

    def stream():  # a graph captures the launches on its own stream
        return torch.cuda.current_stream(dev).cuda_stream

    def part(mode):
        def call():
            lib.stark_set_chain_mode(mode)
            if fn(roots.data_ptr(), sp.state.data_ptr(), sp.pending.data_ptr(),
                  copy.data_ptr(), digests.data_ptr(), weights.data_ptr(), challenges, b,
                  stream()) != 0:
                raise RuntimeError("the patched K15 failed")
        return call

    part(0)()
    torch.cuda.synchronize()
    if not torch.equal(weights.cpu(), want):
        raise AssertionError("the patched K15, whole, != plain")
    calls = {name: part(mode) for name, mode in CHAIN_PARTS.items()}
    calls["before"] = lambda: before(roots, challenges, sp, copy, digests, weights)
    calls["empty launch"] = lambda: floor(-(-b // 4), 32, 8 * 4 * challenges, stream())
    times: dict = {}
    for key in list(calls) + list(reversed(calls)):
        times.setdefault(key, []).append(round(device_us(calls[key], 50), 3))
    whole = sum(times["whole"]) / 2
    split = {f"{what}, us": round(whole - sum(times[key]) / 2, 3)
             for what, key in (("mixes", "no mixes"), ("absorbs", "no absorbs"),
                               ("reductions", "no reductions"))}
    return {"shape": [b, challenges], "us per call, in turn and back": times,
            "whole less each part's absence": split}


# One warp hashing a chain of combines, d <- combine(d, d), with L lanes a
# hash (L = 1: hash.cuh's one-lane hash_combine; else split_combine), kMode
# 0 the whole combine, 1 its two absorbs and none of its 10 mixes, 2 its
# mixes and no absorb: the latency of one hash of K8's narrow levels and
# what it is made of.  `hashes` hashes side by side (hashes L <= 32; the
# split warp runs whole, as in K8).
HASH_LATENCY_SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
#include "field.cuh"
#include "hash.cuh"
using namespace stark;
template <int L, int kMode>
__global__ void hash_latency_kernel(uint32_t* io, int reps, int hashes) {
  const int u = threadIdx.x;
  if (L == 1 && u >= hashes) return;
  if constexpr (L == 1) {
    uint4 lo = make_uint4(io[8 * u], io[8 * u + 1], io[8 * u + 2], io[8 * u + 3]);
    uint4 hi = make_uint4(io[8 * u + 4], io[8 * u + 5], io[8 * u + 6], io[8 * u + 7]);
    for (int k = 0; k < reps; ++k) {
      uint32_t s[32];
      if (kMode == 2) {
        hash_init(s);
        s[0] += lo.x;
        mix(s);
        mix(s);
        hash_finish<Form::kOwed>(s);
      } else if (kMode == 1) {
        hash_init(s);
        absorb_digest(s, lo, hi);
        absorb_digest(s, hi, lo);
      } else {
        hash_combine<Form::kOwed>(s, lo, hi, lo, hi);
      }
      pack_digest(s, lo, hi);
    }
    io[8 * u] = lo.x ^ lo.y ^ lo.z ^ lo.w ^ hi.x ^ hi.y ^ hi.z ^ hi.w;
  } else {
    constexpr int kW = SplitLane<L>::kW;
    const SplitLane<L> ln(u & (L - 1));
    uint32_t d[kW];
    for (int w = 0; w < kW; ++w) d[w] = u < hashes * L ? io[8 * (u / L) + kW * ln.r + w] : 0u;
    for (int k = 0; k < reps; ++k) {
      uint32_t s[32 / L];
      if (kMode == 2) {
        split_init<L>(s, ln);
        s[0] += d[0];
        split_mix<L, Form::kBytes, Form::kBytes>(s, ln);
        split_mix<L, Form::kBytes, Form::kBytes>(s, ln);
        split_mix<L, Form::kBytes, Form::kOwed>(s, ln);
#pragma unroll 1
        for (int r = 0; r < 6; ++r) split_mix<L, Form::kOwed, Form::kOwed>(s, ln);
        split_mix<L, Form::kOwed, Form::kBytes>(s, ln);
      } else if (kMode == 1) {
        split_init<L>(s, ln);
        split_absorb<L>(s, d, ln);
        split_absorb<L>(s, d, ln);
      } else {
        split_combine<L, Form::kOwed>(s, d, d, ln);
      }
      for (int w = 0; w < kW; ++w) d[w] = pack4(s[4 * w], s[4 * w + 1], s[4 * w + 2], s[4 * w + 3]);
    }
    if (u < hashes * L) io[8 * (u / L) + kW * ln.r] = d[0];
  }
}
template <int L>
int launch_l(int mode, uint32_t* io, int reps, int hashes, cudaStream_t st) {
  if (mode == 0) hash_latency_kernel<L, 0><<<1, 32, 0, st>>>(io, reps, hashes);
  if (mode == 1) hash_latency_kernel<L, 1><<<1, 32, 0, st>>>(io, reps, hashes);
  if (mode == 2) hash_latency_kernel<L, 2><<<1, 32, 0, st>>>(io, reps, hashes);
  return (int)cudaGetLastError();
}
extern "C" int hash_latency(int lanes, int mode, void* io, int reps, int hashes,
                            void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  uint32_t* p = static_cast<uint32_t*>(io);
  if (lanes == 1) return launch_l<1>(mode, p, reps, hashes, st);
  if (lanes == 2) return launch_l<2>(mode, p, reps, hashes, st);
  if (lanes == 4) return launch_l<4>(mode, p, reps, hashes, st);
  return launch_l<8>(mode, p, reps, hashes, st);
}
"""
#: hash_latency's modes.
LATENCY_PARTS = {"combine": 0, "absorbs": 1, "mixes": 2}


def hash_latency(dev, reps: int = 2000) -> dict:
    """us per hash of a chain of combines in one warp, by lanes a hash and
    part (LATENCY_PARTS), one hash and a full warp of them side by side;
    CUDA events around one launch of ``reps`` hashes, after a warm-up."""
    fn = build_temporary(HASH_LATENCY_SOURCE, "hash_latency").hash_latency
    fn.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] + [ctypes.c_int] * 2 + [
        ctypes.c_void_p]
    io = torch.arange(256, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    table = {}
    for lanes in (1, 2, 4, 8):
        for part, mode in LATENCY_PARTS.items():
            for hashes in (1, 32 // lanes):
                fn(lanes, mode, io.data_ptr(), 10, hashes, stream)
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                if fn(lanes, mode, io.data_ptr(), reps, hashes, stream) != 0:
                    raise RuntimeError("hash_latency failed")
                end.record()
                torch.cuda.synchronize()
                table[f"L={lanes} {part} x{hashes}"] = round(
                    start.elapsed_time(end) * 1e3 / reps, 4)
    return table


def _forest_call(fn, extra=()):
    """A call ``(nodes, trees=1) -> levels`` through ``fn``, a C entry
    with stark_merkle_forest's operands (and ``extra`` before the
    stream): the launches ``hash_batch.merkle_forest`` makes, with tickets
    of its own."""
    from stark_tpu_torch.ops import hash_batch as HB

    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                            ctypes.c_void_p] + [ctypes.c_int] * len(extra)
                   + [ctypes.c_void_p])
    tickets = {}

    def call(nodes, trees=1):
        w = nodes.shape[0]
        n = w // trees
        out = torch.empty((w - trees, 32), dtype=torch.uint8, device=nodes.device)
        t = tickets.setdefault(nodes.device, torch.zeros(
            HB.FOREST_MAX_TREES, dtype=torch.int32, device=nodes.device))
        src, pos = nodes, 0
        for sub, top in HB.tail_launches(w.bit_length() - 1, None, n.bit_length() - 1):
            if fn(src.data_ptr(), out[pos:].data_ptr(), w, sub, top, t.data_ptr(), *extra,
                  torch.cuda.current_stream(nodes.device).cuda_stream) != 0:
                raise RuntimeError("forest launch failed")
            left = w >> (sub + top)
            pos += w - left
            src, w = out[pos - left : pos], left
        return out

    return call


def forest_before():
    """A call ``(nodes, trees=1)`` of K8-forest (a tree: trees = 1) as it
    was before its redesign, built here (not part of the port): every
    level one lane a hash."""
    return _forest_call(build_temporary(FOREST_BEFORE_SOURCE, "forest_before").forest_before)


#: The form a split state keeps between mix rounds in csrc/hash.cu, and
#: the other one, which ``forest_form_other`` builds for the A/B.
FORMS = ("stark::Form::kOwed", "stark::Form::kScaled")


def forest_form_other():
    """A call ``(nodes, trees=1)`` of K8-forest as csrc/hash.cu has it but
    with the other form between the split hash's mix rounds (hash.cuh
    Form), built here into a temporary library."""
    with open(os.path.join(cuda.CSRC, "hash.cu")) as f:
        source = f.read()
    found = [form for form in FORMS if f"kSplitForm = {form};" in source]
    if len(found) != 1:
        raise RuntimeError("csrc/hash.cu has moved on: kSplitForm not found")
    other = FORMS[1 - FORMS.index(found[0])]
    source = source.replace(f"kSplitForm = {found[0]};", f"kSplitForm = {other};")
    lib = build_temporary(source, "forest_other_form")
    return _forest_call(lib.stark_merkle_forest, extra=(0,))


def compose_before_source(program) -> str:
    """The AIR's K11 source as the generator wrote it before lazy sums:
    every node of the tape eager (csrc/compose.cuh is the same but for the
    lazy helpers, which this source does not call)."""
    from stark_tpu_torch.ops.compose import shoup

    tape, air = program.tape, program.air
    live = tape.live()

    def ref(j: int) -> str:
        c = tape.const_value(j)
        return f"{c}u" if c is not None else f"n{j}"

    loads, body = [], []
    for j in live:
        node = tape.nodes[j]
        if node[0] == "in":
            loads.append(f"    const uint32_t n{j} = at({node[1]}, {node[2]});")
        elif node[0] == "neg":
            body.append(f"    const uint32_t n{j} = stark::sub_mod(0u, {ref(node[1])});")
        elif node[0] in ("add", "sub"):
            body.append(f"    const uint32_t n{j} = stark::{node[0]}_mod({ref(node[1])}, "
                        f"{ref(node[2])});")
        elif node[0] == "mul":
            ca, cb = tape.const_value(node[1]), tape.const_value(node[2])
            if ca is not None or cb is not None:
                x, w = (node[2], ca) if ca is not None else (node[1], cb)
                body.append(f"    const uint32_t n{j} = stark::shoup_mul(n{x}, {w}u, "
                            f"{int(shoup(w))}u);")
            else:
                body.append(f"    const uint32_t n{j} = stark::mul_mod(n{node[1]}, n{node[2]});")
    inputs = {(tape.nodes[j][1], tape.nodes[j][2]): j for j in live
              if tape.nodes[j][0] == "in"}
    bounds = []
    for i, bc in enumerate(program.boundary):
        j = inputs.get((0, int(bc.register)))
        if j is None:
            loads.append(f"    const uint32_t b{i} = at(0, {int(bc.register)});")
            bounds.append(f"    v[{i}] = b{i};")
        else:
            bounds.append(f"    v[{i}] = n{j};")
    nb, nt = len(program.boundary), program.transitions
    rows = ", ".join(str(g) for g in program.groups) or "0"
    values = ", ".join(f"{int(bc.value) % 998244353}u" for bc in program.boundary) or "0u"
    return "\n".join([
        '#include "compose.cuh"',
        "struct Air {",
        f"  static constexpr int kRegisters = {air.num_registers};",
        f"  static constexpr int kTransitions = {nt};",
        f"  static constexpr int kBoundaries = {nb};",
        f"  static constexpr int kRows = {len(program.rows)};",
        f"  static constexpr int kTerms = {program.terms};",
        "  static constexpr bool kTable = false;",
        "  __device__ __forceinline__ static int boundary_row(int j) {",
        f"    constexpr int k[{max(nb, 1)}] = {{{rows}}};",
        "    return k[j];",
        "  }",
        "  __device__ __forceinline__ static uint32_t boundary_value(int j) {",
        f"    constexpr uint32_t k[{max(nb, 1)}] = {{{values}}};",
        "    return k[j];",
        "  }",
        "  __device__ __forceinline__ static void values(const stark::Frame& at,",
        f"      uint32_t (&c)[{max(nt, 1)}], uint32_t (&v)[{max(nb, 1)}]) {{",
        *loads, *body, *[f"    c[{k}] = {ref(j)};" for k, j in enumerate(tape.outputs)],
        *bounds,
        "  }",
        "};",
        "STARK_COMPOSE_ENTRY(Air)",
        "",
    ])


# K11 as tried in its redesign and not kept (csrc/compose.cuh says why):
# only the LDE and the dinv rows read, exz, x^s_t and x^s_b computed in the
# kernel (a thread's first point from small tables, each next point 2^S
# further by a Shoup product), every sum lazy in 64 bits, the boundaries'
# values folded into row constants of the weights.  Built by compose_coset
# from the AIR's generated source.
COMPOSE_COSET_HEADER = r"""
#pragma once

#include <stdint.h>
#include <string.h>

#include "field.cuh"

namespace stark {

#ifdef __CUDACC__
#define STARK_LDG(p) __ldg(p)
#else
#define STARK_LDG(p) (*(p))
#endif

constexpr uint32_t kR1 = (uint32_t)((1ull << 32) % kP);
constexpr uint32_t kR1Shoup = (uint32_t)(((uint64_t)kR1 << 32) / kP);

__device__ __forceinline__ uint32_t mul_mod(uint32_t a, uint32_t b) {
  return shoup_mul(mont_mul(a, b), kR1, kR1Shoup);
}

__device__ __forceinline__ uint64_t fold64(uint64_t x) {
  return (uint64_t)(uint32_t)(x >> 32) * kR1 + (uint32_t)x;
}

__device__ __forceinline__ uint32_t reduce64(uint64_t x) {
  const uint64_t y = fold64(x);
  const uint32_t lo = (uint32_t)y;
  const uint32_t m = lo * kPinvNeg;
  return reduce_once((uint32_t)(y >> 32) + __umulhi(m, kP) + (lo != 0u ? 1u : 0u));
}

constexpr int kLazyTerms = 16;
constexpr int kFoldTerms = 2;
static_assert((uint64_t)(kP - 1) * (kP - 1) <= ~0ull / kLazyTerms,
              "kLazyTerms products of values below p fit in 64 bits");
static_assert(((1ull << 32) - 1) * kR1 + (1ull << 32) <= 2ull * (kP - 1) * (kP - 1),
              "a folded sum counts as kFoldTerms products");

struct Lazy64 {
  uint64_t x;
  int terms;
  __device__ __forceinline__ Lazy64() : x(0), terms(0) {}
  __device__ __forceinline__ explicit Lazy64(uint32_t k) : x(k), terms(1) {}
  __device__ __forceinline__ void add(uint32_t a, uint32_t w) {
    if (terms == kLazyTerms) {
      x = fold64(x);
      terms = kFoldTerms;
    }
    x += (uint64_t)a * w;
    ++terms;
  }
  __device__ __forceinline__ uint32_t reduce() const { return reduce64(x); }
};

struct Frame {
  const uint32_t* lde;
  uint32_t n;
  uint32_t i;
  uint32_t blowup;
  __device__ __forceinline__ uint32_t operator()(int offset, int reg) const {
    return lde[reg * n + ((i + offset * blowup) & (n - 1))];
  }
};

struct ComposeArgs {
  const uint32_t* lde;
  const uint32_t* small;
  const uint32_t* dinv;
  uint32_t* out;
  uint32_t n;
  int c;
  int blowup;
  int h;
  int lg_stride;
  int proofs;
  uint32_t step[6];
};

struct SmallTables {
  int excluded, x_lo, x_hi, xt_lo, xt_hi, xb_lo, xb_hi;
  __device__ __forceinline__ SmallTables(const ComposeArgs& a, int kExcluded) {
    const int lo = 1 << a.h;
    const int hi = (int)(a.n >> a.h);
    excluded = a.blowup;
    x_lo = excluded + kExcluded;
    x_hi = x_lo + lo;
    xt_lo = x_hi + hi;
    xt_hi = xt_lo + lo;
    xb_lo = xt_hi + hi;
    xb_hi = xb_lo + lo;
  }
};

template <class Air>
struct CosetPoint {
  static constexpr bool kLinear = Air::kTransitions > 0 && Air::kExcluded == 1;
  static constexpr bool kX = Air::kTransitions > 0 && Air::kExcluded > 1;
  static constexpr bool kXt = Air::kTransitions > 0;
  static constexpr bool kXb = Air::kBoundaries > 0;
  uint32_t zc, x, xt, xb, ez, d;
  uint32_t ex[Air::kExcluded > 0 ? Air::kExcluded : 1];

  __device__ __forceinline__ CosetPoint(const ComposeArgs& a, uint32_t i) {
    const SmallTables st(a, Air::kExcluded);
    const uint32_t* t = a.small;
    const uint32_t lo = i & ((1u << a.h) - 1), hi = i >> a.h;
    zc = kXt ? STARK_LDG(t + (i & (a.blowup - 1))) : 0u;
#pragma unroll
    for (int e = 0; e < Air::kExcluded; ++e) ex[e] = kXt ? STARK_LDG(t + st.excluded + e) : 0u;
    x = kXt && Air::kExcluded > 0
            ? mont_mul(STARK_LDG(t + st.x_hi + hi), STARK_LDG(t + st.x_lo + lo)) : 0u;
    xt = kXt ? mont_mul(STARK_LDG(t + st.xt_hi + hi), STARK_LDG(t + st.xt_lo + lo)) : 0u;
    xb = kXb ? mont_mul(STARK_LDG(t + st.xb_hi + hi), STARK_LDG(t + st.xb_lo + lo)) : 0u;
    ez = kLinear ? mont_mul(zc, sub_mod(x, ex[0])) : 0u;
    d = kLinear ? mul_mod(mont_mul(zc, ex[0]), sub_mod(a.step[0], 1u)) : 0u;
  }
  __device__ __forceinline__ void next(const ComposeArgs& a) {
    if (kLinear) ez = add_mod(shoup_mul(ez, a.step[0], a.step[1]), d);
    if (kX) x = shoup_mul(x, a.step[0], a.step[1]);
    if (kXt) xt = shoup_mul(xt, a.step[2], a.step[3]);
    if (kXb) xb = shoup_mul(xb, a.step[4], a.step[5]);
  }
  __device__ __forceinline__ uint32_t exz() const {
    if (kLinear) return ez;
    uint32_t v = zc;
#pragma unroll
    for (int e = 0; e < Air::kExcluded; ++e) v = mont_mul(v, sub_mod(x, ex[e]));
    return v;
  }
};

template <class Air>
constexpr int kComposeWords = 2 * Air::kTerms + 2 * Air::kRows;

template <class Air>
__device__ __forceinline__ uint32_t compose_point(const uint32_t* w,
                                                  const uint32_t (&in)[Air::kInputs],
                                                  const uint32_t* dv,
                                                  const CosetPoint<Air>& cp) {
  uint32_t c[Air::kTransitions > 0 ? Air::kTransitions : 1];
  uint32_t v[Air::kBoundaries > 0 ? Air::kBoundaries : 1];
  Air::values(in, c, v);
  uint32_t total = 0;
  if (Air::kTransitions > 0) {
    Lazy64 sa, sb;
#pragma unroll
    for (int k = 0; k < Air::kTransitions; ++k) {
      sa.add(c[k], w[2 * k]);
      sb.add(c[k], w[2 * k + 1]);
    }
    total = mont_mul(cp.exz(), add_mod(mont_mul(cp.xt, sa.reduce()), sb.reduce()));
  }
  if (Air::kBoundaries > 0) {
    const uint32_t* wk = w + 2 * Air::kTerms;
#pragma unroll
    for (int r = 0; r < Air::kRows; ++r) {
      Lazy64 ra(wk[2 * r]), rb(wk[2 * r + 1]);
#pragma unroll
      for (int j = 0; j < Air::kBoundaries; ++j) {
        if (Air::boundary_row(j) != r) continue;
        ra.add(v[j], w[2 * (Air::kTransitions + j)]);
        rb.add(v[j], w[2 * (Air::kTransitions + j) + 1]);
      }
      total = add_mod(total, mont_mul(dv[r], add_mod(mont_mul(cp.xb, ra.reduce()),
                                                     rb.reduce())));
    }
  }
  return total;
}

template <class Air>
constexpr int kBatch = Air::kInputs + Air::kRows <= 12 ? 4 : Air::kInputs + Air::kRows <= 40 ? 2 : 1;

template <class Air>
__device__ __forceinline__ void compose_thread(const ComposeArgs& a, const uint32_t* w,
                                               int b, uint32_t t) {
  constexpr int kB = kBatch<Air>;
  constexpr int kR = Air::kRows > 0 ? Air::kRows : 1;
  const uint32_t* lde = a.lde + (size_t)b * a.c * a.n;
  uint32_t* out = a.out + (size_t)b * a.n;
  const uint32_t stride = 1u << a.lg_stride;
  CosetPoint<Air> cp(a, t);
  for (uint32_t i0 = t; i0 < a.n; i0 += kB * stride) {
    uint32_t in[kB][Air::kInputs], dv[kB][kR];
#pragma unroll
    for (int q = 0; q < kB; ++q) {
      const uint32_t i = i0 + q * stride;
      if (q > 0 && i >= a.n) break;
      Air::loads(Frame{lde, a.n, i, (uint32_t)a.blowup}, in[q]);
#pragma unroll
      for (int r = 0; r < Air::kRows; ++r) dv[q][r] = a.dinv[r * a.n + i];
    }
#pragma unroll
    for (int q = 0; q < kB; ++q) {
      const uint32_t i = i0 + q * stride;
      if (q > 0 && i >= a.n) break;
      out[i] = compose_point<Air>(w, in[q], dv[q], cp);
      cp.next(a);
    }
  }
}

}

#define STARK_COMPOSE_CHECK(AIR)                                              \
  (n < 1 || (n & (n - 1)) || c != AIR::kRegisters || proofs < 1 ||           \
   proofs > 65535 || blowup < 1 || (blowup & (blowup - 1)) || h < 0 ||       \
   (1LL << h) > n || lg_stride < 0 || (1LL << lg_stride) > n ||              \
   (1LL << lg_stride) % blowup || (long long)c * n > 0xFFFFFFFFLL ||         \
   nwords != stark::kComposeWords<AIR> * proofs)
#define STARK_COMPOSE_ARGS                                                    \
  stark::ComposeArgs a{static_cast<const uint32_t*>(lde),                     \
                       static_cast<const uint32_t*>(small),                   \
                       static_cast<const uint32_t*>(dinv),                    \
                       static_cast<uint32_t*>(out), (uint32_t)n, c, blowup, h, \
                       lg_stride, proofs, {}};                                \
  memcpy(a.step, steps, sizeof(a.step));

#ifdef __CUDACC__
#include <cuda_runtime.h>

namespace stark {

constexpr int kComposeThreads = 256;

template <int kWords>
struct ComposeWords {
  uint32_t w[kWords];
};

template <class Air, int kWords>
__global__ void __launch_bounds__(kComposeThreads)
    compose_coset_kernel(const __grid_constant__ ComposeArgs a,
                         const __grid_constant__ ComposeWords<kWords> w) {
  const uint32_t t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >> a.lg_stride) return;
  const int b = blockIdx.y;
  compose_thread<Air>(a, w.w + kComposeWords<Air> * b, b, t);
}

template <class Air, int kWords>
int compose_launch(const ComposeArgs& a, const void* words, int nwords,
                   cudaStream_t stream) {
  ComposeWords<kWords> w;
  memcpy(w.w, words, 4 * (size_t)nwords);
  const dim3 grid(((1u << a.lg_stride) + kComposeThreads - 1) / kComposeThreads,
                  (unsigned)a.proofs);
  compose_coset_kernel<Air, kWords><<<grid, kComposeThreads, 0, stream>>>(a, w);
  return (int)cudaGetLastError();
}

}

#define STARK_COMPOSE_ENTRY(AIR)                                              \
  extern "C" int compose_coset(const void* lde, const void* small,           \
                               const void* dinv, void* out, long long n,     \
                               int c, int blowup, int h, int lg_stride,      \
                               int proofs, const void* steps,                \
                               const void* words, int nwords, void* stream) { \
    if (STARK_COMPOSE_CHECK(AIR)) return (int)cudaErrorInvalidValue;          \
    STARK_COMPOSE_ARGS                                                        \
    cudaStream_t s = static_cast<cudaStream_t>(stream);                       \
    if (nwords <= 256) return stark::compose_launch<AIR, 256>(a, words, nwords, s); \
    if (nwords <= 2048)                                                       \
      return stark::compose_launch<AIR, 2048>(a, words, nwords, s);           \
    if (nwords <= 8000)                                                       \
      return stark::compose_launch<AIR, 8000>(a, words, nwords, s);           \
    return (int)cudaErrorInvalidValue;                                        \
  }                                                                           \
  extern "C" const char* stark_cuda_error_string(int code) {                  \
    return cudaGetErrorString(static_cast<cudaError_t>(code));                \
  }
#endif
"""


def compose_coset_source(program) -> str:
    """The AIR's generated K11 source (ops/compose.py) rewritten for
    COMPOSE_COSET_HEADER: the frame loads as loads(at, in), the body on
    in[], the excluded points' count."""
    lines = program.source.splitlines()
    loads = [re.match(r"    const uint32_t (\w+) = at\((\d+), (\d+)\);", line) for line in lines]
    found = [m.groups() for m in loads if m]
    out = []
    for line, m in zip(lines, loads):
        if m:
            continue
        if line.startswith('#include "compose.cuh"'):
            line = '#include "compose_coset.cuh"'
        if "static constexpr int kTerms" in line:
            out += [line, f"  static constexpr int kExcluded = {program.air.max_offset};",
                    f"  static constexpr int kInputs = {len(found)};",
                    "  __device__ __forceinline__ static void loads(const stark::Frame& at,",
                    f"                                               uint32_t (&in)[{len(found)}]) {{",
                    *[f"    in[{k}] = at({o}, {r});" for k, (_, o, r) in enumerate(found)],
                    "  }"]
            continue
        if line.strip() == "const stark::Frame& at,":
            out += [f"      const uint32_t (&in)[{len(found)}],"]
            continue
        out.append(line)
        if line.startswith("      uint32_t (&v)[") and line.endswith("{"):  # values' body
            out += [f"    const uint32_t {name} = in[{k}];" for k, (name, _, _) in enumerate(found)]
    return "\n".join(out) + "\n"


def compose_coset(prover):
    """A call ``(lde, alphas, betas) -> codeword`` of K11 as tried in its
    redesign (COMPOSE_COSET_HEADER; not part of the port) for ``prover``'s
    AIR and domain: its small tables, launch stride and weight words are
    made here as that design made them."""
    from stark_tpu_torch.ops import fieldops as F
    from stark_tpu_torch.ops.compose import R1, R2, shoup

    p = 998244353
    prog, d = prover.program, prover.dom
    fn = build_temporary(compose_coset_source(prog), "compose_coset",
                         {"compose_coset.cuh": COMPOSE_COSET_HEADER}).compose_coset
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_int] * 5 + [
        ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_void_p]
    n, blowup, dev = d.N, prover.cfg.blowup, prover.device
    h = (n.bit_length()) // 2
    rho = pow(d.Omega, d.T, p)
    cycle = [F.host_inv(pow(d.offset, d.T, p) * pow(rho, j, p) - 1) * pow(R1, len(d.excluded), p)
             % p for j in range(blowup)]
    parts = [torch.tensor(cycle + [w % p for w in d.excluded], dtype=torch.int64, device=dev)]
    shifts = (1, d.transition_shift, d.boundary_shift)
    for s in shifts:
        base = pow(d.Omega, s, p)
        parts += [F.powers(base, 1 << h, device=dev),
                  F.powers(pow(base, 1 << h, p), n >> h, scale=pow(d.offset, s, p) * R1,
                           device=dev)]
    small = torch.cat(parts).to(torch.int32).contiguous()
    r3 = R2 * R1 % p
    vals = np.asarray([int(bc.value) % p for bc in prog.boundary], dtype=np.uint64)

    def call(lde, alphas, betas):
        lde3 = lde[None] if lde.dim() == 2 else lde
        b = lde3.shape[0]
        a = np.atleast_2d(np.asarray(alphas, dtype=np.int64)).astype(np.uint64) % np.uint64(p)
        bt = np.atleast_2d(np.asarray(betas, dtype=np.int64)).astype(np.uint64) % np.uint64(p)
        wa, wb = a * np.uint64(r3) % np.uint64(p), bt * np.uint64(R2) % np.uint64(p)
        words = [np.stack([wa, wb], axis=2).reshape(b, -1)]
        if prog.rows:
            ks = []
            for w in (wa, wb):
                k = np.zeros((b, len(prog.rows)), dtype=np.uint64)
                for j, g in enumerate(prog.groups):
                    k[:, g] += w[:, prog.transitions + j] * vals[j] % np.uint64(p)
                ks.append((np.uint64(p) - k % np.uint64(p)) % np.uint64(p))
            words.append(np.stack(ks, axis=2).reshape(b, -1))
        words = np.ascontiguousarray(np.concatenate(words, axis=1).astype(np.uint32))
        lg_n = n.bit_length() - 1
        more = max(0, (n * b).bit_length() - 1 - 18)
        stride = max(lg_n - more, min(lg_n, max(8, blowup.bit_length() - 1)))
        step = pow(d.Omega, 1 << stride, p)
        steps = np.asarray([v for x in (step, pow(step, shifts[1], p), pow(step, shifts[2], p))
                            for v in (x, int(shoup(x)))], dtype=np.uint32)
        out = torch.empty((b, n), dtype=torch.int32, device=lde.device)
        if fn(lde3.data_ptr(), small.data_ptr(), prover.tables.dinv.data_ptr(), out.data_ptr(),
              n, lde3.shape[1], blowup, h, stride, b, steps.ctypes.data, words.ctypes.data,
              words.size, torch.cuda.current_stream(lde.device).cuda_stream) != 0:
            raise RuntimeError("compose_coset failed")
        return out[0] if lde.dim() == 2 else out

    return call


# K11's table form as it was before its redesign (the design before): a
# slot a step in local memory (kSlots of them a point), a 20-byte step
# loaded from device memory and a switch a step, each transition output
# read back from its slot by a second loop.  table_before_source writes an
# AIR's tables for it as the generator did then; this header holds its loop,
# its kernel (one point a thread, 256 a block) and its C entry, with the
# port's compose.cuh for the rest.
TABLE_BEFORE_HEADER = r"""
#pragma once
#include <cuda_runtime.h>
#include "compose.cuh"

namespace table_before {

struct Step {
  uint32_t op;
  uint32_t a, b;
  uint32_t k, k_shoup;
};

// A boundary term with its value compiled in, as the design before had it.
struct BoundaryTerm {
  uint32_t term, reg, value;
};

template <class Air>
__device__ __forceinline__ uint32_t point(const stark::ComposeArgs& a,
                                          const stark::Weight* w, int b, long long i) {
  using namespace stark;
  const Frame at{a.lde + (long long)b * a.c * a.span, a.span, a.mask, i, a.blowup};
  uint32_t total = 0;
  if constexpr (Air::kTransitions > 0) {
    uint32_t s[Air::kSlots];
    const Step* steps = Air::steps();
#pragma unroll 1
    for (int q = 0; q < Air::kSlots; ++q) {
      const Step t = steps[q];
      uint32_t x;
      switch (t.op) {
        case 0: x = at((int)t.a, (int)t.b); break;
        case 1: x = t.k; break;
        case 2: x = add_mod(s[t.a], s[t.b]); break;
        case 3: x = sub_mod(s[t.a], s[t.b]); break;
        case 4: x = sub_mod(0u, s[t.a]); break;
        case 5: x = shoup_mul(s[t.a], t.k, t.k_shoup); break;
        default: x = mul_mod(s[t.a], s[t.b]); break;
      }
      s[q] = x;
    }
    const int* out = Air::outputs();
    uint32_t sa = 0, sb = 0;
#pragma unroll 1
    for (int k = 0; k < Air::kTransitions; ++k) {
      const uint32_t ck = s[out[k]];
      const Weight wk = w[k];
      sa = add_mod(sa, shoup_mul(ck, wk.a, wk.a_shoup));
      sb = add_mod(sb, shoup_mul(ck, wk.b, wk.b_shoup));
    }
    total = mont_mul(a.exz[i], add_mod(mont_mul(a.xt[i], sa), sb));
  }
  if constexpr (Air::kBoundaries > 0) {
    const uint32_t xb = a.xb[i];
    const table_before::BoundaryTerm* terms = Air::boundaries();
    const int* ends = Air::row_ends();
    int j = 0;
#pragma unroll 1
    for (int r = 0; r < Air::kRows; ++r) {
      uint32_t sa = 0, sb = 0;
#pragma unroll 1
      for (; j < ends[r]; ++j) {
        const table_before::BoundaryTerm t = terms[j];
        const uint32_t d = sub_open(at(0, (int)t.reg), t.value);
        const Weight wj = w[Air::kTransitions + t.term];
        sa = add_mod(sa, shoup_mul(d, wj.a, wj.a_shoup));
        sb = add_mod(sb, shoup_mul(d, wj.b, wj.b_shoup));
      }
      total = add_mod(total, mont_mul(a.dinv[r * a.n + i], add_mod(mont_mul(xb, sa), sb)));
    }
  }
  return total;
}

template <class Air>
__global__ void __launch_bounds__(256) table_before_kernel(
    const __grid_constant__ stark::ComposeArgs a, const stark::Weight* __restrict__ w) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  const int b = blockIdx.y;
  a.out[(long long)b * a.n + i] = point<Air>(a, w + Air::kTerms * b, b, i);
}

}  // namespace table_before

#define STARK_TABLE_BEFORE_ENTRY(AIR)                                         \
  extern "C" int stark_compose(const void* lde, const void* exz, const void* xt, \
                               const void* xb, const void* dinv, void* out,    \
                               long long n, int c, int blowup, int proofs,     \
                               const void* words, int nwords, long long span,  \
                               const void* values, void* stream) {             \
    const stark::ComposeArgs a{                                                \
        static_cast<const uint32_t*>(lde), static_cast<const uint32_t*>(exz),  \
        static_cast<const uint32_t*>(xt), static_cast<const uint32_t*>(xb),    \
        static_cast<const uint32_t*>(dinv), static_cast<uint32_t*>(out), n, c, \
        blowup, proofs, span, stark::frame_mask(n, span)};                     \
    if (nwords != 4 * AIR::kTerms * proofs) return (int)cudaErrorInvalidValue; \
    const dim3 grid((unsigned)((n + 255) / 256), (unsigned)proofs);            \
    table_before::table_before_kernel<AIR><<<grid, 256, 0,                     \
                                             static_cast<cudaStream_t>(stream)>>>( \
        a, static_cast<const stark::Weight*>(words));                          \
    return (int)cudaGetLastError();                                            \
  }
"""


def table_before_source(program) -> str:
    """``program``'s AIR in K11's table form as the generator wrote it
    before its redesign (TABLE_BEFORE_HEADER): a step a live node that
    needs a value, its slot the step's own, each output's slot, the
    boundary terms by row."""
    from stark_tpu_torch.ops.compose import shoup

    tape, air = program.tape, program.air
    live = tape.live()
    read = set(tape.outputs)
    for j in live:
        if tape.nodes[j][0] in ("add", "sub"):
            read.update(tape.nodes[j][1:])
    ops = ("in", "const", "add", "sub", "neg", "mulc", "mul")
    slot, steps = {}, []
    for j in live:
        node = tape.nodes[j]
        c = tape.const_value(j)
        if c is not None:
            if j not in read:
                continue
            step = ("const", 0, 0, c)
        elif node[0] == "in":
            step = ("in", node[1], node[2], 0)
        elif node[0] == "neg":
            step = ("neg", slot[node[1]], 0, 0)
        elif node[0] in ("add", "sub"):
            step = (node[0], slot[node[1]], slot[node[2]], 0)
        else:
            ca, cb = tape.const_value(node[1]), tape.const_value(node[2])
            if ca is not None or cb is not None:
                x, w = (node[2], ca) if ca is not None else (node[1], cb)
                step = ("mulc", slot[x], 0, w)
            else:
                step = ("mul", slot[node[1]], slot[node[2]], 0)
        slot[j] = len(steps)
        steps.append(step)
    by_row = sorted(range(len(program.boundary)), key=lambda j: program.groups[j])
    ends = np.cumsum(np.bincount(np.asarray(program.groups, dtype=np.int64),
                                 minlength=len(program.rows)))

    def array(ctype, name, items):
        rows = [", ".join(items[k:k + 8]) for k in range(0, len(items), 8)] or ["{}"]
        return [f"__device__ const {ctype} {name}[{max(len(items), 1)}] = {{",
                *(f"    {r}," for r in rows), "};"]

    return "\n".join([
        '#include "table_before.cuh"',
        *array("table_before::Step", "kSteps",
               [f"{{{ops.index(op)}u, {a % (1 << 32)}u, {b}u, {k}u, {int(shoup(k))}u}}"
                for op, a, b, k in steps]),
        *array("int", "kOutputs", [str(slot[j]) for j in tape.outputs]),
        *array("table_before::BoundaryTerm", "kBoundaryTerms",
               [f"{{{j}u, {int(program.boundary[j].register)}u, "
                f"{int(program.boundary[j].value) % 998244353}u}}" for j in by_row]),
        *array("int", "kRowEnds", [str(int(e)) for e in ends]),
        "struct Air {",
        f"  static constexpr int kRegisters = {air.num_registers};",
        f"  static constexpr int kTransitions = {program.transitions};",
        f"  static constexpr int kBoundaries = {len(program.boundary)};",
        f"  static constexpr int kRows = {len(program.rows)};",
        f"  static constexpr int kTerms = {program.terms};",
        f"  static constexpr int kSlots = {len(steps)};",
        "  __device__ __forceinline__ static const table_before::Step* steps() { return kSteps; }",
        "  __device__ __forceinline__ static const int* outputs() { return kOutputs; }",
        "  __device__ __forceinline__ static const table_before::BoundaryTerm* boundaries() {",
        "    return kBoundaryTerms;",
        "  }",
        "  __device__ __forceinline__ static const int* row_ends() { return kRowEnds; }",
        "};",
        "STARK_TABLE_BEFORE_ENTRY(Air)",
        "",
    ])


# K11's straight-line form cut into pieces, the design the table form's
# redesign was timed against and not kept (PERF.md §6): the AIR's
# transition outputs in groups whose straight-line lines (as
# ops/compose.py generate_source writes them: the group's frame loads, its
# nodes, lazy sums included, and two lines a term) stay within
# PIECE_LINES, each group a __noinline__ device function that adds its
# terms into (sa, sb) from the frame; the boundaries as the straight-line
# form has them.
PIECE_LINES = 256
PIECES_HEADER = r"""
#pragma once
#include <cuda_runtime.h>
#include "compose.cuh"

namespace pieces {

template <class Air>
__global__ void __launch_bounds__(256) pieces_kernel(
    const __grid_constant__ stark::ComposeArgs a, const stark::Weight* __restrict__ w) {
  using namespace stark;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  const int b = blockIdx.y;
  const Weight* wb = w + Air::kTerms * b;
  const Frame at{a.lde + (long long)b * a.c * a.span, a.span, a.mask, i, a.blowup};
  uint32_t total = 0;
  if constexpr (Air::kTransitions > 0) {
    const uint2 s = Air::transitions(at, wb);
    total = mont_mul(a.exz[i], add_mod(mont_mul(a.xt[i], s.x), s.y));
  }
  if constexpr (Air::kBoundaries > 0) {
    const uint32_t xb = a.xb[i];
#pragma unroll
    for (int r = 0; r < Air::kRows; ++r) {
      uint32_t sa = 0, sb = 0;
#pragma unroll
      for (int j = 0; j < Air::kBoundaries; ++j) {
        if (Air::boundary_row(j) != r) continue;
        const uint32_t d = sub_open(at(0, Air::boundary_reg(j)), Air::boundary_value(j));
        const Weight wj = wb[Air::kTransitions + j];
        sa = add_mod(sa, shoup_mul(d, wj.a, wj.a_shoup));
        sb = add_mod(sb, shoup_mul(d, wj.b, wj.b_shoup));
      }
      total = add_mod(total, mont_mul(a.dinv[r * a.n + i], add_mod(mont_mul(xb, sa), sb)));
    }
  }
  a.out[(long long)b * a.n + i] = total;
}

}  // namespace pieces

#define STARK_PIECES_ENTRY(AIR)                                               \
  extern "C" int stark_compose(const void* lde, const void* exz, const void* xt, \
                               const void* xb, const void* dinv, void* out,    \
                               long long n, int c, int blowup, int proofs,     \
                               const void* words, int nwords, long long span,  \
                               const void* values, void* stream) {             \
    const stark::ComposeArgs a{                                                \
        static_cast<const uint32_t*>(lde), static_cast<const uint32_t*>(exz),  \
        static_cast<const uint32_t*>(xt), static_cast<const uint32_t*>(xb),    \
        static_cast<const uint32_t*>(dinv), static_cast<uint32_t*>(out), n, c, \
        blowup, proofs, span, stark::frame_mask(n, span)};                     \
    if (nwords != 4 * AIR::kTerms * proofs) return (int)cudaErrorInvalidValue; \
    const dim3 grid((unsigned)((n + 255) / 256), (unsigned)proofs);            \
    pieces::pieces_kernel<AIR><<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>( \
        a, static_cast<const stark::Weight*>(words));                          \
    return (int)cudaGetLastError();                                            \
  }
"""


def _straight_lines(program, outputs: list[int]) -> tuple[list[str], list[str]]:
    """(frame loads, body lines) of the straight-line form for the nodes
    ``outputs`` need, as ops/compose.py generate_source writes them."""
    from stark_tpu_torch.ops import compose as CO

    tape = program.tape
    forms = program._forms

    def ref(j):
        c = tape.const_value(j)
        return f"{c}u" if c is not None else f"n{j}"

    def lazy(j):
        d = forms.get(j, ({}, 0))[0]
        return len(d) >= 2 and any(v not in (1, CO.P - 1) for v in d.values())

    need = set(outputs)
    for j in sorted(program._live, reverse=True):
        if j not in need:
            continue
        node = tape.nodes[j]
        if lazy(j):
            need.update(forms[j][0])
        elif node[0] != "in":
            need.update(x for x in node[1:] if tape.const_value(x) is None)
    loads, body = [], []
    for j in sorted(need):
        node = tape.nodes[j]
        op = node[0]
        if op == "in":
            loads.append(f"  const uint32_t n{j} = at({node[1]}, {node[2]});")
        elif lazy(j):
            d, k = forms[j]
            terms = [f"(uint64_t)n{x} * {c * CO.R1 % CO.P}u" for x, c in sorted(d.items())]
            if k:
                terms.append(f"{k * CO.R1 % CO.P}ull")
            body.append(f"  uint64_t s{j} = {terms[0]};")
            count = 1
            for t in terms[1:]:
                if count == CO.LAZY_TERMS:
                    body.append(f"  s{j} = stark::fold64(s{j});")
                    count = CO.FOLD_TERMS
                body.append(f"  s{j} += {t};")
                count += 1
            body.append(f"  const uint32_t n{j} = stark::reduce64(s{j});")
        elif op == "neg":
            body.append(f"  const uint32_t n{j} = stark::sub_mod(0u, {ref(node[1])});")
        elif op in ("add", "sub"):
            body.append(f"  const uint32_t n{j} = stark::{op}_mod({ref(node[1])}, "
                        f"{ref(node[2])});")
        elif op == "mul":
            a, b = node[1], node[2]
            ca, cb = tape.const_value(a), tape.const_value(b)
            if ca is not None or cb is not None:
                x, w = (b, ca) if ca is not None else (a, cb)
                body.append(f"  const uint32_t n{j} = stark::shoup_mul(n{x}, {w}u, "
                            f"{int(CO.shoup(w))}u);")
            else:
                body.append(f"  const uint32_t n{j} = stark::mul_mod(n{a}, n{b});")
    return loads, body


def pieces_source(program, piece_lines: int = PIECE_LINES) -> str:
    """``program``'s AIR as K11's straight-line form in __noinline__ pieces
    (PIECES_HEADER): the transition outputs grouped in order while a
    group's lines stay within ``piece_lines``."""
    from stark_tpu_torch.ops import compose as CO

    tape, air = program.tape, program.air
    program._forms, program._live = CO._linear_forms(tape), tape.live()
    groups, current = [], []
    for k in range(len(tape.outputs)):
        loads, body = _straight_lines(program, [tape.outputs[x] for x in current + [k]])
        if current and len(loads) + len(body) + 2 * (len(current) + 1) > piece_lines:
            groups.append(current)
            current = []
        current.append(k)
    if current:
        groups.append(current)
    out = ['#include "compose_pieces.cuh"', "namespace stark_air {"]
    for p, ks in enumerate(groups):
        loads, body = _straight_lines(program, [tape.outputs[k] for k in ks])
        out += [f"__device__ __noinline__ uint2 piece{p}(const stark::Frame at, "
                "const stark::Weight* w, uint2 s) {", *loads, *body]
        for k in ks:
            j = tape.outputs[k]
            v = f"{tape.const_value(j)}u" if tape.const_value(j) is not None else f"n{j}"
            out += [f"  s.{f} = stark::add_mod(s.{f}, stark::shoup_mul({v}, w[{k}].{c}, "
                    f"w[{k}].{c}_shoup));" for f, c in (("x", "a"), ("y", "b"))]
        out += ["  return s;", "}"]
    nb = len(program.boundary)
    rows = ", ".join(str(g) for g in program.groups) or "0"
    values = ", ".join(f"{int(bc.value) % CO.P}u" for bc in program.boundary) or "0u"
    regs = ", ".join(str(int(bc.register)) for bc in program.boundary) or "0"
    out += [
        "struct Air {",
        f"  static constexpr int kRegisters = {air.num_registers};",
        f"  static constexpr int kTransitions = {program.transitions};",
        f"  static constexpr int kBoundaries = {nb};",
        f"  static constexpr int kRows = {len(program.rows)};",
        f"  static constexpr int kTerms = {program.terms};",
        "  __device__ __forceinline__ static int boundary_row(int j) {",
        f"    constexpr int k[{max(nb, 1)}] = {{{rows}}};",
        "    return k[j];",
        "  }",
        "  __device__ __forceinline__ static int boundary_reg(int j) {",
        f"    constexpr int k[{max(nb, 1)}] = {{{regs}}};",
        "    return k[j];",
        "  }",
        "  __device__ __forceinline__ static uint32_t boundary_value(int j) {",
        f"    constexpr uint32_t k[{max(nb, 1)}] = {{{values}}};",
        "    return k[j];",
        "  }",
        "  __device__ __forceinline__ static uint2 transitions(const stark::Frame& at,",
        "                                                     const stark::Weight* w) {",
        "    uint2 s = make_uint2(0u, 0u);",
        *[f"    s = piece{p}(at, w, s);" for p in range(len(groups))],
        "    return s;",
        "  }",
        "};",
        "}  // namespace stark_air",
        "STARK_PIECES_ENTRY(stark_air::Air)",
        "",
    ]
    return "\n".join(out)


def _compose_call(lib, program):
    """``lib``'s stark_compose (ops.compose.compose's entry and operands,
    ``program``'s default boundary values; the designs before compile
    theirs in and take the pointer unread) as a call ``(lde, tables, words,
    blowup) -> codeword``."""
    from stark_tpu_torch.ops.compose import COMPOSE

    fn = lib.stark_compose
    fn.argtypes = [*COMPOSE.argtypes, ctypes.c_void_p]

    def call(lde, tables, words, blowup):
        lde3 = lde[None] if lde.dim() == 2 else lde
        b, c, n = lde3.shape
        out = torch.empty((b, n), dtype=torch.int32, device=lde.device)
        if fn(lde3.data_ptr(), tables.exz.data_ptr(), tables.xt.data_ptr(),
              tables.xb.data_ptr(), tables.dinv.data_ptr(), out.data_ptr(), n, c, blowup, b,
              words.data_ptr(), words.numel(), n,
              program.default_values(b, lde.device).data_ptr(),
              torch.cuda.current_stream(lde.device).cuda_stream) != 0:
            raise RuntimeError("stark_compose failed")
        return out[0] if lde.dim() == 2 else out

    return call


def table_before(program):
    """K11's table form as it was before its redesign, for ``program``'s
    AIR: a call ``(lde, tables, words, blowup) -> codeword`` (not part of
    the port)."""
    return _compose_call(build_temporary(table_before_source(program), "table_before",
                                         {"table_before.cuh": TABLE_BEFORE_HEADER}), program)


def compose_pieces(program):
    """K11's straight-line form in pieces (PIECES_HEADER), for
    ``program``'s AIR: a call ``(lde, tables, words, blowup) -> codeword``
    (not part of the port)."""
    return _compose_call(build_temporary(pieces_source(program), "compose_pieces",
                                         {"compose_pieces.cuh": PIECES_HEADER}), program)


def compose_before(program):
    """A call ``(lde, tables, alphas, betas, blowup, words=None) ->
    codeword`` of K11 for ``program``'s AIR as it was before lazy sums,
    built here (not part of the port): every sum of its body eager; the
    same operands, weights (``words``: already on the card) and launch as
    ops.compose.compose."""
    from stark_tpu_torch.ops.compose import COMPOSE

    fn = build_temporary(compose_before_source(program), "compose_before").stark_compose
    fn.argtypes = [*COMPOSE.argtypes, ctypes.c_void_p]

    def call(lde, tables, alphas, betas, blowup, words=None):
        lde3 = lde[None] if lde.dim() == 2 else lde
        b, c, n = lde3.shape
        if words is None:
            words = torch.from_numpy(program.weights(alphas, betas).view(np.int32)).to(
                lde.device)
        out = torch.empty((b, n), dtype=torch.int32, device=lde.device)
        if fn(lde3.data_ptr(), tables.exz.data_ptr(), tables.xt.data_ptr(),
              tables.xb.data_ptr(), tables.dinv.data_ptr(), out.data_ptr(), n, c, blowup, b,
              words.data_ptr(), words.numel(), n,
              program.default_values(b, lde.device).data_ptr(),
              torch.cuda.current_stream(lde.device).cuda_stream) != 0:
            raise RuntimeError("compose_before failed")
        return out[0] if lde.dim() == 2 else out

    return call


def forest_turns(rng, dev) -> dict:
    """K8 at W = 2^16 and K8-forest at (32, 2^11) and (8, 2^13): the design
    before, the design in use and the in-use design with the other form
    between mix rounds, each in turn and back; then the design in use by
    the most lanes a hash; us per call."""
    from stark_tpu_torch.ops import hash_batch as HB

    before, other = forest_before(), forest_form_other()
    table = {}
    for trees in (1, 32, 8):
        w = 1 << 16
        args = sets(64 * w, torch.from_numpy(
            rng.integers(0, 256, size=(w, 32), dtype=np.uint8)).to(dev))
        want = HB.forest_tail_plain(args[0][0], trees)
        calls = {"before": lambda x: before(x, trees),
                 "in use": lambda x: HB.merkle_forest(x, trees),
                 "other form": lambda x: other(x, trees)}
        for key, fn in calls.items():
            if not torch.equal(fn(args[0][0]), want):
                raise AssertionError(f"forest {key} B={trees} != plain")
        order = list(calls) + list(reversed(calls))
        times = {}
        for key in order:
            times.setdefault(key, []).append(round(device_us(cycled(calls[key], args), 20), 2))
        for lanes in HB.LANE_CHOICES:
            times[f"{lanes} lanes"] = round(device_us(cycled(
                lambda x: HB.merkle_forest(x, trees, lanes=lanes), args), 20), 2)
        table[f"B={trees}, n=2^{(w // trees).bit_length() - 1}"] = times
    return table


#: compose_turns' shapes (AIR, T, B) at blowup 4: Fibonacci T=2^20, MDS
#: T=2^16, batch8's (8, 1, 2^16), then the distinct counter (distinct_air)
#: at 1,024 and 3,632 constraints.
COMPOSE_TURN_SHAPES = (("fib", 1 << 20, 1), ("mds", 1 << 16, 1), ("fib", 1 << 14, 8),
                       ("distinct1024", 1 << 16, 1), ("distinct3632", 1 << 16, 1))


#: Threads a block of the table form timed beside the generator's choice
#: (ops/compose.py TABLE_THREADS).
TABLE_THREADS_TRIED = (128, 256)


def compose_turns(rng, dev, shapes=COMPOSE_TURN_SHAPES) -> dict:
    """K11 at ``shapes``: at the paths' AIRs the design before lazy sums,
    the straight-line form in use, the table form, the table form before
    its redesign (table_before), the straight-line form in pieces
    (compose_pieces, not kept) and the coset redesign (compose_coset, not
    kept); at the distinct counters (the table form in use) the table
    form, the one before and the pieces; the table form also at
    TABLE_THREADS_TRIED threads a block.  Every library built first, side by
    side; each call held against the eager compose, then all timed in
    turn and back, with K11's bound (the bytes, or the operations of the
    form that needs the fewest at 33.5e12 a second); us per call."""
    from concurrent.futures import ThreadPoolExecutor

    from stark_tpu_torch import StarkConfig, StarkProver
    from stark_tpu_torch.models import get_model
    from stark_tpu_torch.ops import compose as CO

    cases = []
    for model, t, b in shapes:
        air = (distinct_air(int(model[len("distinct"):])) if model.startswith("distinct")
               else get_model(model)[0])
        prover = StarkProver(air, StarkConfig(trace_length=t, blowup=4), dev)
        table = CO.ComposeProgram(air, prover.program.boundary, table=True)
        cases.append((model, t, b, air, prover, table))
    with ThreadPoolExecutor(4 * len(cases)) as pool:
        jobs = []
        for model, t, b, air, prover, table in cases:
            path = not model.startswith("distinct")
            builds = {"table form": lambda table=table: CO.library(table.source),
                      "table before": lambda table=table: table_before(table),
                      "pieces": lambda prover=prover: compose_pieces(prover.program)}
            for threads in TABLE_THREADS_TRIED:
                builds[f"table form, {threads} threads"] = lambda table=table, t=threads: \
                    _compose_call(build_temporary(re.sub(
                        r"kThreads = \d+;", f"kThreads = {t};", table.source), "table_threads"),
                        table)
            if path:
                builds.update({"before": lambda prover=prover: compose_before(prover.program),
                               "coset redesign": lambda prover=prover: compose_coset(prover),
                               "in use": lambda prover=prover: CO.library(prover.program.source)})
            jobs.append({k: pool.submit(f) for k, f in builds.items()})
        built = [{k: job.result() for k, job in j.items()} for j in jobs]
    out = {}
    for (model, t, b, air, prover, table), libs in zip(cases, built):
        n = prover.dom.N
        lde = torch.from_numpy(rng.integers(0, 998244353, size=(b, air.num_registers, n))).to(
            torch.int32).to(dev)
        al, be = (rng.integers(0, 998244353, size=(b, prover.program.terms)) for _ in range(2))
        want = CO.compose_plain(prover.program, lde, prover.tables, al, be, 4)
        # The weight words on the card, as K15 leaves them: no copy is timed.
        words = torch.from_numpy(prover.program.weights(al, be).view(np.int32)).to(dev)
        calls = {"table form": lambda x: CO.compose(table, x, prover.tables, None, None, 4,
                                                    weights=words),
                 **{k: lambda x, k=k: libs[k](x, prover.tables, words, 4)
                    for k in libs if k.startswith("table form,")},
                 "table before": lambda x: libs["table before"](x, prover.tables, words, 4),
                 "pieces": lambda x: libs["pieces"](x, prover.tables, words, 4)}
        if "before" in libs:
            coset = libs["coset redesign"]
            calls = {"before": lambda x: libs["before"](x, prover.tables, al, be, 4, words=words),
                     "in use": lambda x: CO.compose(prover.program, x, prover.tables, None,
                                                    None, 4, weights=words),
                     **calls, "coset redesign": lambda x: coset(x, al, be)}
        for key, fn in calls.items():
            if not torch.equal(fn(lde), want):
                raise AssertionError(f"compose {key} {model} != the eager compose")
        args = sets(4 * lde.numel(), lde)
        times = {}
        for key in list(calls) + list(reversed(calls)):
            times.setdefault(key, []).append(round(device_us(cycled(calls[key], args), 20), 2))
        ops = min(prover.program.operations(), table.operations(),
                  CO.ComposeProgram(air, prover.program.boundary, table=False).operations())
        nbytes = 4 * n * (b * prover.program.registers_read() + prover.program.table_loads() + b)
        times["bound_us"] = round(max(nbytes / 3.35e12, b * n * ops / 33.5e12) * 1e6, 3)
        times["bound_by"] = "bytes" if nbytes / 3.35e12 >= b * n * ops / 33.5e12 else \
            "operations"
        times["slots"], times["threads"] = table.form.slots, table.form.threads
        out[f"{model} T=2^{t.bit_length() - 1} B={b}"] = times
        print(f"  compose turns {model} T=2^{t.bit_length() - 1} B={b}: " + json.dumps(times),
              flush=True)
    return out


def distinct_air(transitions: int):
    """A counter (x' = x + 1 from 5) with ``transitions`` constraints, the
    step times 1, 2, .., transitions (a distinct linear form each), and one
    boundary constraint: tests/test_torch_many_terms.py's AIR at any size."""
    from stark_tpu_torch.models.air import Air, BoundaryConstraint

    class DistinctAir(Air):
        num_registers = 1
        frame_offsets = (0, 1)
        constraint_degree = 1

        def transition_constraints(self, frame, ops):
            x0, x1 = frame[0][0], frame[1][0]
            step = ops.sub(ops.sub(x1, x0), ops.const(1, x0))
            return [ops.mul(ops.const(i + 1, x0), step) for i in range(transitions)]

        def boundary_constraints(self, trace_length):
            return [BoundaryConstraint(row=0, register=0, value=5)]

    return DistinctAir()


#: (transitions, form) of compose_builds: the table form and the pieces
#: at 1,024 and 3,632 constraints, the straight-line form at 64 and 512
#: (timed before up to 1,024: 103.8 s, PERF.md §6).
BUILD_SIZES = ((1024, "table"), (3632, "table"), (1024, "pieces"), (3632, "pieces"),
               (64, "straight-line"), (512, "straight-line"))


def compose_builds(sizes=BUILD_SIZES, limit: int = 420) -> dict:
    """nvcc's seconds for distinct_air's K11 source by (transitions, form),
    one build at a time (the port's flags, a temporary directory), with
    the source's lines (ops.compose ComposeProgram.lines, the measure
    TABLE_LINES bounds) and bytes; a build past ``limit`` seconds is cut
    and reported so."""
    from stark_tpu_torch.ops import compose as CO
    from stark_tpu_torch.stark import StarkConfig, _Domain

    out = {}
    for transitions, form in sizes:
        air = distinct_air(transitions)
        prog = CO.ComposeProgram(air, _Domain(StarkConfig(trace_length=64, blowup=4),
                                              air).boundary, table=form == "table")
        source, headers = prog.source, {}
        if form == "pieces":
            source, headers = pieces_source(prog), {"compose_pieces.cuh": PIECES_HEADER}
        with tempfile.TemporaryDirectory() as tmp:
            src = os.path.join(tmp, "compose.cu")
            for file, text in {**headers, "compose.cu": source}.items():
                with open(os.path.join(tmp, file), "w") as f:
                    f.write(text)
            t0 = time.perf_counter()
            try:
                rc = subprocess.run([cuda._nvcc(), *cuda.NVCC_FLAGS, "-I", tmp, "-I", cuda.CSRC,
                                     "-o", os.path.join(tmp, "compose.so"), src],
                                    timeout=limit).returncode
                seconds = round(time.perf_counter() - t0, 2)
            except subprocess.TimeoutExpired:
                rc, seconds = None, f"> {limit}"
        key = f"{transitions} {form}"
        out[key] = {"lines": prog.lines, "bytes": len(source), "nvcc_s": seconds, "rc": rc}
        print(f"  compose build {key}: " + json.dumps(out[key]), flush=True)
    return out


#: K1 of an LDE timed at (B, T, N): Fibonacci T=2^20, MDS T=2^16's 8 rows,
#: batch8's 8 rows (blowup 4).
LDE_SHAPES = ((1, 1 << 20, 1 << 22), (8, 1 << 16, 1 << 18), (8, 1 << 14, 1 << 16))
#: csrc/ntt.cu lde_scaled with one (T, 2) table of s^e (its rows pointer)
#: in place of the two short tables: the design timed against the kept one.
LDE_TABLE_PATCH = ("  const uint2 r = lde.rows[row], k = lde.cols[col];\n"
                   "  return shoup_mul(shoup_mul(y, r.x, r.y), k.x, k.y);",
                   "  const uint2 k = lde.rows[e];\n"
                   "  return shoup_mul(y, k.x, k.y);")


def lde_one_table():
    """K1 of an LDE reading s^e from one (T, 2) table (LDE_TABLE_PATCH, a
    patched copy of csrc/ntt.cu built in a temporary directory; not part
    of the port): a call ``(c, plan, s, lazy) -> (B, n1, n2)``."""
    from stark_tpu_torch.ops import ntt_fused as NTF
    from stark_tpu_torch.ops.fieldops import host_powers, shoup_precompute

    with open(os.path.join(cuda.CSRC, "ntt.cu")) as f:
        source = f.read()
    if LDE_TABLE_PATCH[0] not in source:
        raise RuntimeError("csrc/ntt.cu lde_scaled no longer matches LDE_TABLE_PATCH")
    lib = build_temporary(source.replace(*LDE_TABLE_PATCH), "ntt_lde_table")
    fns = {lazy: getattr(lib, "stark_ntt_pass1_lde_lazy" if lazy else "stark_ntt_pass1_lde")
           for lazy in (False, True)}
    for fn in fns.values():
        fn.argtypes = [*NTF.PASS1_LDE.argtypes, ctypes.c_void_p]
    tables = {}

    def call(c, plan, s, lazy=False):
        b, t = c.shape
        if (t, s) not in tables:
            w = host_powers(s, t).astype(np.uint32)
            tables[(t, s)] = torch.from_numpy(np.stack([w, shoup_precompute(w)], axis=1).view(
                np.int32)).to(c.device)
        out = torch.empty((b, plan.n1, plan.n2), dtype=torch.int32, device=c.device)
        rc = fns[lazy](c.data_ptr(), out.data_ptr(), plan.tw1.data_ptr(),
                       plan.tw1_shoup.data_ptr(), plan.wm.data_ptr(), tables[(t, s)].data_ptr(),
                       b, plan.lg1, plan.n2, *NTF._launch_shape(plan.lg1, plan.n2, b),
                       t.bit_length() - 1, torch.cuda.current_stream(c.device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"the one-table LDE pass 1 failed: {rc}")
        return out

    return call


def lde_turns(rng, dev, shapes=LDE_SHAPES) -> dict:
    """The LDE's pad, scale and pass 1 at ``shapes``, strict and lazy: K14
    then K1 (the design before), K1 of an LDE in use (s^e from two short
    tables) and with one (T, 2) table (lde_one_table), each held against
    the plain version, then in turn and back; with the bound of the bytes
    the function moves (the coefficients read, the scale tables, wm, the
    output written); us per call."""
    from stark_tpu_torch.ops import ntt as NTT
    from stark_tpu_torch.ops import ntt_fused as NTF
    from stark_tpu_torch.ops.fieldops import GENERATOR

    one = lde_one_table()
    s = GENERATOR
    out = {}
    for b, t, n in shapes:
        plan = NTF.get_plan(n, False, dev)
        c = torch.from_numpy(rng.integers(0, 998244353, size=(b, t))).to(torch.int32).to(dev)
        args = sets(4 * b * (t + n), c)
        for lazy in (False, True):
            want = NTF.pass1_lde_plain(c, plan, s, lazy)
            calls = {"K14 + K1": lambda x: NTF.ntt_pass1(
                         NTT.pad_scale(x, n, s).reshape(b, plan.n1, plan.n2), plan, lazy),
                     "in use": lambda x: NTF.ntt_pass1_lde(x, plan, s, lazy),
                     "one table": lambda x: one(x, plan, s, lazy)}
            for key, fn in calls.items():
                if not torch.equal(fn(c), want):
                    raise AssertionError(f"lde pass 1 {key} ({b}, {t}, {n}) != plain")
            times = {}
            for key in list(calls) + list(reversed(calls)):
                times.setdefault(key, []).append(round(device_us(cycled(calls[key], args), 20), 3))
            split = 4 * b * t + 8 * (plan.n1 + plan.n2) + 4 * n + 4 * b * n
            times["bound_us"] = round(split / 3.35e12 * 1e6, 3)
            times["bound_one_table_us"] = round((split + 8 * t - 8 * (plan.n1 + plan.n2))
                                                / 3.35e12 * 1e6, 3)
            key = f"B={b} T=2^{t.bit_length() - 1} N=2^{n.bit_length() - 1}" + (
                " lazy" if lazy else "")
            out[key] = times
            print(f"  lde turns {key}: " + json.dumps(times), flush=True)
    return out


def lde_phase_turns(dev, reps: int = 10) -> dict:
    """The lde phase of a Fibonacci T=2^20 prove (StarkProver._lde_trace on
    its device witness: the iNTT, then the LDE) with the LDE through K14,
    then K1-K3 (the design before: ops.ntt.lde swapped for it), and
    through K1 of an LDE, K3 and K2 (in use), in turn and back; device us
    per phase (CUDA-graph replay)."""
    from stark_tpu_torch import StarkConfig, StarkProver
    from stark_tpu_torch.models import get_model
    from stark_tpu_torch.models.fibonacci import fibonacci_trace_cols_device
    from stark_tpu_torch.ops import ntt as NTT

    t = 1 << 20
    prover = StarkProver(get_model("fib")[0], StarkConfig(trace_length=t, blowup=4), dev)
    cols = fibonacci_trace_cols_device(t)[None]
    in_use = NTT.lde

    def before(coeffs, blowup, offset, lazy=False):
        n = coeffs.shape[-1] * blowup
        return NTT.ntt(NTT._pad_scaled(coeffs, n, offset), lazy)

    want = prover._lde_trace(cols)
    times = {}
    try:
        for key, fn in (("K14 + K1", before), ("in use", in_use), ("in use", in_use),
                        ("K14 + K1", before)):
            NTT.lde = fn
            if not torch.equal(prover._lde_trace(cols), want):
                raise AssertionError(f"lde phase {key} differs")
            times.setdefault(key, []).append(round(device_us(
                lambda: prover._lde_trace(cols), reps), 2))
    finally:
        NTT.lde = in_use
    print("  lde phase turns (Fibonacci T=2^20): " + json.dumps(times), flush=True)
    return times


def tail_in_prove(dev, proves: int = 3) -> list:
    """K8's launches inside profiled Fibonacci T=2^20 proves from device
    witnesses (after three unprofiled ones): per prove, each launch's
    log2 width and device us, in launch order.  Run by path with another
    checkout first on ``PYTHONPATH`` (as tools/prove_wall.py), it measures
    that checkout's K8."""
    from stark_tpu_torch import StarkConfig, StarkProver
    from stark_tpu_torch.models import get_model
    from stark_tpu_torch.models.fibonacci import fibonacci_trace_cols_device
    from stark_tpu_torch.ops import hash_batch as HB

    prover = StarkProver(get_model("fib")[0], StarkConfig(
        trace_length=1 << 20, blowup=4, num_colinearity_tests=16), dev)
    for _ in range(3):
        prover.prove(trace_cols=fibonacci_trace_cols_device(1 << 20))
    widths, launch = [], HB.MERKLE_TAIL.launch

    def recording(device, nodes, out, width, *rest):
        widths.append(width)
        launch(device, nodes, out, width, *rest)

    HB.MERKLE_TAIL.launch = recording  # shadows the method meanwhile
    table = []
    try:
        for _ in range(proves):
            widths.clear()
            torch.cuda.synchronize()
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                prover.prove(trace_cols=fibonacci_trace_cols_device(1 << 20))
                torch.cuda.synchronize()
            events = sorted((e for e in prof.events() if "merkle_tail" in e.name
                             and e.device_type == torch.autograd.DeviceType.CUDA),
                            key=lambda e: e.time_range.start)
            if len(events) != len(widths):
                raise AssertionError(f"{len(events)} K8 events for {len(widths)} launches")
            table.append([(w.bit_length() - 1, round(e.time_range.end - e.time_range.start, 2))
                          for w, e in zip(widths, events)])
    finally:
        del HB.MERKLE_TAIL.launch
    return table


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


FOLD_STAGES = "constexpr int kFoldStages = 3;"
FOLD_BOUNDS = "__launch_bounds__(kFoldThreads, 3)"
FOLD_CHAIN = "const uint32_t al = stark::sponge_step("
FOLD_FIRST = """    stark::sponge_load(sponge, state + 2 * r, pending + 2 * r, q, fresh, roots + 32 * r,
                       32, roots_vec);
  __syncthreads();"""


def fold_variant(stages: int, min_blocks: int, chain: bool = True, first: bool = True):
    """K4-dyn built from csrc/fold.cu with ``stages`` steps a thread in
    flight and ``__launch_bounds__(256, min_blocks)`` in place of the
    port's (into a temporary directory; the port's library is not
    touched): a call with ops.fold.fold_dyn's arguments, and what ptxas
    reports for the kernel.  Without ``chain``, the challenge is not drawn
    (alpha = 1, nothing written but the folded rows): what the rest of
    the kernel costs.  Without ``first``, the challenge's loads go out
    with the block's, not before them (no barrier between)."""
    from stark_tpu_torch.ops import fold as FOLD

    with open(os.path.join(cuda.CSRC, "fold.cu")) as f:
        source = f.read()
    for old, new in ((FOLD_STAGES, f"constexpr int kFoldStages = {stages};"),
                     (FOLD_BOUNDS, f"__launch_bounds__(kFoldThreads, {min_blocks})")):
        if source.count(old) != 1:
            raise RuntimeError(f"csrc/fold.cu has moved on: {old!r}")
        source = source.replace(old, new)
    if not chain:
        source = source.replace(FOLD_CHAIN, "const uint32_t al = 1u; (void)(")
    if not first:
        if source.count(FOLD_FIRST) != 1:
            raise RuntimeError("csrc/fold.cu has moved on: the challenge's loads")
        source = source.replace(FOLD_FIRST, FOLD_FIRST.replace("__syncthreads();", ""))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "fold_variant.cu")
        with open(path, "w") as f:
            f.write(source)
        regs = subprocess.run([cuda._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                               "-std=c++17", "-O3", "-Xptxas", "-v", "-cubin", "-o",
                               os.devnull, "-I", cuda.CSRC, path],
                              capture_output=True, text=True, check=True).stderr
    found = re.search(r"stark_fri_fold_dyn_kernel.*?Used (\d+) registers", regs, re.S)
    fn = getattr(build_temporary(source, "fold_variant"), FOLD.FOLD_DYN.symbol)
    fn.argtypes = [*FOLD.FOLD_DYN.argtypes, ctypes.c_void_p]

    def call(codewords, inv_x_mont, sponge, roots, copy, alpha):
        rows, half = codewords.shape[0], codewords.shape[1] // 2
        dev = codewords.device
        out = torch.empty((rows, half), dtype=torch.int32, device=dev)
        if fn(codewords.data_ptr(), inv_x_mont.data_ptr(), sponge.state.data_ptr(),
              sponge.pending.data_ptr(), sponge.next_state.data_ptr(),
              sponge.next_pending.data_ptr(), sponge.q, int(sponge.fresh), roots.data_ptr(),
              copy.data_ptr(), alpha.data_ptr(), out.data_ptr(), half, rows,
              cuda.sm_count(dev), FOLD.INV2, FOLD.INV2_SHOUP,
              torch.cuda.current_stream(dev).cuda_stream) != 0:
            raise RuntimeError("fold_variant failed")
        if chain:
            sponge.swap(32)
        return out

    return call, f"{found.group(1) if found else '?'} regs"


#: (steps in flight, least blocks an SM, challenge drawn, its loads first)
#: of the K4-dyn variants timed.
FOLD_VARIANTS = ((2, 3, True, True), (3, 2, True, True), (3, 3, True, False),
                 (3, 3, False, True))
FOLD_VARIANT_SHAPES = ((1, 1 << 21), (1, 1 << 18), (32, 1 << 15), (8, 1 << 15), (1, 1 << 10))


def fold_turns(rng, dev) -> dict:
    """K4-dyn at every (B, half) of the device chain's rounds (B = 1:
    half 2^21 .. 2^7, the Fibonacci T=2^20 prove's; B in {8, 32}: 2^15 ..
    2^7, the batched cells'), a root after a 16-byte tail: the pair before
    its redesign (fold_dyn_before: K9, then the fold) and the launch in
    use, each first held against the plain version, then in turn and back
    (before, in use, in use, before); us per call.  A replay runs the calls
    back to back, so a pair's step from its first launch to its second is
    in its time.  At FOLD_VARIANT_SHAPES, each of FOLD_VARIANTS (fold_variant)
    too, after the in-use turns."""
    from stark_tpu_torch.ops import fold as FOLD
    from stark_tpu_torch.ops import hash_batch as HB

    before = fold_dyn_before()
    variants = {f"{st} stages, {m} blocks" + ("" if c else ", no challenge")
                + ("" if f else ", its loads with the block's"): fold_variant(st, m, c, f)
                for st, m, c, f in FOLD_VARIANTS}
    table = {"variants": {k: v[1] for k, v in variants.items()}}
    shapes = [(1, 1 << lg) for lg in range(21, 6, -1)] + [
        (b, 1 << lg) for b in (8, 32) for lg in range(15, 6, -1)]
    for b, half in shapes:
        sp = HB.Sponge(b, dev)
        sp.absorb(torch.from_numpy(rng.integers(0, 256, (b, 80), dtype=np.uint8)).to(dev))
        roots = torch.from_numpy(rng.integers(0, 256, (b, 32), dtype=np.uint8)).to(dev)
        copy = torch.empty((b, 32), dtype=torch.uint8, device=dev)
        alpha = torch.empty(b, dtype=torch.int32, device=dev)
        args = sets(16 * b * half, *(
            torch.from_numpy(rng.integers(0, 998244353, size=shape)).to(torch.int32).to(dev)
            for shape in ((b, 2 * half), (half,))))
        cw, inv_x = args[0]
        calls = {"before": lambda c, x: before(c, x, sp, roots, copy, alpha),
                 "in use": lambda c, x: FOLD.fold_dyn(c, x, sp, roots, copy, alpha)}
        if (b, half) in FOLD_VARIANT_SHAPES:
            calls.update({key: (lambda c, x, fn=fn: fn(c, x, sp, roots, copy, alpha))
                          for key, (fn, _) in variants.items()})
        for key, fn in calls.items():
            want = FOLD.fold_dyn_round_plain(cw, inv_x, sp.state, sp.pending, sp.q, roots)
            got = fn(cw, inv_x)
            if "no challenge" in key:
                ok = torch.equal(got, FOLD.fold_dyn_plain(cw, inv_x, torch.ones_like(alpha)))
            else:
                ok = (torch.equal(got, want[3]) and torch.equal(alpha.long(), want[2])
                      and torch.equal(sp.state, want[0]))
            if not ok:
                raise AssertionError(f"fold_dyn {key} at ({b}, {half}) != plain")
        times = {}
        for key in ("before", "in use", "in use", "before", *list(calls)[2:]):
            times.setdefault(key, []).append(round(device_us(cycled(calls[key], args), 20), 2))
        table[f"({b}, 2^{half.bit_length() - 1})"] = times
    return table


def floor_kernel():
    """``floor_launch(blocks, threads, smem, stream)``: an empty kernel's
    launch (FLOOR_SOURCE, built here), returning its CUDA error code."""
    fn = build_temporary(FLOOR_SOURCE, "floor").floor_launch
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    return fn


def tune_floor(dev) -> None:
    fn = floor_kernel()
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
    parser.add_argument("--only", choices=("latency", "forest", "tail-in-prove", "compose",
                                           "lde", "fold", "sponge", "chain", "witness",
                                           "floor", "parts", "ntt"),
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
    if args.only in (None, "latency"):
        print("hash latency, us per hash of a chain in one warp, by lanes a hash, part and "
              "hashes side by side: " + json.dumps(hash_latency(dev)), flush=True)
    if args.only in (None, "forest"):
        print("forest turns, us per call, each in turn and back (CUDA-graph replay): "
              + json.dumps(forest_turns(rng, dev)), flush=True)
    if args.only in (None, "tail-in-prove"):
        import stark_tpu_torch

        print(f"tail in prove ({stark_tpu_torch.__file__}), per profiled Fibonacci T=2^20 "
              "prove, each K8 launch's [log2 width, device us]: "
              + json.dumps(tail_in_prove(dev)), flush=True)
    if args.only in (None, "compose"):
        print("compose turns, us per call, each in turn and back (CUDA-graph replay): "
              + json.dumps(compose_turns(rng, dev)), flush=True)
        print("compose builds, nvcc s of the distinct-form AIR by (transitions, form): "
              + json.dumps(compose_builds()), flush=True)
    if args.only in (None, "lde"):
        print("lde turns, pass 1 of the LDE: K14 + K1 before, in use, one table, us per call "
              "in turn and back (CUDA-graph replay): " + json.dumps(lde_turns(rng, dev)),
              flush=True)
        print("lde phase turns, us per phase: " + json.dumps(lde_phase_turns(dev)), flush=True)
    if args.only in (None, "fold"):
        print("fold turns, K4-dyn against the K9 + fold pair before it, us per call, "
              "each in turn and back (CUDA-graph replay): "
              + json.dumps(fold_turns(rng, dev)), flush=True)
    if args.only in (None, "sponge"):
        print("sponge split, us per call, each in turn and back (CUDA-graph replay): "
              + json.dumps(sponge_split(rng, dev)), flush=True)
    if args.only in (None, "chain"):
        print("chain split, K15 (constraint challenges), us per call, each in turn and back "
              "(CUDA-graph replay): " + json.dumps(chain_split(rng, dev)), flush=True)
        print("chain turns, K15 by (B, challenges): the design before, the window in use, "
              "us per call in turn and back (CUDA-graph replay): "
              + json.dumps(chain_turns(rng, dev)), flush=True)
    if args.only in (None, "witness"):
        print("witness turns, K12 fib_expand: the seeds design before and the basis entry "
              "in use, us per call in turn and back (CUDA-graph replay): "
              + json.dumps(witness_turns(rng, dev)), flush=True)
    if args.only in (None, "floor"):
        tune_floor(dev)
    if args.only in (None, "parts"):
        tune_parts(rng, dev)
    if args.only in (None, "ntt"):
        tune_ntt(rng, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
