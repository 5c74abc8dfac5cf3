// Device witnesses for Hopper: kernel K12, two entries.  Replaces the JAX
// package's jit-fused witness expansions, which let a prove start from
// columns made on the device instead of uploading the trace:
//
//   stark_fib_expand   stark_tpu/models/fibonacci.py:_fib_block_fn (:58)
//     out[k B + j] = s1[k] u1[j] + s0[k] u0[j]  mod p, cut to `length`:
//     the rank-2 block expansion a_{kB+j} = F_{kB+1} F_{j+1} + F_{kB} F_j
//     of the Fibonacci trace from O(sqrt T) seeds the host computes;
//   stark_mds_expand   stark_tpu/models/examples.py:_mds_expand_fn (:173)
//     from (nb, 8) block-start states, `block` steps of s' = (M s)^2 + rc
//     mod p each; row t = b block + k of the (8, length) output is state k
//     of block b (the host walks the seed chain, native.mds_seed_walk).
//
// What bounds them on the card.  fib_expand writes 4 bytes per element and
// computes three Montgomery products: bound by bytes (4 MB at T = 2^20, 1.3
// us at 3.35 TB/s), one thread per element.  mds_expand is a chain of
// `block` dependent steps per block: T = 2^16 at block 64 is only 1,024
// blocks, so what bounds it is the latency of one step times `block`, and
// what the design does is shorten the step and spread the blocks.  An
// 8-lane group runs a block, lane i owning row i of M s: the state is
// broadcast inside the group with __shfl_sync, the row's 8 products are
// summed lazily in 64 bits (each < p^2 < 2^60, the sum < 2^63) and reduced
// once, by a Montgomery reduction with the constant p.  The constants are
// M 2^48 mod p, so that reduction leaves 2^16 (M s)_i, and one Montgomery
// square of that is (M s)_i^2 itself (2^32 = (2^16)^2).  Each group stages
// its states in shared memory and writes every row's run of words
// coalesced, kMdsChunk steps at a time, so any `block` fits.  T = 2^16 at
// block 64 runs 8,192 lanes.
#include <cuda_runtime.h>
#include <stdint.h>

#include "field.cuh"

using stark::add_mod;
using stark::kP;
using stark::kPinvNeg;
using stark::mont_mul;
using stark::reduce_once;

namespace {

// 2^64 mod p: mont_mul(x, kR2) = x 2^32 mod p, so mont_mul(mont_mul(a, b),
// kR2) = a b mod p for a, b in [0, p).  2^80 mod p: mont_mul(m, kR80) =
// m 2^48 mod p.
constexpr uint64_t kR1 = (1ull << 32) % kP;
constexpr uint32_t kR2 = static_cast<uint32_t>(kR1 * kR1 % kP);
constexpr uint32_t kR80 = static_cast<uint32_t>((uint64_t)kR2 * (1u << 16) % kP);

// mds_expand's launch: 8 lanes a block, kMdsBlocks blocks a CTA; states
// staged for kMdsChunk steps between two flushes.
constexpr int kMdsBlocks = 8;
constexpr int kMdsThreads = 8 * kMdsBlocks;
constexpr int kMdsChunk = 64;

// One step of row i (the lane's) of s' = (M s)^2 + rc: s_j from lane j of
// the group, x = sum_j mh_j s_j < 8 (p - 1)^2 < 2^63 in 64 bits, then one
// Montgomery reduction u = x 2^-32 mod p, u < 3p before two corrections:
// u = 2^16 (M s)_i, and mont_mul(u, u) = 2^32 (M s)_i^2 2^-32.
__device__ __forceinline__ uint32_t mds_row_step(uint32_t s, const uint32_t* mh,
                                                 uint32_t rc) {
  uint64_t x = 0;
#pragma unroll
  for (int j = 0; j < 8; j++)
    x += (uint64_t)mh[j] * __shfl_sync(0xffffffffu, s, j, 8);
  const uint32_t lo = (uint32_t)x;
  const uint32_t hi = (uint32_t)(x >> 32);
  uint32_t u = hi + __umulhi(lo * kPinvNeg, kP) + (lo != 0u ? 1u : 0u);
  u = reduce_once(__viaddmin_u32(u, 0u - 2u * kP, u));  // [0, 3p) -> [0, p)
  return add_mod(mont_mul(u, u), rc);
}

}  // namespace

// C linkage, so that a profile names the kernels plainly.
extern "C" {

// seeds: s0 (nb), s1 (nb), u0 (B), u1 (B), one after the other.
__global__ void stark_fib_expand_kernel(const uint32_t* __restrict__ seeds,
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
    // (s1 u1 + s0 u0) 2^-32, then times 2^64 2^-32.
    out[i] = mont_mul(add_mod(mont_mul(s1[k], u1[j]), mont_mul(s0[k], u0[j])),
                      kR2);
  }
}

int stark_fib_expand(const void* seeds, void* out, int nb, int lg_b,
                     long long length, void* stream) {
  const int threads = 256;
  long long blocks = (length + threads - 1) / threads;
  if (blocks > 4096) blocks = 4096;
  stark_fib_expand_kernel<<<(unsigned)blocks, threads, 0,
                            (cudaStream_t)stream>>>(
      static_cast<const uint32_t*>(seeds), static_cast<uint32_t*>(out), nb,
      lg_b, length);
  return (int)cudaGetLastError();
}

// consts: M (8 x 8, row-major), rc (8); seeds: (nb, 8); out: (8, length).
// A CTA of kMdsThreads lanes runs kMdsBlocks blocks, a group of 8 lanes each;
// every lane takes every step, so the group's shuffles always find all 32
// lanes of the warp (a block past nb runs on zeros and stores nothing).
__global__ void __launch_bounds__(kMdsThreads)
stark_mds_expand_kernel(const uint32_t* __restrict__ consts,
                        const uint32_t* __restrict__ seeds,
                        uint32_t* __restrict__ out, int nb, int block,
                        long long length) {
  __shared__ uint32_t stage[kMdsBlocks][8][kMdsChunk + 1];  // +1: no bank conflicts
  const int row = threadIdx.x & 7;
  const int g = threadIdx.x >> 3;
  const long long b = (long long)blockIdx.x * kMdsBlocks + g;
  const bool live = b < nb;
  uint32_t mh[8];
#pragma unroll
  for (int j = 0; j < 8; j++) mh[j] = mont_mul(consts[8 * row + j], kR80);  // m 2^48
  const uint32_t rc = consts[64 + row];
  uint32_t s = live ? seeds[8 * b + row] : 0u;
  const long long first = b * block;
  for (int t0 = 0; t0 < block; t0 += kMdsChunk) {
    const int n = block - t0 < kMdsChunk ? block - t0 : kMdsChunk;
    for (int k = 0; k < n; k++) {
      stage[g][row][k] = s;
      s = mds_row_step(s, mh, rc);
    }
    __syncwarp();
    if (live) {
#pragma unroll
      for (int r = 0; r < 8; r++) {
        uint32_t* dst = out + r * length + first + t0;
        for (int k = row; k < n && first + t0 + k < length; k += 8) dst[k] = stage[g][r][k];
      }
    }
    __syncwarp();
  }
}

int stark_mds_expand(const void* consts, const void* seeds, void* out, int nb,
                     int block, long long length, void* stream) {
  const int blocks = (nb + kMdsBlocks - 1) / kMdsBlocks;
  stark_mds_expand_kernel<<<blocks, kMdsThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const uint32_t*>(consts),
      static_cast<const uint32_t*>(seeds), static_cast<uint32_t*>(out), nb,
      block, length);
  return (int)cudaGetLastError();
}

}  // extern "C"
