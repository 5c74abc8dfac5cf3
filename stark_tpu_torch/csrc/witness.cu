// Device witnesses for Hopper: kernel K12, two entries.  Replaces the JAX
// package's jit-fused witness expansions, which let a prove start from
// columns made on the device instead of uploading the trace:
//
//   stark_fib_expand_basis   stark_tpu/models/fibonacci.py:_fib_block_fn (:58)
//     out[k B + j] = s1[k] u1[j] + s0[k] u0[j]  mod p, cut to `length`,
//     the run a_0 = a, a_1 = b of the Fibonacci recurrence: the rank-2
//     block expansion a_{kB+j} = a_{kB} F_{j+1} + a_{kB-1} F_j, whose block
//     seeds s1[k] = a_{kB} = a F_{kB-1} + b F_{kB} and s0[k] = a_{kB-1} =
//     a F_{kB-2} + b F_{kB-1} each thread forms from the length's basis
//     (F_{kB-2}, F_{kB-1}, F_{kB}) and the start pair (a, b), a launch
//     argument: one launch a witness, the basis made once a length (the
//     design before, whose seeds the host made and uploaded for every run,
//     is tools/tune_kernels.fib_expand_seeds);
//   stark_mds_expand   stark_tpu/models/examples.py:_mds_expand_fn (:173)
//     from (nb, 8) block-start states, `block` steps of s' = (M s)^2 + rc
//     mod p each; row t = b block + k of the (8, length) output is state k
//     of block b (the host walks the seed chain, native.mds_seed_walk).
//
// What bounds them on the card.  fib_expand writes 4 bytes per element: it
// is bound by bytes (4 MB at T = 2^20, 1.3 us at 3.35 TB/s), on top of the
// ~1.2-1.7 us any launch takes.  So the grid is one wave, a CTA per SM,
// and a thread owns 8 consecutive columns j of the block and walks rows k
// four at a time: it issues its loads (its 16 u values, the words of four
// rows) before it computes, puts the u values and the start pair into
// Montgomery form once (u 2^32 mod p), so that a row's seeds are four
// Montgomery products and an element two and one addition mod p, with no
// product to undo 2^-32, and writes each row's 8 elements as two 16-byte
// stores.  The basis adds a word a row to the seeds: 24 KB against 8 MB
// of output at T = 2^21.  (The grid of 4,096 x 256 threads, an element
// each, ran its blocks in waves, each wave a trip to memory: 5.0 us at T
// = 2^20; a load at the top of each row's step made a chain of trips too:
// 5.2 us, PERF.md.)  Blocks narrower than 8 columns (T < 64) take one
// element at a time.  mds_expand is a chain of
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

// 2^64 mod p: mont_mul(x, kR2) = x 2^32 mod p, the Montgomery form of x,
// and mont_mul(a, that) = a x mod p.  2^80 mod p: mont_mul(m, kR80) =
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

// Row k's seeds of the run from (a, b): s0 = a_{kB-1} = a F_{kB-2} + b
// F_{kB-1} and s1 = a_{kB} = a F_{kB-1} + b F_{kB}, from its basis words
// w0, w1, w2 and am, bm = (a, b) in Montgomery form.
__device__ __forceinline__ void fib_seeds(uint32_t am, uint32_t bm, uint32_t w0,
                                          uint32_t w1, uint32_t w2, uint32_t& s0,
                                          uint32_t& s1) {
  s0 = add_mod(mont_mul(am, w0), mont_mul(bm, w1));
  s1 = add_mod(mont_mul(am, w1), mont_mul(bm, w2));
}

}  // namespace

// C linkage, so that a profile names the kernels plainly.
extern "C" {

// fib_expand: one CTA of kFibThreads per SM; a thread owns kFibCols
// columns and takes its rows kFibRows at a time.
constexpr int kFibThreads = 256;
constexpr int kFibCols = 8;
constexpr int kFibRows = 4;

// basis: F_{kB-2} (nb), F_{kB-1} (nb), F_{kB} (nb), u0 (B), u1 (B), one
// after the other; B = 2^lg_b; (a, b) the start pair, reduced.  The grid's
// thread count is a multiple of B / kFibCols (stark_fib_expand_basis).
__global__ void __launch_bounds__(kFibThreads)
    stark_fib_expand_basis_kernel(const uint32_t* __restrict__ basis,
                                  uint32_t* __restrict__ out, int nb, int lg_b,
                                  long long length, uint32_t a, uint32_t b) {
  const uint32_t* fm2 = basis;
  const uint32_t* fm1 = basis + nb;
  const uint32_t* f0 = basis + 2 * nb;
  const uint32_t* u0 = basis + 3 * nb;
  const uint32_t* u1 = u0 + (1 << lg_b);
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long threads = (long long)gridDim.x * blockDim.x;
  // a 2^32 mod p, b 2^32 mod p: mont_mul(am, f) = a f mod p.
  const uint32_t am = mont_mul(a, kR2);
  const uint32_t bm = mont_mul(b, kR2);
  if (lg_b < 3) {  // blocks of 1, 2 or 4 columns: an element a step
    for (long long i = tid; i < length; i += threads) {
      const long long k = i >> lg_b;
      const int j = (int)(i & ((1 << lg_b) - 1));
      uint32_t s0, s1;
      fib_seeds(am, bm, fm2[k], fm1[k], f0[k], s0, s1);
      out[i] = add_mod(mont_mul(s1, mont_mul(u1[j], kR2)),
                       mont_mul(s0, mont_mul(u0[j], kR2)));
    }
    return;
  }
  const int lg_groups = lg_b - 3;  // column groups of kFibCols
  const int j0 = (int)(tid & ((1 << lg_groups) - 1)) * kFibCols;
  const long long lanes = threads >> lg_groups;
  // Every load a thread makes is issued before it computes: its u values
  // and the basis words of its first kFibRows rows (one trip to memory,
  // where a load at the top of each row's step would make a chain of them).
  uint32_t m0[kFibCols], m1[kFibCols];
#pragma unroll
  for (int c = 0; c < kFibCols; ++c) {
    m0[c] = u0[j0 + c];
    m1[c] = u1[j0 + c];
  }
  long long k0 = tid >> lg_groups;
  uint32_t w0[kFibRows], w1[kFibRows], w2[kFibRows];
#pragma unroll
  for (int r = 0; r < kFibRows; ++r) {
    const long long k = k0 + r * lanes;
    w0[r] = k < nb ? fm2[k] : 0u;
    w1[r] = k < nb ? fm1[k] : 0u;
    w2[r] = k < nb ? f0[k] : 0u;
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
      uint32_t s0, s1, v[kFibCols];
      fib_seeds(am, bm, w0[r], w1[r], w2[r], s0, s1);
#pragma unroll
      for (int c = 0; c < kFibCols; ++c)
        v[c] = add_mod(mont_mul(s1, m1[c]), mont_mul(s0, m0[c]));
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
    for (int r = 0; r < kFibRows; ++r) {  // the next rows' words
      const long long k = k0 + (kFibRows + r) * lanes;
      w0[r] = k < nb ? fm2[k] : 0u;
      w1[r] = k < nb ? fm1[k] : 0u;
      w2[r] = k < nb ? f0[k] : 0u;
    }
  }
}

// out must be 16-byte aligned.  sms: the card's SM count (the grid).
int stark_fib_expand_basis(const void* basis, void* out, int nb, int lg_b,
                           long long length, unsigned a, unsigned b, int sms,
                           void* stream) {
  long long blocks = sms;
  if (lg_b >= 3) {
    // a whole number of rows of column groups: threads % (B / 8) == 0
    const long long groups = 1LL << (lg_b - 3);
    const long long per_block = groups > kFibThreads ? groups / kFibThreads : 1;
    blocks = (blocks + per_block - 1) / per_block * per_block;
  }
  stark_fib_expand_basis_kernel<<<(unsigned)blocks, kFibThreads, 0,
                                  (cudaStream_t)stream>>>(
      static_cast<const uint32_t*>(basis), static_cast<uint32_t*>(out), nb, lg_b,
      length, a, b);
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
