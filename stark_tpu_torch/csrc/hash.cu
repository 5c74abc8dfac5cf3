// Commitment hash and Merkle trees for Hopper: kernels K5/K6 (leaf and row
// digests), K7 (one tree level) and K8 (a whole subtree per block).
//
// They replace functions of the JAX package that are XLA-fused jnp on the
// TPU (Mosaic could not lower u8 vectors, stark_tpu/ops/pallas_kernels.py
// :3-5), all in stark_tpu/ops/hash_batch.py:
//   stark_hash_rows     leaf_hash_rows_core (:279, K5, the c = 1 case) and
//                       row_hash_rows_core (:290, K6);
//   stark_merkle_level  combine_rows_core / level_rows_core (:313-345, K7);
//   stark_merkle_tail   _tail_levels_core / _tail_loop (:433-538, K8) with
//                       the level stack that stack_path_gather (:566) reads.
//
// Digests are node-major: node j is the 32 bytes at 32 * j, so a thread
// reads a digest as two 16-byte words and a parent's input left || right is
// the 64 contiguous bytes at 64 * j.
//
// What bounds them on the card: integer instructions, not memory.  A hash
// of L bytes costs L absorb steps and ceil(L / 32) + 8 mix rounds, a few
// hundred integer instructions per mix, against 32 bytes written and at
// most 64 read.  The design therefore keeps one lane per thread with the
// whole state in registers (hash.cuh), so the only memory traffic is the
// input once and the digest once, and fills the card with lanes; K8 exists
// for the narrow top of a tree, where a level per launch would cost more in
// launches than in hashing: a block keeps its 2^10 nodes in shared memory
// and walks up ten levels, half of its threads dropping out per level.
// The TPU's fixed-width fori_loop, segment compaction and semirev layout
// are Mosaic/XLA devices with no counterpart here.  Packing four state
// bytes into one register (SWAR) is the next redesign, not done here.
#include <cuda_runtime.h>
#include <stdint.h>

#include "hash.cuh"

namespace {

using stark::absorb_value;
using stark::hash_combine;
using stark::hash_finish;
using stark::hash_init;
using stark::mix;
using stark::pack_digest;

constexpr int kLaneThreads = 256;
// K8: a block owns 2^kTailLg nodes (32 KB of shared memory).
constexpr int kTailLg = 10;
constexpr int kTailThreads = 1 << (kTailLg - 1);

}  // namespace

// C linkage, so that a profile names the kernels plainly.
extern "C" {

// values: (c, n) field values, row-major; out: n digests.  Lane i hashes
// the 8c bytes of column i (each value a little-endian u64) in 32-byte
// chunks of four values, a mix after each chunk; a last chunk of fewer
// values absorbs only its own bytes (it is not zero-padded).
__global__ void __launch_bounds__(kLaneThreads)
    stark_hash_rows_kernel(const uint32_t* __restrict__ values,
                           uint4* __restrict__ out, int c, long long n) {
  const long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  uint32_t s[32];
  hash_init(s);
  for (int r0 = 0; r0 < c; r0 += 4) {
    const uint32_t* col = values + (long long)r0 * n + lane;
    absorb_value<0>(s, col[0]);
    if (r0 + 1 < c) absorb_value<8>(s, col[n]);
    if (r0 + 2 < c) absorb_value<16>(s, col[2 * n]);
    if (r0 + 3 < c) absorb_value<24>(s, col[3 * n]);
    mix(s);
  }
  hash_finish(s);
  uint4 lo, hi;
  pack_digest(s, lo, hi);
  out[2 * lane] = lo;
  out[2 * lane + 1] = hi;
}

// nodes: 2 * parents digests; out: parents digests,
// out[j] = hash(nodes[2j] || nodes[2j + 1]).
__global__ void __launch_bounds__(kLaneThreads)
    stark_merkle_level_kernel(const uint4* __restrict__ nodes,
                              uint4* __restrict__ out, long long parents) {
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= parents) return;
  uint32_t s[32];
  hash_combine(s, nodes[4 * j], nodes[4 * j + 1], nodes[4 * j + 2],
               nodes[4 * j + 3]);
  uint4 lo, hi;
  pack_digest(s, lo, hi);
  out[2 * j] = lo;
  out[2 * j + 1] = hi;
}

// nodes: `width` digests, a multiple of sub = 2^lg_sub (lg_sub <= kTailLg);
// out: the lg_sub levels above them, one after the other (width / 2 nodes,
// then width / 4, ...).  Block b owns nodes [b * sub, (b + 1) * sub) and
// writes its share of each of those levels.
__global__ void __launch_bounds__(kTailThreads)
    stark_merkle_tail_kernel(const uint4* __restrict__ nodes,
                             uint4* __restrict__ out, long long width,
                             int lg_sub) {
  __shared__ uint4 tile[2 << kTailLg];
  const int sub = 1 << lg_sub;
  const int t = threadIdx.x;
  const uint4* mine = nodes + 2 * (long long)blockIdx.x * sub;
  for (int e = t; e < 2 * sub; e += blockDim.x) tile[e] = mine[e];
  __syncthreads();

  long long level_start = 0;  // of the level being written, in nodes of out
  long long level_width = width >> 1;
  for (int l = 1; l <= lg_sub; ++l) {
    const int count = sub >> l;  // this block's nodes on level l
    const bool active = t < count;
    uint4 lo, hi;
    if (active) {
      uint32_t s[32];
      hash_combine(s, tile[4 * t], tile[4 * t + 1], tile[4 * t + 2],
                   tile[4 * t + 3]);
      pack_digest(s, lo, hi);
    }
    __syncthreads();  // every read of the level below is done
    if (active) {
      tile[2 * t] = lo;
      tile[2 * t + 1] = hi;
      const long long node = level_start + (long long)blockIdx.x * count + t;
      out[2 * node] = lo;
      out[2 * node + 1] = hi;
    }
    __syncthreads();
    level_start += level_width;
    level_width >>= 1;
  }
}

// K5/K6: (c, n) field values -> n digests.
int stark_hash_rows(const void* values, void* out, int c, long long n,
                    void* stream) {
  const long long blocks = (n + kLaneThreads - 1) / kLaneThreads;
  stark_hash_rows_kernel<<<(unsigned)blocks, kLaneThreads, 0,
                           (cudaStream_t)stream>>>(
      static_cast<const uint32_t*>(values), static_cast<uint4*>(out), c, n);
  return (int)cudaGetLastError();
}

// K7: 2 * parents node digests -> parents digests.
int stark_merkle_level(const void* nodes, void* out, long long parents,
                       void* stream) {
  const long long blocks = (parents + kLaneThreads - 1) / kLaneThreads;
  stark_merkle_level_kernel<<<(unsigned)blocks, kLaneThreads, 0,
                              (cudaStream_t)stream>>>(
      static_cast<const uint4*>(nodes), static_cast<uint4*>(out), parents);
  return (int)cudaGetLastError();
}

// K8: `width` node digests -> the lg_sub levels above them, where
// 1 <= lg_sub <= 10 and 2^lg_sub divides width.
int stark_merkle_tail(const void* nodes, void* out, long long width,
                      int lg_sub, void* stream) {
  if (lg_sub < 1 || lg_sub > kTailLg || (width & ((1LL << lg_sub) - 1)))
    return (int)cudaErrorInvalidValue;
  int threads = 1 << (lg_sub - 1);
  if (threads < 32) threads = 32;
  stark_merkle_tail_kernel<<<(unsigned)(width >> lg_sub), threads, 0,
                             (cudaStream_t)stream>>>(
      static_cast<const uint4*>(nodes), static_cast<uint4*>(out), width,
      lg_sub);
  return (int)cudaGetLastError();
}

}  // extern "C"
