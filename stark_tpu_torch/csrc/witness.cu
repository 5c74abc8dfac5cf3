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
// `block` dependent steps of 64 constant products, 8 squares and 72 adds
// per block: T = 2^16 at block 64 is only 1,024 blocks, so a thread per
// block (state in registers, M and its Shoup companions in shared memory)
// leaves most of the card idle and the time is one thread's latency chain;
// splitting the 8 rows of M s across lanes is the next step, not taken.
#include <cuda_runtime.h>
#include <stdint.h>

#include "field.cuh"

using stark::add_mod;
using stark::kP;
using stark::mont_mul;
using stark::shoup_mul;

namespace {

// 2^64 mod p: mont_mul(x, kR2) = x 2^32 mod p, so mont_mul(mont_mul(a, b),
// kR2) = a b mod p for a, b in [0, p).
constexpr uint64_t kR1 = (1ull << 32) % kP;
constexpr uint32_t kR2 = static_cast<uint32_t>(kR1 * kR1 % kP);

__device__ __forceinline__ uint32_t mul_mod(uint32_t a, uint32_t b) {
  return mont_mul(mont_mul(a, b), kR2);
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
__global__ void stark_mds_expand_kernel(const uint32_t* __restrict__ consts,
                                        const uint32_t* __restrict__ seeds,
                                        uint32_t* __restrict__ out, int nb,
                                        int block, long long length) {
  __shared__ uint32_t m[64], ms[64], rc[8];
  for (int t = threadIdx.x; t < 64; t += blockDim.x) {
    m[t] = consts[t];
    ms[t] = (uint32_t)(((uint64_t)consts[t] << 32) / kP);  // Shoup companion
  }
  for (int t = threadIdx.x; t < 8; t += blockDim.x) rc[t] = consts[64 + t];
  __syncthreads();
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= nb) return;
  uint32_t s[8];
#pragma unroll
  for (int i = 0; i < 8; i++) s[i] = seeds[8 * b + i];
  long long t = (long long)b * block;
  const long long end = t + block < length ? t + block : length;
  for (; t < end; t++) {
#pragma unroll
    for (int i = 0; i < 8; i++) out[i * length + t] = s[i];
    uint32_t nx[8];
#pragma unroll
    for (int i = 0; i < 8; i++) {
      uint32_t acc = shoup_mul(s[0], m[8 * i], ms[8 * i]);
#pragma unroll
      for (int j = 1; j < 8; j++)
        acc = add_mod(acc, shoup_mul(s[j], m[8 * i + j], ms[8 * i + j]));
      nx[i] = add_mod(mul_mod(acc, acc), rc[i]);
    }
#pragma unroll
    for (int i = 0; i < 8; i++) s[i] = nx[i];
  }
}

int stark_mds_expand(const void* consts, const void* seeds, void* out, int nb,
                     int block, long long length, void* stream) {
  const int threads = 32;  // a warp per SM: the chain's latency bounds it, not throughput
  const int blocks = (nb + threads - 1) / threads;
  stark_mds_expand_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      static_cast<const uint32_t*>(consts),
      static_cast<const uint32_t*>(seeds), static_cast<uint32_t*>(out), nb,
      block, length);
  return (int)cudaGetLastError();
}

}  // extern "C"
