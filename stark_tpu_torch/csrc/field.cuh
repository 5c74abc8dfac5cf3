// u32 arithmetic over F_p, p = 998244353 = 119 * 2^23 + 1, for the port's
// CUDA kernels.  Field vectors live in int32 tensors holding values in
// [0, p) (p < 2^30); the kernels read that storage as uint32.
//
// The JAX package builds the 32x32 -> high-32 product from 16-bit limbs
// (stark_tpu/ops/fieldops.py:mulhi32), a TPU workaround; Hopper has it in
// one instruction, __umulhi.
#pragma once

#include <stdint.h>

#ifndef __CUDACC__
// A host C++ compiler: the CPU tests build the composition kernel's
// generated per-point body (ops/compose.py, compose.cuh) with it.  The
// qualifiers go, and the two intrinsics get their meaning in plain C++.
#define __device__
#define __forceinline__ inline
static inline uint32_t __umulhi(uint32_t a, uint32_t b) {
  return (uint32_t)(((uint64_t)a * b) >> 32);
}
static inline uint32_t __viaddmin_u32(uint32_t a, uint32_t b, uint32_t c) {
  const uint32_t s = a + b;
  return s < c ? s : c;
}
#endif

namespace stark {

constexpr uint32_t kP = 998244353u;
// -p^{-1} mod 2^32: p * kPinvNeg == -1 (mod 2^32).
constexpr uint32_t kPinvNeg = 998244351u;
static_assert(static_cast<uint32_t>(kP * kPinvNeg) == 0xFFFFFFFFu,
              "kPinvNeg must be -p^-1 mod 2^32");

// [0, 2p) -> [0, p), as min(a, a - p): a - p wraps around to above a when
// a < p.  One instruction on Hopper, the DPX add-and-minimum (VIADDMNMX),
// where a compare and a select were two on the same integer pipe.
__device__ __forceinline__ uint32_t reduce_once(uint32_t a) {
  return __viaddmin_u32(a, 0u - kP, a);
}

__device__ __forceinline__ uint32_t add_mod(uint32_t a, uint32_t b) {
  return reduce_once(a + b);  // a + b < 2p < 2^31: no wrap
}

__device__ __forceinline__ uint32_t sub_mod(uint32_t a, uint32_t b) {
  const uint32_t d = a - b;  // wraps around to above d + p when a < b
  return __viaddmin_u32(d, kP, d);
}

// a, b in [0, p) -> a - b + p, in (0, 2p): the difference mod p, left
// unreduced for shoup_mul, which takes any operand.
__device__ __forceinline__ uint32_t sub_open(uint32_t a, uint32_t b) {
  return a - b + kP;
}

// (a * w) mod p for a constant w < p with companion ws = floor(w 2^32 / p).
// Valid for any a < 2^32: r = a w - floor(a ws / 2^32) p lies in [0, 2p).
__device__ __forceinline__ uint32_t shoup_mul(uint32_t a, uint32_t w,
                                              uint32_t ws) {
  const uint32_t q = __umulhi(a, ws);
  return reduce_once(a * w - q * kP);
}

// Harvey's lazy butterflies keep values in [0, 2p) between NTT stages
// (the JAX package's _addmod_lazy / _sub_lazy / _shoup_lazy,
// stark_tpu/ops/ntt_fused.py:222-236): the subtract drops its select and
// the Shoup multiply its final correction.  4p < 2^32, so nothing wraps.
constexpr uint32_t kTwoP = 2u * kP;
static_assert(2ull * kTwoP < (1ull << 32), "4p must fit in 32 bits");

// a, b in [0, 2p) -> a + b mod p, in [0, 2p).
__device__ __forceinline__ uint32_t add_lazy(uint32_t a, uint32_t b) {
  const uint32_t s = a + b;  // < 4p < 2^32
  return __viaddmin_u32(s, 0u - kTwoP, s);
}

// a, b in [0, 2p) -> a - b + 2p, in (0, 4p); feeds only shoup_lazy.
__device__ __forceinline__ uint32_t sub_lazy(uint32_t a, uint32_t b) {
  return a - b + kTwoP;
}

// (a * w) mod p or that plus p, in [0, 2p), for any a < 2^32.
__device__ __forceinline__ uint32_t shoup_lazy(uint32_t a, uint32_t w,
                                               uint32_t ws) {
  return a * w - __umulhi(a, ws) * kP;
}

// Montgomery REDC(a * b) = a b 2^-32 mod p for b in [0, p) and a in
// [0, 2p) (the lazy butterflies hand pass 1 such an a).  The low word of
// a b + m p is zero by the choice of m, so its carry into the high word is
// 1 exactly when lo != 0; a b + m p < 2p p + 2^32 p, so u < 1.47 p < 2p
// before the final subtract and the result is canonical in [0, p).
__device__ __forceinline__ uint32_t mont_mul(uint32_t a, uint32_t b) {
  const uint32_t lo = a * b;
  const uint32_t hi = __umulhi(a, b);
  const uint32_t m = lo * kPinvNeg;
  const uint32_t u = hi + __umulhi(m, kP) + (lo != 0u ? 1u : 0u);
  return reduce_once(u);
}

}  // namespace stark
