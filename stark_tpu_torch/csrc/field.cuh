// u32 arithmetic over F_p, p = 998244353 = 119 * 2^23 + 1, for the port's
// CUDA kernels.  Field vectors live in int32 tensors holding values in
// [0, p) (p < 2^30); the kernels read that storage as uint32.
//
// The JAX package builds the 32x32 -> high-32 product from 16-bit limbs
// (stark_tpu/ops/fieldops.py:mulhi32), a TPU workaround; Hopper has it in
// one instruction, __umulhi.
#pragma once

#include <stdint.h>

namespace stark {

constexpr uint32_t kP = 998244353u;
// -p^{-1} mod 2^32: p * kPinvNeg == -1 (mod 2^32).
constexpr uint32_t kPinvNeg = 998244351u;
static_assert(static_cast<uint32_t>(kP * kPinvNeg) == 0xFFFFFFFFu,
              "kPinvNeg must be -p^-1 mod 2^32");

__device__ __forceinline__ uint32_t add_mod(uint32_t a, uint32_t b) {
  const uint32_t s = a + b;  // < 2p < 2^31: no wrap
  return s >= kP ? s - kP : s;
}

__device__ __forceinline__ uint32_t sub_mod(uint32_t a, uint32_t b) {
  return a >= b ? a - b : a - b + kP;
}

// (a * w) mod p for a constant w < p with companion ws = floor(w 2^32 / p).
// Valid for any a < 2^32: r = a w - floor(a ws / 2^32) p lies in [0, 2p).
__device__ __forceinline__ uint32_t shoup_mul(uint32_t a, uint32_t w,
                                              uint32_t ws) {
  const uint32_t q = __umulhi(a, ws);
  const uint32_t r = a * w - q * kP;
  return r >= kP ? r - kP : r;
}

// Montgomery REDC(a * b) = a b 2^-32 mod p for a, b in [0, p).  The low
// word of a b + m p is zero by the choice of m, so its carry into the high
// word is 1 exactly when lo != 0; u < 2p before the final subtract, so the
// result is canonical in [0, p).
__device__ __forceinline__ uint32_t mont_mul(uint32_t a, uint32_t b) {
  const uint32_t lo = a * b;
  const uint32_t hi = __umulhi(a, b);
  const uint32_t m = lo * kPinvNeg;
  const uint32_t u = hi + __umulhi(m, kP) + (lo != 0u ? 1u : 0u);
  return u >= kP ? u - kP : u;
}

}  // namespace stark
