// FRI fold for Hopper: kernel K4, and K4-dyn, its twin that reads each
// codeword row's alpha from device memory.  K4 replaces the Pallas kernel of the JAX
// package, stark_tpu/ops/pallas_kernels.py: fold_pallas (:87, call :104,
// body _fold_body :46), the same math as stark_tpu/fri.py:_fold_kernel
// (:70):
//
//   folded[i] = 2^-1 * ((a + b) + alpha * x_i^-1 * (a - b))  mod p,
//   a = codeword[i], b = codeword[i + half],
//
// with x_i^-1 given in Montgomery form (FriPlan.inv_x_mont): one Shoup
// multiply by alpha keeps it in Montgomery form, one REDC by (a - b) lands
// in standard form, and a Shoup multiply by 2^-1 finishes.  The TPU kernel's
// (512, 128) VMEM tiling is a Mosaic layout device; here a grid-stride loop
// covers any length.
//
// K4-dyn (stark_fri_fold_dyn) replaces stark_tpu/fri.py:_fold_kernel_dynamic
// (:85-94), the fold of the device-chained commit (fri.py:529, batch.py:
// 1029): codewords (B, n), one alpha per row in device memory, drawn there
// by the sponge (K9, hash.cu), so that no round waits for the host.  It
// has no Shoup companion for that alpha, so a thread takes alpha's
// Montgomery form first (alpha 2^32 mod p, one Montgomery product by 2^64
// mod p) and then folds exactly as K4 does; the result is the same
// canonical value as the JAX function's Montgomery product and full
// multiply mod p.
//
// What bounds them on the card: 16 bytes of device-memory traffic per
// output element (a, b, x^-1 read, one write) for ~10 integer multiplies -
// memory bound; at half = 2^21 that is 32 MB, ~10 us at the H100 SXM's
// published 3.35 TB/s (700 W).  K4-dyn reads one alpha per row besides.
#include <cuda_runtime.h>
#include <stdint.h>

#include "field.cuh"

using stark::add_mod;
using stark::kP;
using stark::mont_mul;
using stark::shoup_mul;
using stark::sub_mod;

namespace {

// 2^64 mod p: mont_mul(x, kR2) = x 2^32 mod p, x's Montgomery form.
constexpr uint64_t kR1 = (1ull << 32) % kP;
constexpr uint32_t kR2 = static_cast<uint32_t>(kR1 * kR1 % kP);

// One folded element: t = alpha x^-1 in Montgomery form; one REDC by
// (a - b) lands in standard form, and a Shoup multiply by 2^-1 finishes.
__device__ __forceinline__ uint32_t fold_one(uint32_t av, uint32_t bv,
                                             uint32_t t, uint32_t inv2,
                                             uint32_t inv2_s) {
  const uint32_t u = mont_mul(t, sub_mod(av, bv));
  return shoup_mul(add_mod(add_mod(av, bv), u), inv2, inv2_s);
}

constexpr int kFoldThreads = 256;

}  // namespace

// C linkage, so that a profile names the kernel plainly.
extern "C" {

__global__ void stark_fri_fold_kernel(const uint32_t* __restrict__ a,
                                      const uint32_t* __restrict__ b,
                                      const uint32_t* __restrict__ inv_x_mont,
                                      uint32_t* __restrict__ out,
                                      long long half, uint32_t alpha,
                                      uint32_t alpha_s, uint32_t inv2,
                                      uint32_t inv2_s) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < half; i += stride) {
    const uint32_t t = shoup_mul(inv_x_mont[i], alpha, alpha_s);
    out[i] = fold_one(a[i], b[i], t, inv2, inv2_s);
  }
}

// codewords: rows of 2 half values; alpha: one reduced value per row;
// out: rows of half.  blockIdx.y walks the rows.
__global__ void stark_fri_fold_dyn_kernel(const uint32_t* __restrict__ codewords,
                                          const uint32_t* __restrict__ inv_x_mont,
                                          const uint32_t* __restrict__ alpha,
                                          uint32_t* __restrict__ out,
                                          long long half, int rows,
                                          uint32_t inv2, uint32_t inv2_s) {
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

// codeword: (2 * half,) values; inv_x_mont, out: (half,).
int stark_fri_fold(const void* codeword, const void* inv_x_mont, void* out,
                   long long half, unsigned alpha, unsigned alpha_s,
                   unsigned inv2, unsigned inv2_s, void* stream) {
  long long blocks = (half + kFoldThreads - 1) / kFoldThreads;
  if (blocks > 4096) blocks = 4096;
  const uint32_t* cw = static_cast<const uint32_t*>(codeword);
  stark_fri_fold_kernel<<<(unsigned)blocks, kFoldThreads, 0,
                          (cudaStream_t)stream>>>(
      cw, cw + half, static_cast<const uint32_t*>(inv_x_mont),
      static_cast<uint32_t*>(out), half, alpha, alpha_s, inv2, inv2_s);
  return (int)cudaGetLastError();
}

// K4-dyn: codewords (rows, 2 half) -> out (rows, half); alpha (rows,) on
// the card; inv_x_mont (half,) shared by every row.
int stark_fri_fold_dyn(const void* codewords, const void* inv_x_mont,
                       const void* alpha, void* out, long long half, int rows,
                       unsigned inv2, unsigned inv2_s, void* stream) {
  if (rows < 1 || rows > 65535) return (int)cudaErrorInvalidValue;
  long long per_row = (half + kFoldThreads - 1) / kFoldThreads;
  long long cap = 4096 / rows > 0 ? 4096 / rows : 1;
  if (per_row > cap) per_row = cap;
  stark_fri_fold_dyn_kernel<<<dim3((unsigned)per_row, (unsigned)rows),
                              kFoldThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const uint32_t*>(codewords),
      static_cast<const uint32_t*>(inv_x_mont),
      static_cast<const uint32_t*>(alpha), static_cast<uint32_t*>(out), half,
      rows, inv2, inv2_s);
  return (int)cudaGetLastError();
}

}  // extern "C"
