// FRI fold for Hopper: kernel K4.  Replaces the Pallas kernel of the JAX
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
// What bounds it on the card: 16 bytes of device-memory traffic per output
// element (a, b, x^-1 read, one write) for ~10 integer multiplies - memory
// bound; at half = 2^21 that is 32 MB, ~10 us at the H100 SXM's published
// 3.35 TB/s (700 W).
#include <cuda_runtime.h>
#include <stdint.h>

#include "field.cuh"

using stark::add_mod;
using stark::mont_mul;
using stark::shoup_mul;
using stark::sub_mod;

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
    const uint32_t av = a[i];
    const uint32_t bv = b[i];
    const uint32_t t = shoup_mul(inv_x_mont[i], alpha, alpha_s);
    const uint32_t u = mont_mul(t, sub_mod(av, bv));
    out[i] = shoup_mul(add_mod(add_mod(av, bv), u), inv2, inv2_s);
  }
}

// codeword: (2 * half,) values; inv_x_mont, out: (half,).
int stark_fri_fold(const void* codeword, const void* inv_x_mont, void* out,
                   long long half, unsigned alpha, unsigned alpha_s,
                   unsigned inv2, unsigned inv2_s, void* stream) {
  const int threads = 256;
  long long blocks = (half + threads - 1) / threads;
  if (blocks > 4096) blocks = 4096;
  const uint32_t* cw = static_cast<const uint32_t*>(codeword);
  stark_fri_fold_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      cw, cw + half, static_cast<const uint32_t*>(inv_x_mont),
      static_cast<uint32_t*>(out), half, alpha, alpha_s, inv2, inv2_s);
  return (int)cudaGetLastError();
}

}  // extern "C"
