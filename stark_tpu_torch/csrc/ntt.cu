// Four-step NTT over F_p for Hopper: kernels K1 (pass 1), K3 (transpose)
// and K2 (pass 2).  Replaces the Pallas engine of the JAX package,
// stark_tpu/ops/ntt_fused.py: _fused_ntt_jit's pass-1 call (:383, body
// _pass1_body :311), the pass-2 call (:409, body _pass2_body :318) and
// _pallas_transpose (:329) with the jnp.take row bit-reversals around it
// (:401-403, :421).
//
// With n = n1 * n2, x viewed as (n1, n2) row-major and omega the n-th root
// of the transform:
//   pass 1  column NTTs of length n1 (root omega^n2), each output element
//           (k1, i2) multiplied by omega^(k1 * i2) (and 1/n for the inverse)
//           - the plan's Montgomery table wm, consumed by one REDC;
//   K3      transpose (n1, n2) -> (n2, n1);
//   pass 2  column NTTs of length n2 (root omega^n1); the (n2, n1)
//           row-major result IS the natural-order transform.
//
// Column NTT design: one block owns a tile of 2^lg_tc whole columns in
// shared memory (rows of the tile are contiguous in device memory, so
// loads and stores are coalesced) and runs all lg_r radix-2 DIF stages
// there, one __syncthreads() per stage: one device-memory read and write
// per pass instead of one per stage.  DIF leaves the column bit-reversed;
// the store reads the tile at the bit-reversed row, so the output is in
// natural order and the TPU engine's row gathers are not needed (which is
// also why wm is NOT row-permuted here, unlike plan.wm on the TPU).  The
// TPU's roll/iota partner fetch and VMEM ping-pong are Mosaic layout
// devices with no counterpart here.
//
// Each pass has a strict and a lazy instantiation (the TPU bodies' lazy
// flag, _dif_col_stages(..., lazy=True) :253): strict keeps every value in
// [0, p); lazy keeps [0, 2p) between stages (field.cuh), which saves two
// selects per butterfly.  Pass 1's REDC absorbs the [0, 2p) operand; pass 2
// ends with one conditional subtract.  The outputs are bit-identical.
//
// What bounds it on the card: each pass moves 8 bytes per element through
// device memory (pass 1 adds 4 for wm), and does lg_r butterflies per
// element pair out of shared memory; at n = 2^22 a pass is ~32-48 MB of
// traffic against the H100 SXM's published 3.35 TB/s (700 W), so the
// shared-memory butterfly loop (one sync per stage, a 64 KB tile per
// block) is the part to tune later.
#include <cuda_runtime.h>
#include <stdint.h>

#include "field.cuh"

namespace {

using stark::add_lazy;
using stark::add_mod;
using stark::mont_mul;
using stark::reduce_once;
using stark::shoup_lazy;
using stark::shoup_mul;
using stark::sub_lazy;
using stark::sub_mod;

constexpr int kMaxThreads = 512;

// x, out: (batch, 2^lg_r, cols) row-major; block (bx, by) transforms the
// columns [bx * 2^lg_tc, (bx + 1) * 2^lg_tc) of batch entry by, in the
// shared-memory tile.  tw/tws: the 2^(lg_r - 1) powers of the column root
// and their Shoup companions; stage s multiplies by tw[j << s].
// wm: (2^lg_r, cols), read only when kTwiddle.
template <bool kTwiddle, bool kLazy>
__device__ __forceinline__ void col_ntt(const uint32_t* __restrict__ x,
                                        uint32_t* __restrict__ out,
                                        const uint32_t* __restrict__ tw,
                                        const uint32_t* __restrict__ tws,
                                        const uint32_t* __restrict__ wm,
                                        int lg_r, int cols, int lg_tc,
                                        uint32_t* tile) {
  const int tc = 1 << lg_tc;
  const int total = tc << lg_r;
  const int c0 = blockIdx.x << lg_tc;
  const size_t base = (size_t)blockIdx.y * ((size_t)cols << lg_r);

  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const int r = e >> lg_tc;
    const int c = e & (tc - 1);
    tile[e] = x[base + (size_t)r * cols + c0 + c];
  }
  __syncthreads();

  // Stage s: blocks of m = 2^(lg_r - s) rows; row i0 (first half of its
  // block, offset j) pairs with i1 = i0 + m / 2.
  for (int s = 0; s < lg_r; ++s) {
    const int lg_half = lg_r - 1 - s;
    for (int e = threadIdx.x; e < (total >> 1); e += blockDim.x) {
      const int c = e & (tc - 1);
      const int bf = e >> lg_tc;
      const int j = bf & ((1 << lg_half) - 1);
      const int i0 = ((bf >> lg_half) << (lg_half + 1)) + j;
      const int i1 = i0 + (1 << lg_half);
      const uint32_t u = tile[(i0 << lg_tc) + c];
      const uint32_t v = tile[(i1 << lg_tc) + c];
      if (kLazy) {
        tile[(i0 << lg_tc) + c] = add_lazy(u, v);
        tile[(i1 << lg_tc) + c] =
            shoup_lazy(sub_lazy(u, v), tw[j << s], tws[j << s]);
      } else {
        tile[(i0 << lg_tc) + c] = add_mod(u, v);
        tile[(i1 << lg_tc) + c] =
            shoup_mul(sub_mod(u, v), tw[j << s], tws[j << s]);
      }
    }
    __syncthreads();
  }

  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const int k = e >> lg_tc;
    const int c = e & (tc - 1);
    const int src = (int)(__brev((unsigned)k) >> (32 - lg_r));
    uint32_t v = tile[(src << lg_tc) + c];
    const size_t off = (size_t)k * cols + c0 + c;
    if (kTwiddle) {
      v = mont_mul(v, wm[off]);  // canonical for v in [0, 2p) too
    } else if (kLazy) {
      v = reduce_once(v);
    }
    out[base + off] = v;
  }
}

using ColNttKernel = void (*)(const uint32_t*, uint32_t*, const uint32_t*,
                              const uint32_t*, const uint32_t*, int, int, int);

int launch_col_ntt(ColNttKernel kernel, const void* x, void* out,
                   const void* tw, const void* tws, const void* wm, int batch,
                   int lg_r, int cols, int lg_tc, void* stream) {
  const int total = (1 << lg_r) << lg_tc;
  const int smem = total * (int)sizeof(uint32_t);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  int threads = total / 2;
  if (threads > kMaxThreads) threads = kMaxThreads;
  if (threads < 32) threads = 32;
  const dim3 grid((unsigned)(cols >> lg_tc), (unsigned)batch);
  kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      static_cast<const uint32_t*>(x), static_cast<uint32_t*>(out),
      static_cast<const uint32_t*>(tw), static_cast<const uint32_t*>(tws),
      static_cast<const uint32_t*>(wm), lg_r, cols, lg_tc);
  return (int)cudaGetLastError();
}

}  // namespace

// The __global__ functions have C linkage so that a profile names them
// plainly (stark_*_kernel); the host entries below launch them.
extern "C" {

#define STARK_COL_NTT_KERNEL(NAME, TWIDDLE, LAZY)                            \
  __global__ void __launch_bounds__(kMaxThreads)                             \
      NAME(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,       \
           const uint32_t* __restrict__ tw, const uint32_t* __restrict__ tws, \
           const uint32_t* __restrict__ wm, int lg_r, int cols, int lg_tc) { \
    extern __shared__ uint32_t tile[];                                       \
    col_ntt<TWIDDLE, LAZY>(x, out, tw, tws, wm, lg_r, cols, lg_tc, tile);    \
  }

STARK_COL_NTT_KERNEL(stark_ntt_pass1_kernel, true, false)
STARK_COL_NTT_KERNEL(stark_ntt_pass1_lazy_kernel, true, true)
STARK_COL_NTT_KERNEL(stark_ntt_pass2_kernel, false, false)
STARK_COL_NTT_KERNEL(stark_ntt_pass2_lazy_kernel, false, true)

#undef STARK_COL_NTT_KERNEL

// (batch, rows, cols) -> (batch, cols, rows) through a padded 32 x 33
// shared-memory tile, so both the read and the write are coalesced.
__global__ void stark_ntt_transpose_kernel(const uint32_t* __restrict__ x,
                                           uint32_t* __restrict__ out,
                                           int rows, int cols) {
  __shared__ uint32_t tile[32][33];
  const size_t base = (size_t)blockIdx.z * rows * cols;
  const int r0 = blockIdx.y * 32;
  const int c0 = blockIdx.x * 32;
  for (int i = threadIdx.y; i < 32; i += blockDim.y) {
    const int r = r0 + i;
    const int c = c0 + threadIdx.x;
    if (r < rows && c < cols) tile[i][threadIdx.x] = x[base + (size_t)r * cols + c];
  }
  __syncthreads();
  for (int i = threadIdx.y; i < 32; i += blockDim.y) {
    const int c = c0 + i;
    const int r = r0 + threadIdx.x;
    if (c < cols && r < rows) out[base + (size_t)c * rows + r] = tile[threadIdx.x][i];
  }
}

// K1: (batch, 2^lg_r, cols) column NTTs times the inter-pass twiddle wm.
int stark_ntt_pass1(const void* x, void* out, const void* tw, const void* tws,
                    const void* wm, int batch, int lg_r, int cols, int lg_tc,
                    void* stream) {
  return launch_col_ntt(stark_ntt_pass1_kernel, x, out, tw, tws, wm, batch,
                        lg_r, cols, lg_tc, stream);
}

// K1, lazy butterflies: the same function, bit for bit.
int stark_ntt_pass1_lazy(const void* x, void* out, const void* tw,
                         const void* tws, const void* wm, int batch, int lg_r,
                         int cols, int lg_tc, void* stream) {
  return launch_col_ntt(stark_ntt_pass1_lazy_kernel, x, out, tw, tws, wm,
                        batch, lg_r, cols, lg_tc, stream);
}

// K2: (batch, 2^lg_r, cols) column NTTs.
int stark_ntt_pass2(const void* x, void* out, const void* tw, const void* tws,
                    int batch, int lg_r, int cols, int lg_tc, void* stream) {
  return launch_col_ntt(stark_ntt_pass2_kernel, x, out, tw, tws, nullptr,
                        batch, lg_r, cols, lg_tc, stream);
}

// K2, lazy butterflies: the same function, bit for bit.
int stark_ntt_pass2_lazy(const void* x, void* out, const void* tw,
                         const void* tws, int batch, int lg_r, int cols,
                         int lg_tc, void* stream) {
  return launch_col_ntt(stark_ntt_pass2_lazy_kernel, x, out, tw, tws, nullptr,
                        batch, lg_r, cols, lg_tc, stream);
}

// K3: (batch, rows, cols) -> (batch, cols, rows).
int stark_ntt_transpose(const void* x, void* out, int batch, int rows,
                        int cols, void* stream) {
  const dim3 block(32, 8);
  const dim3 grid((unsigned)((cols + 31) / 32), (unsigned)((rows + 31) / 32),
                  (unsigned)batch);
  stark_ntt_transpose_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      static_cast<const uint32_t*>(x), static_cast<uint32_t*>(out), rows,
      cols);
  return (int)cudaGetLastError();
}

const char* stark_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
