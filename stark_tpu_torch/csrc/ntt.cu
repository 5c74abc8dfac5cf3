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
// Column NTT design (K1; K2 runs the same column function).  A block owns
// a tile of 2^lg_tc whole columns.  The lg_r radix-2 DIF stages are cut
// into rounds of at most four (round_stages: 11 = 3 + 4 + 4, 10 = 3 + 3 +
// 4, 9 = 3 + 3 + 3, 8 = 4 + 4; a column of 16 rows or fewer is one round).
// In a round of q stages a thread holds the 2^q elements of one column
// whose rows differ only in the q bits the round works on, runs the q
// stages on them in registers, and puts them back: the round's partners
// are all in the thread, so the block meets at one barrier per round, not
// one per stage.  The first round reads its elements straight from device
// memory and the last one writes straight to it, so the tile in shared
// memory is written and read once per inner boundary (twice each at 2^22,
// where the stage loop this replaces crossed it 11 times with 11
// barriers).  The 2^(lg_r - 1) twiddles and their Shoup companions are
// copied into shared memory once per block as (w, w') pairs; a round of q
// stages reads 2^q - 1 of them per thread for 2^(q-1) q butterflies.
// Neighbouring threads take neighbouring columns, so every access to
// device memory is a run of 2^lg_tc values of one row, and a warp's
// accesses to the tile fall in 32 different banks: for tiles narrower than
// 32 columns the last round's rows lie 2^q apart, and the tile is padded
// by 32 / 2^q words per 32 so that they still do.
//
// DIF leaves a column bit-reversed; the last round stores row r at its
// bit-reversed place, so the output is in natural order and the TPU
// engine's row gathers are not needed (which is also why wm is NOT
// row-permuted here, unlike plan.wm on the TPU).  The TPU's roll/iota
// partner fetch and VMEM ping-pong are Mosaic layout devices with no
// counterpart here.
//
// Each pass has a strict and a lazy instantiation (the TPU bodies' lazy
// flag, _dif_col_stages(..., lazy=True) :253): strict keeps every value in
// [0, p); lazy keeps [0, 2p) between stages (field.cuh), which saves two
// selects per butterfly.  Grouping the stages into rounds changes neither
// the order nor the operands of any butterfly - a value still passes
// through its lg_r stages one after the other, in registers or not - so
// the range argument is the one of field.cuh, stage by stage: inputs in
// [0, p), add_lazy and shoup_lazy return [0, 2p), sub_lazy's (0, 4p) feeds
// only shoup_lazy.  Pass 1's REDC absorbs the [0, 2p) operand; pass 2 ends
// with one conditional subtract.  The outputs are bit-identical.
//
// What bounds it on the card: bytes.  A pass moves 8 bytes per element
// through device memory (pass 1 adds 4 for wm) and does lg_r / 2
// butterflies of 8-11 instructions per element; at n = 2^22 that is 48 MB
// against the H100 SXM's published 3.35 TB/s (15 us) and 0.29e9
// instructions against 33.5e12 per second (9 us).  After this design a
// pass reaches 30-45 % of the byte bound (PERF.md): at these sizes all of
// a pass's blocks are on the card at once, so every block loads, then
// computes, then stores at the same time as every other, and nothing
// overlaps the three.  Tile width and threads per block come from the
// wrapper (ops/ntt_fused.py _launch_shape, set from the sweep of
// tools/tune_kernels.py): tiles of 2^15 elements, one thread per radix-16
// unit, and narrower tiles where a pass would otherwise run on fewer than
// 128 blocks.  That last rule leaves the passes of n = 2^20 with tiles 8
// columns wide (16 at 2^22), so a row of the tile is a 32-byte run of
// device memory, the narrowest that wastes no sector: in the sweep wider
// rows on fewer blocks were slower there (pass 1 with 16 columns on 64
// blocks 16.5 us against 12.5), because 64 blocks leave half of the
// card's SMs without work.  Wider rows at full occupancy need a block that
// holds less than a whole column, which this four-step layout does not
// give; loads that run ahead of the butterflies (cp.async, a second tile
// in flight) are the next step and are not built.
// ptxas -v (sm_90a, CUDA 12, __launch_bounds__(1024); tools/tune_kernels.py
// prints it): 64 registers for pass 1 and both pass 2 kernels, 62 for lazy
// pass 1; no spills, no stack.
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

// The most threads of a block; the register budget follows from it
// (65,536 registers over 1024 threads: 64 each).
constexpr int kMaxThreads = 1024;
constexpr int kMaxRound = 4;  // stages per round: radix 16
constexpr int kMaxLgR = 13;   // a column and its twiddles must fit a block
constexpr int kSmemMax = 227 * 1024;

// The rounds of a length-2^lg_r column: ceil(lg_r / 4) of them, as even as
// can be, the longer ones last.
struct Rounds {
  int count, base, longer;  // `longer` rounds of base + 1 stages at the end
  __host__ __device__ explicit Rounds(int lg_r)
      : count((lg_r + kMaxRound - 1) / kMaxRound),
        base(lg_r / count),
        longer(lg_r - base * count) {}
  __host__ __device__ int stages(int round) const {
    return base + (round >= count - longer ? 1 : 0);
  }
};

// m's low `bits` bits in reverse order (m and bits are constants wherever
// this is called, so it folds).
__device__ __forceinline__ int reversed(int m, int bits) {
  int r = 0;
#pragma unroll
  for (int b = 0; b < bits; ++b) r |= ((m >> b) & 1) << (bits - 1 - b);
  return r;
}

// One round of Q stages, the stages s0 .. s0 + Q - 1 of the column NTT, on
// the block's tile.  With b_lo = lg_r - s0 - Q, a unit is the 2^Q rows
// (hi << (b_lo + Q)) | (m << b_lo) | lo, m < 2^Q, of one column; unit u of
// the tile has column u mod 2^lg_tc, lo the next b_lo bits and hi the
// rest.  Stage s0 + t pairs m with m + 2^(Q-1-t) and multiplies the
// difference by tw[j << (s0 + t)], j the row's offset in its half block:
// j = ((m mod 2^(Q-1-t)) << b_lo) | lo.
// `first`: the elements come from x, else from the tile; `last` (b_lo is 0
// then): they go to out, row r at r's bit-reversed place, through the
// pass's closing step, else back to the tile.  x, out and wm point at the
// block's first column of the batch entry.
template <int Q, bool kTwiddle, bool kLazy>
__device__ __forceinline__ void ntt_round(
    const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
    const uint32_t* __restrict__ wm, const uint2* twd, uint32_t* tile,
    int lg_r, int cols, int lg_tc, int pad, int s0, bool first, bool last) {
  constexpr int kM = 1 << Q;
  const int b_lo = lg_r - s0 - Q;
  const int units = 1 << (lg_r - Q + lg_tc);
  for (int u = threadIdx.x; u < units; u += blockDim.x) {
    const int c = u & ((1 << lg_tc) - 1);
    const int g = u >> lg_tc;
    const int lo = g & ((1 << b_lo) - 1);
    const int hi = g >> b_lo;
    const int row0 = (hi << (b_lo + Q)) | lo;
    uint32_t v[kM];
    if (first) {
#pragma unroll
      for (int m = 0; m < kM; ++m)
        v[m] = x[(size_t)(row0 + (m << b_lo)) * cols + c];
    } else {
#pragma unroll
      for (int m = 0; m < kM; ++m) {
        const int e = ((row0 + (m << b_lo)) << lg_tc) + c;
        v[m] = tile[e + (e >> 5) * pad];
      }
    }
#pragma unroll
    for (int t = 0; t < Q; ++t) {
      const int half = 1 << (Q - 1 - t);
#pragma unroll
      for (int k = 0; k < half; ++k) {
        const uint2 w = twd[((k << b_lo) | lo) << (s0 + t)];
#pragma unroll
        for (int m0 = k; m0 < kM; m0 += 2 * half) {
          const uint32_t a = v[m0];
          const uint32_t b = v[m0 + half];
          if (kLazy) {
            v[m0] = add_lazy(a, b);
            v[m0 + half] = shoup_lazy(sub_lazy(a, b), w.x, w.y);
          } else {
            v[m0] = add_mod(a, b);
            v[m0 + half] = shoup_mul(sub_mod(a, b), w.x, w.y);
          }
        }
      }
    }
    if (last) {
      // Row (hi << Q) | m goes to (reversed m) << (lg_r - Q) | reversed hi.
      const int hi_bits = lg_r - Q;
      const int hi_rev =
          hi_bits == 0 ? 0 : (int)(__brev((unsigned)hi) >> (32 - hi_bits));
#pragma unroll
      for (int m = 0; m < kM; ++m) {
        const size_t off =
            (size_t)((reversed(m, Q) << hi_bits) | hi_rev) * cols + c;
        uint32_t y = v[m];
        if (kTwiddle) {
          y = mont_mul(y, wm[off]);  // canonical for y in [0, 2p) too
        } else if (kLazy) {
          y = reduce_once(y);
        }
        out[off] = y;
      }
    } else {
#pragma unroll
      for (int m = 0; m < kM; ++m) {
        const int e = ((row0 + (m << b_lo)) << lg_tc) + c;
        tile[e + (e >> 5) * pad] = v[m];
      }
    }
  }
}

// x, out: (batch, 2^lg_r, cols) row-major; block (bx, by) transforms the
// columns [bx * 2^lg_tc, (bx + 1) * 2^lg_tc) of batch entry by.  tw/tws:
// the 2^(lg_r - 1) powers of the column root and their Shoup companions.
// wm: (2^lg_r, cols), read only when kTwiddle.  smem: the twiddle pairs,
// then the tile (element e at word e + (e >> 5) * pad).
template <bool kTwiddle, bool kLazy>
__device__ __forceinline__ void col_ntt(const uint32_t* __restrict__ x,
                                        uint32_t* __restrict__ out,
                                        const uint32_t* __restrict__ tw,
                                        const uint32_t* __restrict__ tws,
                                        const uint32_t* __restrict__ wm,
                                        int lg_r, int cols, int lg_tc, int pad,
                                        uint32_t* smem) {
  const int pairs = 1 << (lg_r - 1);
  uint2* twd = reinterpret_cast<uint2*>(smem);
  uint32_t* tile = smem + 2 * pairs;
  for (int i = threadIdx.x; i < pairs; i += blockDim.x)
    twd[i] = make_uint2(tw[i], tws[i]);
  __syncthreads();

  const size_t c0 = (size_t)blockIdx.x << lg_tc;
  const size_t base = (size_t)blockIdx.y * ((size_t)cols << lg_r) + c0;
  x += base;
  out += base;
  if (kTwiddle) wm += c0;

  const Rounds rounds(lg_r);
  int s0 = 0;
  for (int r = 0; r < rounds.count; ++r) {
    const int q = rounds.stages(r);
    const bool first = r == 0;
    const bool last = r == rounds.count - 1;
    switch (q) {
      case 1:
        ntt_round<1, kTwiddle, kLazy>(x, out, wm, twd, tile, lg_r, cols, lg_tc,
                                      pad, s0, first, last);
        break;
      case 2:
        ntt_round<2, kTwiddle, kLazy>(x, out, wm, twd, tile, lg_r, cols, lg_tc,
                                      pad, s0, first, last);
        break;
      case 3:
        ntt_round<3, kTwiddle, kLazy>(x, out, wm, twd, tile, lg_r, cols, lg_tc,
                                      pad, s0, first, last);
        break;
      default:
        ntt_round<4, kTwiddle, kLazy>(x, out, wm, twd, tile, lg_r, cols, lg_tc,
                                      pad, s0, first, last);
    }
    s0 += q;
    if (!last) __syncthreads();
  }
}

using ColNttKernel = void (*)(const uint32_t*, uint32_t*, const uint32_t*,
                              const uint32_t*, const uint32_t*, int, int, int,
                              int);

int launch_col_ntt(ColNttKernel kernel, const void* x, void* out,
                   const void* tw, const void* tws, const void* wm, int batch,
                   int lg_r, int cols, int lg_tc, int threads, void* stream) {
  if (lg_r < 1 || lg_r > kMaxLgR || lg_tc < 0 || lg_tc > 20 || batch < 1 ||
      cols < 1 || (cols & ((1 << lg_tc) - 1)) || threads < 32 ||
      threads > kMaxThreads || threads % 32)
    return (int)cudaErrorInvalidValue;
  // Tiles narrower than a warp: pad for the last round (see the head note).
  const Rounds rounds(lg_r);
  const int pad = rounds.count > 1 && lg_tc < 5
                      ? 32 >> rounds.stages(rounds.count - 1)
                      : 0;
  const long long total = 1LL << (lg_r + lg_tc);
  const long long words = (1LL << lg_r) + total + (total >> 5) * pad;
  if (words * 4 > kSmemMax) return (int)cudaErrorInvalidValue;
  const int smem = (int)words * 4;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((unsigned)(cols >> lg_tc), (unsigned)batch);
  kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      static_cast<const uint32_t*>(x), static_cast<uint32_t*>(out),
      static_cast<const uint32_t*>(tw), static_cast<const uint32_t*>(tws),
      static_cast<const uint32_t*>(wm), lg_r, cols, lg_tc, pad);
  return (int)cudaGetLastError();
}

}  // namespace

// The __global__ functions have C linkage so that a profile names them
// plainly (stark_*_kernel); the host entries below launch them.
extern "C" {

#define STARK_COL_NTT_KERNEL(NAME, TWIDDLE, LAZY)                             \
  __global__ void __launch_bounds__(kMaxThreads)                              \
      NAME(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,        \
           const uint32_t* __restrict__ tw, const uint32_t* __restrict__ tws, \
           const uint32_t* __restrict__ wm, int lg_r, int cols, int lg_tc,    \
           int pad) {                                                         \
    extern __shared__ uint2 smem[];                                           \
    col_ntt<TWIDDLE, LAZY>(x, out, tw, tws, wm, lg_r, cols, lg_tc, pad,       \
                           reinterpret_cast<uint32_t*>(smem));                \
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
                    int threads, void* stream) {
  return launch_col_ntt(stark_ntt_pass1_kernel, x, out, tw, tws, wm, batch,
                        lg_r, cols, lg_tc, threads, stream);
}

// K1, lazy butterflies: the same function, bit for bit.
int stark_ntt_pass1_lazy(const void* x, void* out, const void* tw,
                         const void* tws, const void* wm, int batch, int lg_r,
                         int cols, int lg_tc, int threads, void* stream) {
  return launch_col_ntt(stark_ntt_pass1_lazy_kernel, x, out, tw, tws, wm,
                        batch, lg_r, cols, lg_tc, threads, stream);
}

// K2: (batch, 2^lg_r, cols) column NTTs.
int stark_ntt_pass2(const void* x, void* out, const void* tw, const void* tws,
                    int batch, int lg_r, int cols, int lg_tc, int threads,
                    void* stream) {
  return launch_col_ntt(stark_ntt_pass2_kernel, x, out, tw, tws, nullptr,
                        batch, lg_r, cols, lg_tc, threads, stream);
}

// K2, lazy butterflies: the same function, bit for bit.
int stark_ntt_pass2_lazy(const void* x, void* out, const void* tw,
                         const void* tws, int batch, int lg_r, int cols,
                         int lg_tc, int threads, void* stream) {
  return launch_col_ntt(stark_ntt_pass2_lazy_kernel, x, out, tw, tws, nullptr,
                        batch, lg_r, cols, lg_tc, threads, stream);
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
