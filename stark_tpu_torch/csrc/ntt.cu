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
// Column NTT design (K1 and K2 run the same column function).  A block
// owns a tile of 2^lg_tc whole columns.  The lg_r radix-2 DIF stages are
// cut into rounds of at most four, the longer ones first (round_stages: 11
// = 4 + 4 + 3, 10 = 4 + 3 + 3, 9 = 3 + 3 + 3, 8 = 4 + 4; a column of 16
// rows or fewer is one round).  In a round of q stages a thread holds the
// 2^q elements of one column whose rows differ only in the q bits the
// round works on, runs the q stages on them in registers, and puts them
// back: the round's partners are all in the thread, so the block meets at
// one barrier per round, not one per stage.  The first round reads its
// elements straight from device memory and the last one writes straight
// to it, so the tile in shared memory is written and read once per inner
// boundary.  A warp starts its butterflies as soon as its own loads have
// landed, and its stores leave behind it while it goes on: the loads and
// stores of some warps overlap the arithmetic of others without any
// staging.  The longest round comes first because its 16 loads per thread
// are what keeps device memory busy at the start, when nothing else can
// run.  The 2^(lg_r - 1) twiddles and their Shoup companions are copied
// into shared memory once per block as (w, w') pairs, after the first
// round's loads have been issued and before its butterflies, so the two
// trips to device memory overlap; a round of q stages reads 2^q - 1 of
// them per thread for 2^(q-1) q butterflies.
//
// Addresses.  Neighbouring threads take neighbouring columns, so every
// access to device memory is a run of 2^lg_tc values of one row.  A unit's
// 2^q elements lie 2^(b_lo + lg_tc) elements apart (b_lo the stage bits
// below the round's), so a thread computes one base for its unit and the
// element m is at base + m * pitch, pitch the same for the whole block:
// one multiply-add per access, in the tile and in device memory (offsets
// into a batch entry fit 32 bits).  For that the tile's padding has to
// keep equal steps equal.  The padding is there for the last round of a
// tile narrower than a warp: its rows (hi << q) | m lie 2^q rows apart
// for the warp's 32 / 2^lg_tc values of hi, which without padding are the
// same banks.  One row of padding (2^lg_tc words) after every 2^q rows
// moves each hi to the next 2^lg_tc banks, so a warp's 32 accesses fall
// in 32 banks in every round (a test enumerates it), and it keeps the
// steps equal: in the last round all of a unit lies between two pads, in
// the earlier rounds its elements lie whole numbers of pads apart (b_lo
// >= q there).
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
// [0, p); lazy keeps [0, 2p) between stages (field.cuh).  Grouping the
// stages into rounds changes neither the order nor the operands of any
// butterfly - a value still passes through its lg_r stages one after the
// other, in registers or not - so the range argument is the one of
// field.cuh, stage by stage: inputs in [0, p), add_lazy and shoup_lazy
// return [0, 2p), sub_lazy's (0, 4p) feeds only shoup_lazy.  Pass 1's REDC
// absorbs the [0, 2p) operand; pass 2 ends with one conditional subtract.
// The strict butterfly hands its difference to the Shoup product as a - b
// + p in (0, 2p), which that product takes (any u32) and reduces to the
// same canonical value, and every correction is Hopper's add-and-minimum
// (VIADDMNMX, field.cuh reduce_once): 7 instructions a butterfly where
// compare and select made 11, the lazy one 6.  The outputs are
// bit-identical.
//
// What bounds it on the card: the instructions, not the bytes.  A pass
// moves 8 bytes per element through device memory (pass 1 adds 4 for wm):
// 32 MB at n = 2^22, 10 us at the H100 SXM's published 3.35 TB/s.
// tools/tune_kernels.py times the kernels with parts of their work taken
// out (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md has the table): of pass
// 2's 23.4 us at n = 2^22, 8.2 are the tile, the twiddles, the barriers,
// the indices and the launch, 8.5 the butterflies, and 6.7 are device
// memory that the arithmetic does not hide; at n = 2^20 (9.3 us) the
// three are 4.3, 2.2 and 2.9, and a launch alone is 1.3.  So the kernel
// cannot reach half of its byte bound by moving bytes better.  A ring of tile buffers filled by 16-byte
// cp.async copies, a block walking over several column groups, was built
// and measured slower at every shape (31.5 us against 28.6 at 2^22): the
// block then waits for a whole group to land where here each warp waits
// only for its own rows, a column of 2^11 rows leaves room for two groups
// a block, and the copy costs one more trip through shared memory.  It is
// not in the source.  What did help is in the paragraphs above: fewer
// instructions per butterfly and per access, one latency less at the
// start, more loads in flight in the first round, and smaller blocks.
//
// Tile width and threads per block come from the wrapper
// (ops/ntt_fused.py _launch_shape, set from the sweep of
// tools/tune_kernels.py): tiles of 2^13 elements, at least 8 columns wide
// (a row of the tile is then a 32-byte run of device memory, the narrowest
// that wastes no sector), one thread per radix-16 unit and at most 512,
// narrower tiles where a pass would otherwise run on fewer than 128
// blocks.  Two to four such blocks share an SM and drift apart, so one's
// loads and stores overlap another's butterflies.
//
// K3 is at the end of the file: 4 x 4 blocks transposed in registers
// between 16-byte loads and 16-byte stores, no shared memory, for rows and
// columns that are multiples of 4; the padded 32 x 33 shared tile for the
// rest.
//
// K1 of an LDE (stark_ntt_pass1_lde) is pass 1 with the low-degree
// extension's zero pad and coset scale (stark_tpu/ops/ntt.py lde's jnp.pad
// :189-195 and _coset_scale_fwd :151-154, which XLA fuses into one
// elementwise pass on the TPU) in its first round: it reads an entry's T
// coefficients as they stand (stride T), loads element e = i1 n2 + i2 of
// the (n1, n2) view only where e < T and multiplies it by s^e = s^(n2 i1)
// s^i2, two Shoup products by entries of two short tables (LdeInput); the
// rest is zero and nothing is loaded.  At blowup 4 a quarter of the first
// round's loads remain, and the (rows, N) padded array is neither written
// nor read: one launch and 8 N bytes a row less than K14 then K1.  Its
// registers are the column kernels' (below).
//
// K14, after it, is the same pad and scale as a kernel of its own, for the
// other coset scales (ops/ntt.py coset_eval, coset_interp; the sharded
// four-step's twiddles and shares, parallel/pntt.py):
// (rows, T) coefficients in, (rows, N) out, out[r, k] = c[r, k]
// s^k mod p for k < T and 0 for T <= k < N.  One thread a 16-byte word of
// the output: below T it reads the coefficients' word and the word of the
// powers s^k and of their Shoup companions (a (2, T) table the wrapper
// builds once per (T, s, card), read from L2 by every row after the
// first), above T it writes zeros and reads nothing.  Bound by the bytes:
// 4 (T + N) a row, 6.3 us at T = 2^20, N = 2^22 and 3.35 TB/s; a Shoup
// product (5 integer instructions) an element is far below the issue rate.
// A T under 4 takes the edge route, one element a thread.
//
// ptxas -v (sm_90a, CUDA 12, __launch_bounds__(1024); tools/tune_kernels.py
// prints it): 64 registers for all six column kernels (K1 of an LDE's two
// among them), 34 for the transpose's vector route, 18 for its edge route;
// no spills, no stack.
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
using stark::sub_open;

// The most threads of a block; the register budget follows from it
// (65,536 registers over 1024 threads: 64 each).
constexpr int kMaxThreads = 1024;
constexpr int kMaxRound = 4;  // stages per round: radix 16
constexpr int kMaxLgR = 13;   // a column and its twiddles must fit a block
constexpr int kSmemMax = 227 * 1024;
constexpr int kNoPad = 31;  // a pad shift under which no index is padded

// The rounds of a length-2^lg_r column: ceil(lg_r / 4) of them, as even as
// can be, the longer ones first.
struct Rounds {
  int count, base, longer;  // `longer` rounds of base + 1 stages at the start
  __host__ __device__ explicit Rounds(int lg_r)
      : count((lg_r + kMaxRound - 1) / kMaxRound),
        base(lg_r / count),
        longer(lg_r - base * count) {}
  __host__ __device__ int stages(int round) const {
    return base + (round < longer ? 1 : 0);
  }
};

// m's low `bits` bits in reverse order, 1 <= bits <= 32.  Where m and bits
// are constants it folds; written as a loop over the bits it did not, and
// cost the last round some forty instructions for every store.
__device__ __forceinline__ uint32_t reversed(uint32_t m, int bits) {
  return __brev(m) >> (32 - bits);
}

// Element e of a tile of 2^lg_tc columns lies at word e + 2^lg_tc * (e >>
// pad_shift): one row of padding after every 2^pad_shift elements (see the
// head note).
__host__ __device__ inline int tile_word(int e, int pad_shift, int lg_tc) {
  return e + ((e >> pad_shift) << lg_tc);
}

// The LDE's input to pass 1 (stark_ntt_pass1_lde): an entry's T
// coefficients, element e = row n2 + col of the (n1, n2) view read only
// where e < T and scaled by s^e = s^(n2 row) s^col, the two powers from the
// short tables rows (n1 pairs) and cols (n2 pairs), each a value and its
// Shoup companion.  c0: the block's first column; limit = T - c0, the
// bound of e - c0.
struct LdeInput {
  const uint2* rows;
  const uint2* cols;
  int c0;
  int limit;
};

// y s^e for element e at (row, col): two Shoup products, s^(n2 row) then
// s^col (tools/tune_kernels.py builds the design with one (T, 2) table of
// s^e in place of the two, and times the two in turn).
__device__ __forceinline__ uint32_t lde_scaled(uint32_t y, const LdeInput& lde,
                                               int row, int col, int e) {
  const uint2 r = lde.rows[row], k = lde.cols[col];
  return shoup_mul(shoup_mul(y, r.x, r.y), k.x, k.y);
}

// One round of Q stages, the stages s0 .. s0 + Q - 1 of the column NTT, on
// the block's tile.  With b_lo = lg_r - s0 - Q, a unit is the 2^Q rows
// (hi << (b_lo + Q)) | (m << b_lo) | lo, m < 2^Q, of one column; unit u of
// the tile has column u mod 2^lg_tc, lo the next b_lo bits and hi the
// rest.  Stage s0 + t pairs m with m + 2^(Q-1-t) and multiplies the
// difference by tw[j << (s0 + t)], j the row's offset in its half block:
// j = ((m mod 2^(Q-1-t)) << b_lo) | lo.
// `first`: the elements come from x (kLde: the LDE's coefficients, lde),
// and the block fills its twiddle pairs twd from tw/tws while the first
// unit's loads are on their way; else they come from the tile.  `last`
// (b_lo is 0 then): they go to out, row r at r's bit-reversed place,
// through the pass's closing step, else back to the tile.  x, out and wm
// point at the tile's first column of its batch entry.
// Every address is a base that the thread computes once for its unit plus
// m times a pitch that is the same for the whole block: in the tile
// because a unit's elements lie whole runs of padding apart (or, in the
// last round, inside one run), in device memory because they lie whole
// rows apart.
template <int Q, bool kTwiddle, bool kLazy, bool kLde>
__device__ __forceinline__ void ntt_round(
    const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
    const uint32_t* __restrict__ wm, const uint32_t* __restrict__ tw,
    const uint32_t* __restrict__ tws, uint2* twd, uint32_t* tile, int lg_r,
    int cols, int lg_tc, int pad_shift, int s0, bool first, bool last,
    const LdeInput& lde) {
  constexpr int kM = 1 << Q;
  const int b_lo = lg_r - s0 - Q;
  const int units = 1 << (lg_r - Q + lg_tc);
  const int step = 1 << (b_lo + lg_tc);  // elements between m and m + 1
  const int pitch = tile_word(step, pad_shift, lg_tc);
  // Offsets into a batch entry fit 32 bits (the launcher sees to it).
  const uint32_t x_pitch = (uint32_t)cols << b_lo;
  const int hi_bits = lg_r - Q;  // of the last round, where b_lo is 0
  const uint32_t out_pitch = (uint32_t)cols << hi_bits;
  // Every thread makes the same number of turns, so that the barrier after
  // the twiddle fill is met by all of them.
  const int turns = (units + blockDim.x - 1) / blockDim.x;
  for (int turn = 0; turn < turns; ++turn) {
    const int u = turn * blockDim.x + threadIdx.x;
    const bool mine = u < units;
    const int c = u & ((1 << lg_tc) - 1);
    const int g = u >> lg_tc;
    const int lo = g & ((1 << b_lo) - 1);
    const int hi = g >> b_lo;
    const int row0 = (hi << (b_lo + Q)) | lo;
    uint32_t* cell = tile + tile_word((row0 << lg_tc) + c, pad_shift, lg_tc);
    uint32_t v[kM];
    if (mine) {
      if (first && kLde) {
        // Element e = c0 + src + m x_pitch of the coefficients, loaded
        // only where e < T (lde.limit = T - c0) and scaled by s^e.
        const uint32_t src = (uint32_t)row0 * cols + c;
#pragma unroll
        for (int m = 0; m < kM; ++m) {
          const int e = (int)(src + m * x_pitch);
          v[m] = e < lde.limit
                     ? lde_scaled(x[e], lde, row0 + (m << b_lo), lde.c0 + c, lde.c0 + e)
                     : 0u;
        }
      } else if (first) {
        const uint32_t src = (uint32_t)row0 * cols + c;
#pragma unroll
        for (int m = 0; m < kM; ++m) v[m] = x[src + m * x_pitch];
      } else {
#pragma unroll
        for (int m = 0; m < kM; ++m) v[m] = cell[m * pitch];
      }
    }
    if (first && turn == 0) {
      for (int i = threadIdx.x; i < (1 << (lg_r - 1)); i += blockDim.x)
        twd[i] = make_uint2(tw[i], tws[i]);
      __syncthreads();
    }
    if (!mine) continue;
#pragma unroll
    for (int t = 0; t < Q; ++t) {
      const int half = 1 << (Q - 1 - t);
      const uint2* tw_lo = twd + (lo << (s0 + t));
#pragma unroll
      for (int k = 0; k < half; ++k) {
        const uint2 w = tw_lo[k << (b_lo + s0 + t)];
#pragma unroll
        for (int m0 = k; m0 < kM; m0 += 2 * half) {
          const uint32_t a = v[m0];
          const uint32_t b = v[m0 + half];
          if (kLazy) {
            v[m0] = add_lazy(a, b);
            v[m0 + half] = shoup_lazy(sub_lazy(a, b), w.x, w.y);
          } else {
            v[m0] = add_mod(a, b);
            v[m0 + half] = shoup_mul(sub_open(a, b), w.x, w.y);
          }
        }
      }
    }
    if (last) {
      // Row (hi << Q) | m goes to (reversed m) << (lg_r - Q) | reversed hi.
      const uint32_t hi_rev = hi_bits == 0 ? 0 : reversed(hi, hi_bits);
      const uint32_t off0 = hi_rev * cols + c;
#pragma unroll
      for (int m = 0; m < kM; ++m) {
        const uint32_t off = off0 + reversed(m, Q) * out_pitch;
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
      for (int m = 0; m < kM; ++m) cell[m * pitch] = v[m];
    }
  }
}

// x, out: (batch, 2^lg_r, cols) row-major; block (bx, by) transforms the
// columns [bx * 2^lg_tc, (bx + 1) * 2^lg_tc) of batch entry by.  tw/tws:
// the 2^(lg_r - 1) powers of the column root and their Shoup companions.
// wm: (2^lg_r, cols), read only when kTwiddle.  smem: the twiddle pairs,
// then the tile.
// kLde (pass 1 of an LDE): x is (batch, T) coefficients, T = 2^lg_t, with
// the scale tables rows/cols (LdeInput).
template <bool kTwiddle, bool kLazy, bool kLde = false>
__device__ __forceinline__ void col_ntt(const uint32_t* __restrict__ x,
                                        uint32_t* __restrict__ out,
                                        const uint32_t* __restrict__ tw,
                                        const uint32_t* __restrict__ tws,
                                        const uint32_t* __restrict__ wm,
                                        int lg_r, int cols, int lg_tc,
                                        int pad_shift, uint32_t* smem,
                                        const uint2* __restrict__ rows = nullptr,
                                        const uint2* __restrict__ scols = nullptr,
                                        int lg_t = 0) {
  uint2* twd = reinterpret_cast<uint2*>(smem);
  uint32_t* tile = smem + (1 << lg_r);  // after the 2^(lg_r - 1) pairs
  const size_t c0 = (size_t)blockIdx.x << lg_tc;
  const size_t base = (size_t)blockIdx.y * ((size_t)cols << lg_r) + c0;
  LdeInput lde{rows, scols, (int)c0, 0};
  if (kLde) {
    x += ((size_t)blockIdx.y << lg_t) + c0;
    lde.limit = (1 << lg_t) - (int)c0;
  } else {
    x += base;
  }
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
        ntt_round<1, kTwiddle, kLazy, kLde>(x, out, wm, tw, tws, twd, tile, lg_r, cols,
                                            lg_tc, pad_shift, s0, first, last, lde);
        break;
      case 2:
        ntt_round<2, kTwiddle, kLazy, kLde>(x, out, wm, tw, tws, twd, tile, lg_r, cols,
                                            lg_tc, pad_shift, s0, first, last, lde);
        break;
      case 3:
        ntt_round<3, kTwiddle, kLazy, kLde>(x, out, wm, tw, tws, twd, tile, lg_r, cols,
                                            lg_tc, pad_shift, s0, first, last, lde);
        break;
      default:
        ntt_round<4, kTwiddle, kLazy, kLde>(x, out, wm, tw, tws, twd, tile, lg_r, cols,
                                            lg_tc, pad_shift, s0, first, last, lde);
    }
    s0 += q;
    if (!last) __syncthreads();
  }
}

// Tiles narrower than a warp: pad for the last round (see the head note).
int pad_shift_of(int lg_r, int lg_tc) {
  const Rounds rounds(lg_r);
  return rounds.count > 1 && lg_tc < 5
             ? rounds.stages(rounds.count - 1) + lg_tc
             : kNoPad;
}

// A column pass's grid and shared memory (its tile, padded, after the
// twiddle pairs), the attribute set past 48 KB; or an error code.
template <class Kernel>
int col_ntt_shape(Kernel kernel, int batch, int lg_r, int cols, int lg_tc,
                  int threads, dim3* grid, int* smem, int* pad_shift) {
  if (lg_r < 1 || lg_r > kMaxLgR || lg_tc < 0 || lg_r + lg_tc > 20 ||
      batch < 1 || cols < 1 || cols > (1 << (31 - lg_r)) ||
      (cols & ((1 << lg_tc) - 1)) || threads < 32 ||
      threads > kMaxThreads || threads % 32)
    return (int)cudaErrorInvalidValue;
  *pad_shift = pad_shift_of(lg_r, lg_tc);
  const long long words =
      (1LL << lg_r) + tile_word(1 << (lg_r + lg_tc), *pad_shift, lg_tc);
  if (words * 4 > kSmemMax) return (int)cudaErrorInvalidValue;
  *smem = (int)words * 4;
  if (*smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, *smem);
    if (err != cudaSuccess) return (int)err;
  }
  *grid = dim3((unsigned)(cols >> lg_tc), (unsigned)batch);
  return 0;
}

using ColNttKernel = void (*)(const uint32_t*, uint32_t*, const uint32_t*,
                              const uint32_t*, const uint32_t*, int, int, int,
                              int);

int launch_col_ntt(ColNttKernel kernel, const void* x, void* out,
                   const void* tw, const void* tws, const void* wm, int batch,
                   int lg_r, int cols, int lg_tc, int threads, void* stream) {
  dim3 grid;
  int smem = 0, pad_shift = 0;
  const int err = col_ntt_shape(kernel, batch, lg_r, cols, lg_tc, threads,
                                &grid, &smem, &pad_shift);
  if (err) return err;
  kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      static_cast<const uint32_t*>(x), static_cast<uint32_t*>(out),
      static_cast<const uint32_t*>(tw), static_cast<const uint32_t*>(tws),
      static_cast<const uint32_t*>(wm), lg_r, cols, lg_tc, pad_shift);
  return (int)cudaGetLastError();
}

using LdePassKernel = void (*)(const uint32_t*, uint32_t*, const uint32_t*,
                               const uint32_t*, const uint32_t*, const uint2*,
                               const uint2*, int, int, int, int, int);

// Pass 1 of an LDE: x (batch, 2^lg_t) coefficients, scale the (2^lg_r +
// cols) pairs of LdeInput's rows then cols.
int launch_lde_pass1(LdePassKernel kernel, const void* x, void* out,
                     const void* tw, const void* tws, const void* wm,
                     const void* scale, int batch, int lg_r, int cols,
                     int lg_tc, int threads, int lg_t, void* stream) {
  if (lg_t < 0 || (1LL << lg_t) > ((long long)cols << lg_r))
    return (int)cudaErrorInvalidValue;
  dim3 grid;
  int smem = 0, pad_shift = 0;
  const int err = col_ntt_shape(kernel, batch, lg_r, cols, lg_tc, threads,
                                &grid, &smem, &pad_shift);
  if (err) return err;
  const uint2* rows = static_cast<const uint2*>(scale);
  kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      static_cast<const uint32_t*>(x), static_cast<uint32_t*>(out),
      static_cast<const uint32_t*>(tw), static_cast<const uint32_t*>(tws),
      static_cast<const uint32_t*>(wm), rows, rows + (1 << lg_r), lg_r, cols,
      lg_tc, pad_shift, lg_t);
  return (int)cudaGetLastError();
}

// K3's two tile shapes (rows x columns of the input).
constexpr int kEdgeTile = 32;
constexpr int kVecTileRows = 32;
constexpr int kVecTileCols = 128;
constexpr int kVecThreads = 256;

// K14's block.
constexpr int kPadScaleThreads = 256;

}  // namespace

// The __global__ functions have C linkage so that a profile names them
// plainly (stark_*_kernel...); the host entries below launch them.
extern "C" {

#define STARK_COL_NTT_KERNEL(NAME, TWIDDLE, LAZY)                             \
  __global__ void __launch_bounds__(kMaxThreads)                              \
      NAME(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,        \
           const uint32_t* __restrict__ tw, const uint32_t* __restrict__ tws, \
           const uint32_t* __restrict__ wm, int lg_r, int cols, int lg_tc,    \
           int pad_shift) {                                                   \
    extern __shared__ uint4 smem[];                                           \
    col_ntt<TWIDDLE, LAZY>(x, out, tw, tws, wm, lg_r, cols, lg_tc, pad_shift, \
                           reinterpret_cast<uint32_t*>(smem));                \
  }

STARK_COL_NTT_KERNEL(stark_ntt_pass1_kernel, true, false)
STARK_COL_NTT_KERNEL(stark_ntt_pass1_lazy_kernel, true, true)
STARK_COL_NTT_KERNEL(stark_ntt_pass2_kernel, false, false)
STARK_COL_NTT_KERNEL(stark_ntt_pass2_lazy_kernel, false, true)

#undef STARK_COL_NTT_KERNEL

// Pass 1 of an LDE (K1 with K14's pad and scale in its first round).
#define STARK_LDE_PASS1_KERNEL(NAME, LAZY)                                     \
  __global__ void __launch_bounds__(kMaxThreads)                              \
      NAME(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,        \
           const uint32_t* __restrict__ tw, const uint32_t* __restrict__ tws, \
           const uint32_t* __restrict__ wm, const uint2* __restrict__ rows,   \
           const uint2* __restrict__ scols, int lg_r, int cols, int lg_tc,    \
           int pad_shift, int lg_t) {                                         \
    extern __shared__ uint4 smem[];                                           \
    col_ntt<true, LAZY, true>(x, out, tw, tws, wm, lg_r, cols, lg_tc,          \
                              pad_shift, reinterpret_cast<uint32_t*>(smem),   \
                              rows, scols, lg_t);                             \
  }

STARK_LDE_PASS1_KERNEL(stark_ntt_pass1_lde_kernel, false)
STARK_LDE_PASS1_KERNEL(stark_ntt_pass1_lde_lazy_kernel, true)

#undef STARK_LDE_PASS1_KERNEL

// K3, the vector route: (batch, rows, cols) -> (batch, cols, rows) with rows
// and cols multiples of 4 and x, out 16-byte aligned.  A thread reads a 4 x
// 4 block as four 16-byte loads down four rows, transposes it in its
// registers and writes four 16-byte stores down four rows of the output.
// Lanes 4 k .. 4 k + 3 of a warp sit side by side along the input's row
// (64 bytes) and lanes k, k + 4, ... along the output's (128 bytes); the
// eight warps of a block side by side along the input's row, so block (bx,
// by, bz) moves the tile of 32 rows by 128 columns at (32 by, 128 bx) of
// batch entry bz, and both directions move whole 128-byte lines.  No shared
// memory and no barrier, 64 bytes in flight per thread.
__global__ void __launch_bounds__(kVecThreads)
    stark_ntt_transpose_kernel(const uint32_t* __restrict__ x,
                               uint32_t* __restrict__ out, int rows,
                               int cols) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.y * kVecTileRows + ((lane >> 2) << 2);
  const int c = blockIdx.x * kVecTileCols +
                (((threadIdx.x >> 5) << 4) | ((lane & 3) << 2));
  if (r >= rows || c >= cols) return;
  const size_t base = (size_t)blockIdx.z * rows * cols;
  const size_t in_step = (size_t)(cols >> 2);  // a row, in uint4
  const size_t out_step = (size_t)(rows >> 2);
  const uint4* src =
      reinterpret_cast<const uint4*>(x + base + (size_t)r * cols + c);
  const uint4 a0 = src[0];
  const uint4 a1 = src[in_step];
  const uint4 a2 = src[2 * in_step];
  const uint4 a3 = src[3 * in_step];
  uint4* dst = reinterpret_cast<uint4*>(out + base + (size_t)c * rows + r);
  dst[0] = make_uint4(a0.x, a1.x, a2.x, a3.x);
  dst[out_step] = make_uint4(a0.y, a1.y, a2.y, a3.y);
  dst[2 * out_step] = make_uint4(a0.z, a1.z, a2.z, a3.z);
  dst[3 * out_step] = make_uint4(a0.w, a1.w, a2.w, a3.w);
}

// K3, any rows and cols: a padded 32 x 33 shared-memory tile, 4-byte loads
// and stores, both coalesced.
__global__ void stark_ntt_transpose_kernel_edge(const uint32_t* __restrict__ x,
                                                uint32_t* __restrict__ out,
                                                int rows, int cols) {
  __shared__ uint32_t tile[kEdgeTile][kEdgeTile + 1];
  const size_t base = (size_t)blockIdx.z * rows * cols;
  const int r0 = blockIdx.y * kEdgeTile;
  const int c0 = blockIdx.x * kEdgeTile;
  for (int i = threadIdx.y; i < kEdgeTile; i += blockDim.y) {
    const int r = r0 + i;
    const int c = c0 + threadIdx.x;
    if (r < rows && c < cols) tile[i][threadIdx.x] = x[base + (size_t)r * cols + c];
  }
  __syncthreads();
  for (int i = threadIdx.y; i < kEdgeTile; i += blockDim.y) {
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

// K1 of an LDE: the column NTTs of (batch, 2^lg_r, cols) rows whose first
// T = 2^lg_t elements are an entry's coefficients x (batch, T) times s^e,
// the rest zeros, times wm; `scale`: LdeInput's tables, 2^lg_r + cols pairs.
int stark_ntt_pass1_lde(const void* x, void* out, const void* tw,
                        const void* tws, const void* wm, const void* scale,
                        int batch, int lg_r, int cols, int lg_tc, int threads,
                        int lg_t, void* stream) {
  return launch_lde_pass1(stark_ntt_pass1_lde_kernel, x, out, tw, tws, wm,
                          scale, batch, lg_r, cols, lg_tc, threads, lg_t,
                          stream);
}

// The same, lazy butterflies: the same function, bit for bit.
int stark_ntt_pass1_lde_lazy(const void* x, void* out, const void* tw,
                             const void* tws, const void* wm,
                             const void* scale, int batch, int lg_r, int cols,
                             int lg_tc, int threads, int lg_t, void* stream) {
  return launch_lde_pass1(stark_ntt_pass1_lde_lazy_kernel, x, out, tw, tws,
                          wm, scale, batch, lg_r, cols, lg_tc, threads, lg_t,
                          stream);
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

// K3: (batch, rows, cols) -> (batch, cols, rows), a block per tile on the
// vector route (`vector` != 0) or on the edge route.
int stark_ntt_transpose(const void* x, void* out, int batch, int rows,
                        int cols, int vector, void* stream) {
  if (batch < 1 || rows < 1 || cols < 1) return (int)cudaErrorInvalidValue;
  const int tile_r = vector ? kVecTileRows : kEdgeTile;
  const int tile_c = vector ? kVecTileCols : kEdgeTile;
  const dim3 grid((unsigned)((cols + tile_c - 1) / tile_c),
                  (unsigned)((rows + tile_r - 1) / tile_r), (unsigned)batch);
  if (grid.y > 65535 || grid.z > 65535) return (int)cudaErrorInvalidValue;
  if (!vector) {
    stark_ntt_transpose_kernel_edge<<<grid, dim3(kEdgeTile, 8), 0,
                                      (cudaStream_t)stream>>>(
        static_cast<const uint32_t*>(x), static_cast<uint32_t*>(out), rows,
        cols);
    return (int)cudaGetLastError();
  }
  if (rows % 4 || cols % 4) return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 16)
    return (int)cudaErrorMisalignedAddress;
  stark_ntt_transpose_kernel<<<grid, kVecThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const uint32_t*>(x), static_cast<uint32_t*>(out), rows,
      cols);
  return (int)cudaGetLastError();
}

// K14 (see the head of the file): one 16-byte word of the output a thread,
// T a multiple of 4.  `pw` is the table's first row (s^k), `pws` its
// second (the Shoup companions).
__global__ void __launch_bounds__(kPadScaleThreads)
    stark_lde_pad_scale_kernel(const uint32_t* __restrict__ x,
                               uint32_t* __restrict__ out,
                               const uint32_t* __restrict__ pw,
                               const uint32_t* __restrict__ pws, int lg_t,
                               int lg_n, size_t words) {
  const size_t v = (size_t)blockIdx.x * kPadScaleThreads + threadIdx.x;
  if (v >= words) return;
  const size_t e = v << 2;
  const uint32_t k = (uint32_t)(e & (((size_t)1 << lg_n) - 1));
  uint4 y = make_uint4(0u, 0u, 0u, 0u);
  if (k < (1u << lg_t)) {
    const size_t src = ((e >> lg_n) << lg_t) + k;
    const uint4 c = *reinterpret_cast<const uint4*>(x + src);
    const uint4 w = *reinterpret_cast<const uint4*>(pw + k);
    const uint4 ws = *reinterpret_cast<const uint4*>(pws + k);
    y = make_uint4(stark::shoup_mul(c.x, w.x, ws.x),
                   stark::shoup_mul(c.y, w.y, ws.y),
                   stark::shoup_mul(c.z, w.z, ws.z),
                   stark::shoup_mul(c.w, w.w, ws.w));
  }
  reinterpret_cast<uint4*>(out)[v] = y;
}

// K14's edge route: one element a thread, for T of 1 or 2.
__global__ void stark_lde_pad_scale_kernel_edge(
    const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
    const uint32_t* __restrict__ pw, const uint32_t* __restrict__ pws,
    int lg_t, int lg_n, size_t total) {
  const size_t e = (size_t)blockIdx.x * kPadScaleThreads + threadIdx.x;
  if (e >= total) return;
  const uint32_t k = (uint32_t)(e & (((size_t)1 << lg_n) - 1));
  out[e] = k < (1u << lg_t)
               ? stark::shoup_mul(x[((e >> lg_n) << lg_t) + k], pw[k], pws[k])
               : 0u;
}

// K14: (rows, 2^lg_t) -> (rows, 2^lg_n) zero-padded and scaled by the powers
// in `table`, a (2, 2^lg_t) array: s^k, then the Shoup companions.
int stark_lde_pad_scale(const void* x, void* out, const void* table, int rows,
                        int lg_t, int lg_n, void* stream) {
  if (rows < 1 || lg_t < 0 || lg_t > lg_n || lg_n > 30)
    return (int)cudaErrorInvalidValue;
  const uint32_t* pw = static_cast<const uint32_t*>(table);
  const uint32_t* pws = pw + ((size_t)1 << lg_t);
  const size_t total = (size_t)rows << lg_n;
  if (lg_t < 2) {
    stark_lde_pad_scale_kernel_edge<<<(unsigned)((total + kPadScaleThreads - 1) /
                                                 kPadScaleThreads),
                                      kPadScaleThreads, 0, (cudaStream_t)stream>>>(
        static_cast<const uint32_t*>(x), static_cast<uint32_t*>(out), pw, pws,
        lg_t, lg_n, total);
    return (int)cudaGetLastError();
  }
  if (reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 16 ||
      reinterpret_cast<uintptr_t>(pw) % 16)
    return (int)cudaErrorMisalignedAddress;
  const size_t words = total >> 2;
  stark_lde_pad_scale_kernel<<<(unsigned)((words + kPadScaleThreads - 1) /
                                          kPadScaleThreads),
                               kPadScaleThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const uint32_t*>(x), static_cast<uint32_t*>(out), pw, pws,
      lg_t, lg_n, words);
  return (int)cudaGetLastError();
}

const char* stark_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
