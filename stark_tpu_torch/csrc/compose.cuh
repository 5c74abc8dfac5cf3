// K11: the composition codeword, one thread a point of the coset, for B
// proofs at once: the AIR-independent part.  It replaces
// stark_tpu/stark.py::StarkProver._compose_impl (:570-616), which
// stark_tpu/batch.py vmaps over (B, c, N) (:554-559).
//
// An AIR's transition constraints are user code, written once against an
// op namespace (models/air.py); ops/compose.py records them as a
// straight-line tape and generates, per AIR, a source that defines
//   struct Air {
//     kTransitions, kBoundaries, kRows, kTerms, kTable = false,
//     boundary_row(j) (the index of boundary j's row among the distinct
//     rows),
//     values(at, c, v): the transition constraints c[k] at one point from
//       the frame loads at(offset, register), and v[j] the register that
//       boundary j reads, at offset 0;
//   };
// (the straight-line form), or, for an AIR too large for that, the same
// constants, kTable = true, kSteps, kSlots, kThreads and the tables that
// compose_points_table runs (the table form, Step below);
// then includes this header's STARK_COMPOSE_ENTRY(Air).  Built with nvcc it
// is the kernel with its C entry stark_compose; built with a host C++
// compiler (field.cuh's host branch) it is stark_compose_host, the same
// per-point function in a loop over every point, for the CPU tests.  Both
// take the LDE's row stride `span`: span = n, the whole coset, its frame
// reads wrapping modulo n; or span > n, a rank's share of the coset in the
// sharded prover (parallel/pstark.py), each row its n points and then the
// next share's first points (the halo), read without a wrap.  The
// boundary constraints' values are data, not code: a (B, kBoundaries) row
// of words a proof in device memory (`values`), the statement's public
// inputs, so that one build of an AIR (and one CUDA graph a slot) serves
// every statement of a shape; the rows and registers they constrain are
// the AIR's shape and fix the dinv tables.
//
// At point i of proof b, with x the coset point, the codeword is
//   sum_k C_k(frame) exz(x) (a_k xt(x) + b_k)
//   + sum_j (lde_reg_j(x) - value_bj) dinv_row_j(x) (a_j xb(x) + b_j),
// exz = excl zinv the transition zerofier's factor, xt and xb the degree
// shifts x^s_t and x^s_b, dinv_r = 1 / (x - w^r), each an (N,) table of
// canonical values made once per prover.  It is computed as
//   exz (xt sum_k a_k C_k + sum_k b_k C_k)
//   + sum_rows dinv_r (xb sum_{j on r} a_j d_j + sum_{j on r} b_j d_j):
// per term two Shoup products by the proof's weights, per table one
// Montgomery product.  The weights come premultiplied (a R^2 and b R, R =
// 2^32 mod p, each with its Shoup companion), so that the Montgomery
// products' factors R^-1 cancel and every value stays exact: the result
// equals the eager version's bit for bit.  They lie in device memory: on
// the single-fetch prove K15 (hash.cu stark_constraint_challenges) writes
// them there from the challenges it draws, so that no host step comes
// between the trace root and the codeword; where the host draws the
// challenges, ops/compose.py uploads the same words.
//
// What bounds it: bytes where the AIR is narrow (Fibonacci at N = 2^22:
// one read of the LDE and of five tables, one write), operations where its
// constraints are many (MdsSquareAir: 8 constraints of 8 products each).
// One thread a point, loads coalesced along N, every load of a point
// issued before its arithmetic (the generated body loads first), the
// weights read by every thread of a block at the same addresses (one
// load each, served to the block at once).  Where the
// constraints sum products by constants, the generated body sums them
// lazily in 64 bits (Lazy sums below; ops/compose.py generate_source): a
// multiply-add a product, one reduction a sum.
// The table form (an AIR whose straight-line body nvcc would take minutes
// over) is bound by its steps: each costs a warp its decode, a dispatch
// and its slot traffic besides the arithmetic of its 4 points, and a
// small grid (N = 2^18: 1,024 blocks of 64) gives each scheduler few warps
// to hide that latency with (PERF.md §6: 0.4 of its operations bound
// at 1,024 and 3,632 distinct constraints on an H100 80GB HBM3 at 700 W).
// Timed against it and not kept (tools/tune_kernels.py compose turns):
// the form before (a slot a step in local memory, 3.2 times slower there)
// and the straight-line form cut into __noinline__ pieces (1.4-1.5 times
// slower there, and 80 s of nvcc at 3,632).
// Tried on an H100 and not kept (PERF.md; tools/tune_kernels.py
// compose_coset rebuilds it): exz, x^s_t and x^s_b computed in the kernel
// from small tables and stepped from point to point, so that only the LDE
// and the dinv rows are read (64 MiB against 112 at Fibonacci T=2^20).
// The kernel is not bound by its bytes alone there: on an H100 it ran at
// 47.3-47.9 us against 39.9-40.4 for the design before lazy sums, and at
// batch8's (8, 1, 2^16) at 8.6-8.9 against 5.6-6.1.
#pragma once

#include <stdint.h>

#include "field.cuh"

namespace stark {

// R = 2^32 mod p and its Shoup companion: a Montgomery product times R.
constexpr uint32_t kR1 = (uint32_t)((1ull << 32) % kP);
constexpr uint32_t kR1Shoup = (uint32_t)(((uint64_t)kR1 << 32) / kP);

// a b mod p for a, b in [0, p): the Montgomery product a b R^-1, times R.
__device__ __forceinline__ uint32_t mul_mod(uint32_t a, uint32_t b) {
  return shoup_mul(mont_mul(a, b), kR1, kR1Shoup);
}

// Lazy sums.  A term is a canonical value times a constant in [0, p), a
// 64-bit product below p^2 < 2^60; kLazyTerms of them stay below 2^64.  A
// longer sum folds (fold64) every so often; a folded sum counts as
// kFoldTerms terms.  The generated body writes each coefficient c as c R
// mod p, so that reduce64's 2^-32 takes R back and the sum is exact.
constexpr int kLazyTerms = 16;
constexpr int kFoldTerms = 2;
static_assert((uint64_t)(kP - 1) * (kP - 1) <= ~0ull / kLazyTerms,
              "kLazyTerms products of values below p fit in 64 bits");
static_assert(((1ull << 32) - 1) * kR1 + (1ull << 32) <= 2ull * (kP - 1) * (kP - 1),
              "a folded sum counts as kFoldTerms products");

// x = hi 2^32 + lo < 2^64 -> hi R + lo: the same value mod p, below 2^32 R
// + 2^32 < 2 p^2 (and < 2^61).
__device__ __forceinline__ uint64_t fold64(uint64_t x) {
  return (uint64_t)(uint32_t)(x >> 32) * kR1 + (uint32_t)x;
}

// x 2^-32 mod p, canonical, for x < 2^64: fold, then Montgomery's
// reduction of y = fold(x) < 2^61 (u = y_hi + (m p)_hi + carry < 2^29 + p
// + 2 < 2p: one correction).
__device__ __forceinline__ uint32_t reduce64(uint64_t x) {
  const uint64_t y = fold64(x);
  const uint32_t lo = (uint32_t)y;
  const uint32_t m = lo * kPinvNeg;
  return reduce_once((uint32_t)(y >> 32) + __umulhi(m, kP) + (lo != 0u ? 1u : 0u));
}

// The frame of one point: register r at offset k is element (i + k blowup)
// & mask of row r of this proof's LDE, a row every `span` words: mask = n -
// 1 on the whole coset (span = n, the wrap), all ones on a share with its
// halo (span > n).
struct Frame {
  const uint32_t* lde;
  long long span;
  long long mask;
  long long i;
  int blowup;
  __device__ __forceinline__ uint32_t operator()(int offset, int reg) const {
    return lde[reg * span + ((i + (long long)offset * blowup) & mask)];
  }
};

struct ComposeArgs {
  const uint32_t* lde;   // (B, c, span)
  const uint32_t* exz;   // (n,) excl * zinv
  const uint32_t* xt;    // (n,) x^s_t
  const uint32_t* xb;    // (n,) x^s_b
  const uint32_t* dinv;  // (rows, n) 1 / (x - w^row), a row per distinct row
  uint32_t* out;         // (B, n)
  long long n;
  int c;
  int blowup;
  int proofs;
  long long span;        // a row's words: n, or n and the halo
  long long mask;        // n - 1 where span = n, else ~0 (no wrap)
  const uint32_t* values;  // (B, kBoundaries) each proof's boundary values
};

// The mask of a row of `span` words holding n points (Frame).
inline long long frame_mask(long long n, long long span) {
  return span == n ? n - 1 : ~0ll;
}

// Whether (n, span) is a row K11 reads: the whole coset (n a power of two)
// or a share with a halo behind it.
inline bool frame_ok(long long n, long long span) {
  return n >= 1 && (span == n ? (n & (n - 1)) == 0 : span > n);
}

// Alignment of a struct that the card loads in one access; a host compiler
// takes the structs as they come.
#ifdef __CUDACC__
#define STARK_ALIGN(n) alignas(n)
#else
#define STARK_ALIGN(n)
#endif

// One term's weight words: a R^2, its companion, b R, its companion.  A
// term is one 16-byte load on the card (the weights lie in device memory,
// 16-byte aligned), where four 4-byte loads cost each thread four times
// the instructions.
struct STARK_ALIGN(16) Weight {
  uint32_t a, a_shoup, b, b_shoup;
};

// An AIR in the table form (ops/compose.py generate_table_source; the
// straight-line form of a large AIR takes nvcc minutes): a compact
// interpreter.  Its tape is a stream of 8-byte steps that a rolled loop
// runs for kTablePoints points a thread at once, so that one decode of a
// step serves the arithmetic of every point.  A step reads at most two
// slots and writes one, or, flagged kStepOut, adds its value as transition
// term `dst` into the weighted sums at once (no constraint stays live).
// The generator gives slots out by liveness, a slot freed after its last
// reader, so a point needs the width of the tape's live set, not its
// length; the slots lie in shared memory, slot q of thread t at q
// kThreads + t, a 16-byte word of the thread's points: a warp's access is
// 512 consecutive bytes, no two lanes on one bank.  The stream and its
// constants are device memory that every thread of a block reads at the
// same address (one load a warp), the next step loaded while this one
// computes.
enum StepOp : uint32_t {
  kStepIn,     // dst = the frame at offset a (int16), register b
  kStepConst,  // dst = constant b
  kStepAdd,    // dst = a + b
  kStepSub,    // dst = a - b
  kStepNeg,    // dst = -a
  kStepMulC,   // dst = a times constant b (a Shoup product)
  kStepMul,    // dst = a b
  kStepCopy,   // dst = a (with kStepOut: slot a is transition term dst)
  kStepOut = 8,
};
// op | dst << 16 and a | b << 16: one 8-byte load.
struct STARK_ALIGN(8) Step {
  uint32_t op_dst, a_b;
};
// A constant and its Shoup companion.
struct STARK_ALIGN(8) Constant {
  uint32_t k, k_shoup;
};
// Boundary constraint `term` (among the boundaries): register `reg` at
// offset 0 minus the proof's value `term` (ComposeArgs::values).
struct BoundaryTerm {
  uint32_t term, reg;
};

constexpr int kTablePoints = 4;
// A slot of one thread: its points' values, one 16-byte access.
struct STARK_ALIGN(16) Lanes {
  uint32_t v[kTablePoints];
};

// The codeword at points i[0..kTablePoints) of proof b, the table form:
// the same values and sums as the straight-line form.  `s`: this thread's
// slot 0, slot q at s[q stride].  Points past n (a block's ragged end)
// compute point 0's values; the caller drops them.
template <class Air>
__device__ __forceinline__ void compose_points_table(const ComposeArgs& a,
                                                     const Weight* w, int b,
                                                     const long long (&i)[kTablePoints],
                                                     Lanes* s, int stride,
                                                     uint32_t (&total)[kTablePoints]) {
  constexpr int kP = kTablePoints;
  const uint32_t* lde = a.lde + (long long)b * a.c * a.span;
  // The frame value at `offset` of register `reg` for point j.
  auto frame = [&](int j, int offset, int reg) {
    return lde[reg * a.span + ((i[j] + (long long)offset * a.blowup) & a.mask)];
  };
#pragma unroll
  for (int j = 0; j < kP; ++j) total[j] = 0;
  if constexpr (Air::kTransitions > 0) {
    // The weighted sums, lazy in 64 bits: a term's value times its weight
    // word (a R^2 or b R) added whole, folded every kLazyTerms terms;
    // reduce64 takes R once, shoup_mul by R puts it back (below).
    uint64_t sa[kP], sb[kP];
    int terms = 0;
#pragma unroll
    for (int j = 0; j < kP; ++j) sa[j] = sb[j] = 0;
    const Step* steps = Air::steps();
    const Constant* consts = Air::constants();
    Step next = steps[0];  // the stream ends with a spare step
#pragma unroll 1
    for (int q = 0; q < Air::kSteps; ++q) {
      const Step t = next;
      next = steps[q + 1];
      const uint32_t op = t.op_dst & 0xffffu, dst = t.op_dst >> 16;
      const uint32_t ia = t.a_b & 0xffffu, ib = t.a_b >> 16;
      // The step's constant and weight words, loaded before its operands
      // are decoded and computed, so that their latency overlaps it.
      Constant kc{0u, 0u};
      if ((op & (kStepOut - 1)) == kStepMulC || (op & (kStepOut - 1)) == kStepConst)
        kc = consts[ib];
      uint32_t wa = 0u, wb = 0u;
      if (op & kStepOut) {
        wa = w[dst].a;
        wb = w[dst].b;
      }
      Lanes x;
      switch (op & (kStepOut - 1)) {
        case kStepIn:
#pragma unroll
          for (int j = 0; j < kP; ++j) x.v[j] = frame(j, (int16_t)ia, (int)ib);
          break;
        case kStepConst: {
#pragma unroll
          for (int j = 0; j < kP; ++j) x.v[j] = kc.k;
          break;
        }
        case kStepAdd: {
          const Lanes u = s[ia * stride], v = s[ib * stride];
#pragma unroll
          for (int j = 0; j < kP; ++j) x.v[j] = add_mod(u.v[j], v.v[j]);
          break;
        }
        case kStepSub: {
          const Lanes u = s[ia * stride], v = s[ib * stride];
#pragma unroll
          for (int j = 0; j < kP; ++j) x.v[j] = sub_mod(u.v[j], v.v[j]);
          break;
        }
        case kStepNeg: {
          const Lanes u = s[ia * stride];
#pragma unroll
          for (int j = 0; j < kP; ++j) x.v[j] = sub_mod(0u, u.v[j]);
          break;
        }
        case kStepMulC: {
          const Lanes u = s[ia * stride];
#pragma unroll
          for (int j = 0; j < kP; ++j) x.v[j] = shoup_mul(u.v[j], kc.k, kc.k_shoup);
          break;
        }
        case kStepMul: {
          const Lanes u = s[ia * stride], v = s[ib * stride];
#pragma unroll
          for (int j = 0; j < kP; ++j) x.v[j] = mul_mod(u.v[j], v.v[j]);
          break;
        }
        default:
          x = s[ia * stride];
      }
      if (op & kStepOut) {
        if (terms == kLazyTerms) {
#pragma unroll
          for (int j = 0; j < kP; ++j) {
            sa[j] = fold64(sa[j]);
            sb[j] = fold64(sb[j]);
          }
          terms = kFoldTerms;
        }
#pragma unroll
        for (int j = 0; j < kP; ++j) {
          sa[j] += (uint64_t)x.v[j] * wa;
          sb[j] += (uint64_t)x.v[j] * wb;
        }
        ++terms;
      } else {
        s[dst * stride] = x;
      }
    }
#pragma unroll
    for (int j = 0; j < kP; ++j) {
      const uint32_t ra = shoup_mul(reduce64(sa[j]), kR1, kR1Shoup);
      const uint32_t rb = shoup_mul(reduce64(sb[j]), kR1, kR1Shoup);
      total[j] = mont_mul(a.exz[i[j]], add_mod(mont_mul(a.xt[i[j]], ra), rb));
    }
  }
  if constexpr (Air::kBoundaries > 0) {
    const BoundaryTerm* terms = Air::boundaries();
    const int* ends = Air::row_ends();
    const uint32_t* bvals = a.values + (long long)b * Air::kBoundaries;
    int jt = 0;
#pragma unroll 1
    for (int r = 0; r < Air::kRows; ++r) {
      uint32_t sa[kP], sb[kP];
#pragma unroll
      for (int j = 0; j < kP; ++j) sa[j] = sb[j] = 0;
#pragma unroll 1
      for (; jt < ends[r]; ++jt) {
        const BoundaryTerm t = terms[jt];
        const Weight wt = w[Air::kTransitions + t.term];
#pragma unroll
        for (int j = 0; j < kP; ++j) {
          const uint32_t d = sub_open(frame(j, 0, (int)t.reg), bvals[t.term]);  // (0, 2p)
          sa[j] = add_mod(sa[j], shoup_mul(d, wt.a, wt.a_shoup));
          sb[j] = add_mod(sb[j], shoup_mul(d, wt.b, wt.b_shoup));
        }
      }
#pragma unroll
      for (int j = 0; j < kP; ++j)
        total[j] = add_mod(total[j], mont_mul(a.dinv[r * a.n + i[j]],
                                              add_mod(mont_mul(a.xb[i[j]], sa[j]), sb[j])));
    }
  }
}

// The codeword at point i of proof b, the straight-line form; w: the
// proof's kTerms weights.
template <class Air>
__device__ __forceinline__ uint32_t compose_point(const ComposeArgs& a,
                                                  const Weight* w, int b,
                                                  long long i) {
  const Frame at{a.lde + (long long)b * a.c * a.span, a.span, a.mask, i, a.blowup};
  uint32_t c[Air::kTransitions > 0 ? Air::kTransitions : 1];
  uint32_t v[Air::kBoundaries > 0 ? Air::kBoundaries : 1];
  Air::values(at, c, v);
  uint32_t total = 0;
  if (Air::kTransitions > 0) {
    uint32_t sa = 0, sb = 0;
#pragma unroll
    for (int k = 0; k < Air::kTransitions; ++k) {
      const Weight wk = w[k];
      sa = add_mod(sa, shoup_mul(c[k], wk.a, wk.a_shoup));
      sb = add_mod(sb, shoup_mul(c[k], wk.b, wk.b_shoup));
    }
    total = mont_mul(a.exz[i], add_mod(mont_mul(a.xt[i], sa), sb));
  }
  if (Air::kBoundaries > 0) {
    const uint32_t xb = a.xb[i];
    // The proof's boundary values: the same words for every thread of the
    // block, one load each.
    const uint32_t* bvals = a.values + (long long)b * Air::kBoundaries;
#pragma unroll
    for (int r = 0; r < Air::kRows; ++r) {
      uint32_t sa = 0, sb = 0;
#pragma unroll
      for (int j = 0; j < Air::kBoundaries; ++j) {
        if (Air::boundary_row(j) != r) continue;
        const uint32_t d = sub_open(v[j], bvals[j]);  // (0, 2p)
        const Weight wj = w[Air::kTransitions + j];
        sa = add_mod(sa, shoup_mul(d, wj.a, wj.a_shoup));
        sb = add_mod(sb, shoup_mul(d, wj.b, wj.b_shoup));
      }
      total = add_mod(total, mont_mul(a.dinv[r * a.n + i],
                                      add_mod(mont_mul(xb, sa), sb)));
    }
  }
  return total;
}

// A block's threads and a thread's points: the straight-line form one
// point a thread, the table form kTablePoints (its threads chosen by the
// generator, so that the block's slots fit its shared memory).
template <class Air, bool = Air::kTable>
struct ComposeShape {
  static constexpr int kThreads = 256, kPoints = 1;
};
template <class Air>
struct ComposeShape<Air, true> {
  static constexpr int kThreads = Air::kThreads, kPoints = kTablePoints;
};

// The table form's points of thread t of block x: x kThreads kPoints + t +
// j kThreads, coalesced along N for each j; a point past n is computed as
// point 0 (`inside` false) and not stored.
template <class Air>
__device__ __forceinline__ void table_points(long long first, long long n, int t,
                                             long long (&i)[kTablePoints],
                                             bool (&inside)[kTablePoints]) {
#pragma unroll
  for (int j = 0; j < kTablePoints; ++j) {
    const long long p = first + t + (long long)j * Air::kThreads;
    inside[j] = p < n;
    i[j] = inside[j] ? p : 0;
  }
}

}  // namespace stark

#ifdef __CUDACC__
#include <cuda_runtime.h>

namespace stark {

// w: the weights of every proof of the launch, kTerms a proof.  The table
// form's slots: dynamic shared memory, kSlots kThreads Lanes.
template <class Air>
__global__ void __launch_bounds__(ComposeShape<Air>::kThreads)
    stark_compose_kernel(const __grid_constant__ ComposeArgs a,
                         const Weight* __restrict__ w) {
  const int b = blockIdx.y;
  if constexpr (Air::kTable) {
    extern __shared__ uint4 smem[];
    long long i[kTablePoints];
    bool inside[kTablePoints];
    table_points<Air>((long long)blockIdx.x * Air::kThreads * kTablePoints, a.n,
                      threadIdx.x, i, inside);
    uint32_t total[kTablePoints];
    compose_points_table<Air>(a, w + Air::kTerms * b, b, i,
                              reinterpret_cast<Lanes*>(smem) + threadIdx.x,
                              Air::kThreads, total);
#pragma unroll
    for (int j = 0; j < kTablePoints; ++j)
      if (inside[j]) a.out[(long long)b * a.n + i[j]] = total[j];
  } else {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= a.n) return;
    a.out[(long long)b * a.n + i] = compose_point<Air>(a, w + Air::kTerms * b, b, i);
  }
}

// Launch K11 for AIR: its grid, and the table form's shared memory (past
// 48 KB after the opt-in attribute, set once a device).
template <class Air>
int launch_compose(const ComposeArgs& a, const Weight* w, cudaStream_t stream) {
  using Shape = ComposeShape<Air>;
  const long long per_block = (long long)Shape::kThreads * Shape::kPoints;
  const dim3 grid((unsigned)((a.n + per_block - 1) / per_block), (unsigned)a.proofs);
  int smem = 0;
  if constexpr (Air::kTable) {
    smem = Air::kSlots * Air::kThreads * (int)sizeof(Lanes);
    if (smem > 48 * 1024) {
      static int ready = -1;  // the device the attribute was set for
      int device = 0;
      cudaError_t err = cudaGetDevice(&device);
      if (err == cudaSuccess && device != ready) {
        err = cudaFuncSetAttribute(stark_compose_kernel<Air>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (err == cudaSuccess) ready = device;
      }
      if (err != cudaSuccess) return (int)err;
    }
  }
  stark_compose_kernel<Air><<<grid, Shape::kThreads, smem, stream>>>(a, w);
  return (int)cudaGetLastError();
}

}  // namespace stark

// The C entry of one AIR's library: B = proofs proofs' (c, span) LDEs of n
// points each (frame_ok), their nwords = 4 kTerms B weight words in device
// memory at `words`, 16-byte aligned, and their B kBoundaries boundary
// values at `values`, a row a proof.
#define STARK_COMPOSE_ENTRY(AIR)                                              \
  extern "C" int stark_compose(const void* lde, const void* exz,             \
                               const void* xt, const void* xb,               \
                               const void* dinv, void* out, long long n,     \
                               int c, int blowup, int proofs,                \
                               const void* words, int nwords, long long span,\
                               const void* values, void* stream) {           \
    const stark::ComposeArgs a{                                               \
        static_cast<const uint32_t*>(lde), static_cast<const uint32_t*>(exz), \
        static_cast<const uint32_t*>(xt),  static_cast<const uint32_t*>(xb),  \
        static_cast<const uint32_t*>(dinv), static_cast<uint32_t*>(out),      \
        n, c, blowup, proofs, span, stark::frame_mask(n, span),               \
        static_cast<const uint32_t*>(values)};                                \
    if (!stark::frame_ok(n, span) || c != AIR::kRegisters || proofs < 1 ||    \
        proofs > 65535 || nwords != 4 * AIR::kTerms * proofs)                 \
      return (int)cudaErrorInvalidValue;                                      \
    if (reinterpret_cast<uintptr_t>(words) & 15)                              \
      return (int)cudaErrorMisalignedAddress;                                 \
    return stark::launch_compose<AIR>(a, static_cast<const stark::Weight*>(words), \
                                      static_cast<cudaStream_t>(stream));     \
  }                                                                           \
  extern "C" const char* stark_cuda_error_string(int code) {                  \
    return cudaGetErrorString(static_cast<cudaError_t>(code));                \
  }

#else  // a host compiler

namespace stark {

// The per-point function at every point of every proof, as the kernel
// computes it: the table form kTablePoints points at a time, as one
// thread of one block does, its slots in an array of its own.
template <class Air>
void compose_host(const ComposeArgs& a, const Weight* w) {
  for (int b = 0; b < a.proofs; ++b) {
    if constexpr (Air::kTable) {
      static Lanes s[Air::kSlots > 0 ? Air::kSlots : 1];
      for (long long first = 0; first < a.n;
           first += (long long)Air::kThreads * kTablePoints) {
        for (int t = 0; t < Air::kThreads; ++t) {
          long long i[kTablePoints];
          bool inside[kTablePoints];
          table_points<Air>(first, a.n, t, i, inside);
          uint32_t total[kTablePoints];
          compose_points_table<Air>(a, w + Air::kTerms * b, b, i, s, 1, total);
          for (int j = 0; j < kTablePoints; ++j)
            if (inside[j]) a.out[(long long)b * a.n + i[j]] = total[j];
        }
      }
    } else {
      for (long long i = 0; i < a.n; ++i)
        a.out[(long long)b * a.n + i] = compose_point<Air>(a, w + Air::kTerms * b, b, i);
    }
  }
}

}  // namespace stark

#define STARK_COMPOSE_ENTRY(AIR)                                              \
  extern "C" int stark_compose_host(const uint32_t* lde, const uint32_t* exz, \
                                    const uint32_t* xt, const uint32_t* xb,   \
                                    const uint32_t* dinv, uint32_t* out,      \
                                    long long n, int c, int blowup,           \
                                    int proofs, const uint32_t* words,        \
                                    long long span, const uint32_t* values) { \
    const stark::ComposeArgs a{lde, exz, xt, xb, dinv, out, n, c, blowup,     \
                               proofs, span, stark::frame_mask(n, span),      \
                               values};                                       \
    if (c != AIR::kRegisters || !stark::frame_ok(n, span)) return 1;          \
    stark::compose_host<AIR>(a, reinterpret_cast<const stark::Weight*>(words)); \
    return 0;                                                                 \
  }

#endif
