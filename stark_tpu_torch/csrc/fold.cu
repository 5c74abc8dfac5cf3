// FRI fold for Hopper: kernel K4, and K4-dyn, its twin that draws each
// codeword row's challenge itself.  K4 replaces the Pallas kernel of the
// JAX package, stark_tpu/ops/pallas_kernels.py: fold_pallas (:87, call
// :104, body _fold_body :46), the same math as stark_tpu/fri.py:_fold_kernel
// (:70):
//
//   folded[i] = 2^-1 * ((a + b) + alpha * x_i^-1 * (a - b))  mod p,
//   a = codeword[i], b = codeword[i + half],
//
// with x_i^-1 given in Montgomery form (FriPlan.inv_x_mont): one Shoup
// multiply by alpha keeps it in Montgomery form, one REDC by (a - b) lands
// in standard form, and a Shoup multiply by 2^-1 finishes.  The TPU kernel's
// (512, 128) VMEM tiling is a Mosaic layout device; here a grid-stride loop
// covers any length.  What bounds K4: 16 bytes of device-memory traffic
// per output element (a, b, x^-1 read, one write) for ~10 integer
// multiplies - memory; at half = 2^21 that is 32 MB, ~10 us at the H100
// SXM's published 3.35 TB/s (700 W).
//
// K4-dyn (stark_fri_fold_dyn) is one round of the device-chained FRI
// commit for B codewords, (B, 2 half) -> (B, half): row r's Merkle root is
// absorbed into its Fiat-Shamir sponge, the challenge is drawn from it and
// the row is folded with it, in one launch.  It replaces
// stark_tpu/fri.py:_fold_kernel_dynamic (:85-94) together with the sponge
// and fold part of the JAX package's fused commit round, _commit_round_fn
// (fri.py:98-126) and, for a batch, _batch_round_fn (batch.py:503-527)
// (root absorb, sponge_state, state_alpha, fold).  The challenge has no
// Shoup companion, so alpha is taken to Montgomery form (alpha 2^32 mod p,
// one Montgomery product by 2^64 mod p) and the fold then runs as K4's;
// the result is the same canonical value as the JAX function's Montgomery
// product and full multiply mod p.
//
// What bounds K4-dyn: bytes at the large halves (12 bytes a row's element
// and the 4 of x^-1 that every row shares), and at the small ones the
// chain of the challenge: one thread's loads of its sponge and root, the
// root's absorb and the 8 closing mixes, ~2.7 us on an H100 (hash.cuh
// sponge_lane), after the launch.  The design:
//   - every block draws its row's challenge itself, one thread, and puts
//     alpha in shared memory: no block waits for another, and no launch
//     of its own (K9) runs before the fold.  Block 0 of a row alone writes
//     the row's new sponge state, pending tail, root copy and alpha, into
//     buffers other than those it reads (the row's other blocks read the
//     old state while it writes);
//   - the redundant chains cost one thread a block, so the grid is one
//     resident wave (at most the SMs times the blocks an SM holds, rows on
//     blockIdx.y) and each thread walks its share with a grid-stride loop:
//     a block of a second wave would pay the chain again after the first;
//   - device memory streams while the chain runs: each thread keeps
//     kFoldStages steps (4 elements a step, 16-byte words of a, b and
//     x^-1) in flight, staged in shared memory by cp.async into slots of
//     its own (no barrier between its copies and its reads), and the
//     first kFoldStages are requested before the chain.  The chain's own
//     loads go out first, a barrier before the block's: queued behind
//     them they waited for the block's bytes (half 2^18 on an H100: 6.5
//     us against 5.6-5.7, tools/tune_kernels.py --only fold).  Steps held
//     in registers instead (an earlier version) left room for two blocks
//     an SM, not three, and hid less of the chain.  A half that is not a
//     multiple of 4, or operands not 16-byte aligned, take one element a
//     step, unstaged.

#include <cuda_runtime.h>
#include <stdint.h>

#include "field.cuh"
#include "hash.cuh"

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

// One step of K4-dyn: four elements (a 16-byte word of a, b and x^-1),
// folded with am, alpha in Montgomery form.
__device__ __forceinline__ uint4 fold_four(uint4 av, uint4 bv, uint4 xv,
                                           uint32_t am, uint32_t inv2,
                                           uint32_t inv2_s) {
  return make_uint4(fold_one(av.x, bv.x, mont_mul(xv.x, am), inv2, inv2_s),
                    fold_one(av.y, bv.y, mont_mul(xv.y, am), inv2, inv2_s),
                    fold_one(av.z, bv.z, mont_mul(xv.z, am), inv2, inv2_s),
                    fold_one(av.w, bv.w, mont_mul(xv.w, am), inv2, inv2_s));
}

constexpr int kFoldThreads = 256;
// K4-dyn: the steps a thread keeps in flight, staged in shared memory, the
// first of them requested before the challenge's chain (set from
// tools/tune_kernels.py --only fold on an H100, PERF.md).
constexpr int kFoldStages = 3;

// 16 bytes from device memory to shared memory, asynchronously (cp.async,
// through L2 only); a thread's copies are grouped by commit, and a wait
// lets at most N of its latest groups still be in flight.  A host compiler
// (the CPU check of the kernels' logic) copies at once.
__device__ __forceinline__ void copy_async16(uint4* dst, const uint4* src) {
#ifdef __CUDA_ARCH__
  const unsigned to = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(to), "l"(src)
               : "memory");
#else
  *dst = *src;
#endif
}

__device__ __forceinline__ void copy_async_commit() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.commit_group;\n" ::: "memory");
#endif
}

template <int N>
__device__ __forceinline__ void copy_async_wait() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
#endif
}

// K4-dyn: request step j of a thread (a, b and x^-1 words j) into its slot
// (three rows of the block's threads, the thread's word in each), and
// commit the group (empty past the last step).
__device__ __forceinline__ void stage_step(uint4 (*slot)[kFoldThreads],
                                           const uint4* a4, const uint4* b4,
                                           const uint4* x4, long long j,
                                           long long steps) {
  if (j < steps) {
    copy_async16(&slot[0][threadIdx.x], a4 + j);
    copy_async16(&slot[1][threadIdx.x], b4 + j);
    copy_async16(&slot[2][threadIdx.x], x4 + j);
  }
  copy_async_commit();
}

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

// K4-dyn.  codewords: rows of 2 half values; roots: a 32-byte root a row;
// state, pending: the rows' sponges (two 16-byte words a row each, pending
// holding q bytes), read; state_out, pending_out: where block 0 of each row
// writes them after the root (other rows of memory); copy: where it writes
// the root too; alpha: where it writes the row's challenge mod p; out: rows
// of half.  blockIdx.y is the row; vec: half is a
// multiple of 4 and the rows are 16-byte aligned; roots_vec, copy_vec:
// the roots 4-byte aligned, the roots and copy 16-byte aligned.
__global__ void __launch_bounds__(kFoldThreads, 3)
    stark_fri_fold_dyn_kernel(const uint32_t* __restrict__ codewords,
                              const uint32_t* __restrict__ inv_x_mont,
                              const uint4* state, const uint4* pending,
                              uint4* state_out, uint4* pending_out, int q,
                              int fresh, const uint8_t* __restrict__ roots,
                              uint8_t* copy, uint32_t* alpha,
                              uint32_t* __restrict__ out, long long half, int vec,
                              int roots_vec, int copy_vec, uint32_t inv2,
                              uint32_t inv2_s) {
  __shared__ uint4 stage[kFoldStages][3][kFoldThreads];
  __shared__ uint32_t alpha_mont;
  const int r = blockIdx.y;
  const uint32_t* a = codewords + 2 * half * r;
  const uint32_t* b = a + half;
  uint32_t* o = out + half * r;
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long steps = vec ? half >> 2 : half;
  const uint4* a4 = reinterpret_cast<const uint4*>(a);
  const uint4* b4 = reinterpret_cast<const uint4*>(b);
  const uint4* x4 = reinterpret_cast<const uint4*>(inv_x_mont);
  // The challenge's loads first, then (after the barrier) the block's: a
  // load queued behind the block's requests waits for them.
  stark::SpongeIn sponge;
  if (threadIdx.x == 0)
    stark::sponge_load(sponge, state + 2 * r, pending + 2 * r, q, fresh, roots + 32 * r,
                       32, roots_vec);
  __syncthreads();
  // The first kFoldStages steps requested before the chain: step k of a
  // thread is i + k stride, staged in slot k mod kFoldStages, one group.
  if (vec) {
#pragma unroll
    for (int k = 0; k < kFoldStages; ++k)
      stage_step(stage[k], a4, b4, x4, i + k * stride, steps);
  }
  if (threadIdx.x == 0) {
    const bool lead = blockIdx.x == 0;
    const uint32_t al = stark::sponge_step(
        sponge, state_out + 2 * r, pending_out + 2 * r, lead, q, fresh, roots + 32 * r, 32,
        roots_vec, lead ? copy + 32 * r : nullptr, copy_vec, true);
    if (lead) alpha[r] = al;
    alpha_mont = mont_mul(al, kR2);
  }
  __syncthreads();
  const uint32_t am = alpha_mont;
  if (vec) {
    uint4* o4 = reinterpret_cast<uint4*>(o);
    for (int k = 0; i < steps; ++k, i += stride) {
      // Groups committed: kFoldStages + k; step k's is the (k + 1)-th.
      copy_async_wait<kFoldStages - 1>();
      uint4 (*slot)[kFoldThreads] = stage[k % kFoldStages];
      o4[i] = fold_four(slot[0][threadIdx.x], slot[1][threadIdx.x], slot[2][threadIdx.x],
                        am, inv2, inv2_s);
      // The slot is free once the store has its value: its next step.
      stage_step(slot, a4, b4, x4, i + kFoldStages * stride, steps);
    }
  } else {
    for (; i < steps; i += stride)
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

// K4-dyn: codewords (rows, 2 half) -> out (rows, half), each row folded
// with the challenge drawn after absorbing its root (rows, 32) u8 into its
// sponge (state, pending: (rows, 32) u8 with q pending bytes; the next ones
// written into state_out, pending_out); the roots also into copy (rows,
// 32) u8, the challenges into alpha (rows,); inv_x_mont (half,) shared by
// every row.  sms: the
// card's SM count.
int stark_fri_fold_dyn(const void* codewords, const void* inv_x_mont,
                       const void* state, const void* pending, void* state_out,
                       void* pending_out, int q, int fresh, const void* roots,
                       void* copy, void* alpha, void* out, long long half,
                       int rows, int sms, unsigned inv2, unsigned inv2_s,
                       void* stream) {
  if (rows < 1 || rows > 65535 || half < 1 || sms < 1 || q < 0 || q > 31 ||
      (fresh && q))
    return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(state) | reinterpret_cast<uintptr_t>(pending) |
       reinterpret_cast<uintptr_t>(state_out) |
       reinterpret_cast<uintptr_t>(pending_out)) & 15)
    return (int)cudaErrorMisalignedAddress;
  // Blocks of this kernel that one SM holds at once (the same for every
  // card of one architecture: the library is built for one).
  static int resident = 0;
  if (resident == 0) {
    int n = 0;
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, stark_fri_fold_dyn_kernel, kFoldThreads, 0);
    if (err != cudaSuccess) return (int)err;
    resident = n > 0 ? n : 1;
  }
  const bool vec = half % 4 == 0 &&
                   ((reinterpret_cast<uintptr_t>(codewords) |
                     reinterpret_cast<uintptr_t>(inv_x_mont) |
                     reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  const bool roots_vec = (reinterpret_cast<uintptr_t>(roots) & 3) == 0;
  const bool copy_vec = ((reinterpret_cast<uintptr_t>(roots) |
                          reinterpret_cast<uintptr_t>(copy)) & 15) == 0;
  const long long steps = vec ? half / 4 : half;
  long long per_row = (steps + kFoldThreads - 1) / kFoldThreads;
  long long wave = (long long)sms * resident / rows;
  if (wave < 1) wave = 1;
  if (per_row > wave) per_row = wave;
  stark_fri_fold_dyn_kernel<<<dim3((unsigned)per_row, (unsigned)rows),
                              kFoldThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const uint32_t*>(codewords),
      static_cast<const uint32_t*>(inv_x_mont),
      static_cast<const uint4*>(state), static_cast<const uint4*>(pending),
      static_cast<uint4*>(state_out), static_cast<uint4*>(pending_out), q, fresh,
      static_cast<const uint8_t*>(roots), static_cast<uint8_t*>(copy),
      static_cast<uint32_t*>(alpha), static_cast<uint32_t*>(out), half, (int)vec,
      (int)roots_vec, (int)copy_vec, inv2, inv2_s);
  return (int)cudaGetLastError();
}

}  // extern "C"
