// Commitment hash and Merkle trees for Hopper: kernels K5/K6 (leaf and row
// digests), K7 (one tree level), K8 (a whole subtree per block) with its
// forest entry, K9 (the Fiat-Shamir sponge of the device commit chain), K15
// (the STARK layer's constraint challenges) and K10 (the FRI query
// indices).
//
// They replace functions of the JAX package that are XLA-fused jnp on the
// TPU (Mosaic could not lower u8 vectors, stark_tpu/ops/pallas_kernels.py
// :3-5), all in stark_tpu/ops/hash_batch.py:
//   stark_hash_rows     leaf_hash_rows_core (:279, K5, the c = 1 case) and
//                       row_hash_rows_core (:290, K6);
//   stark_merkle_level  combine_rows_core / level_rows_core (:313-345, K7);
//   stark_merkle_tail   _tail_levels_core / _tail_loop (:433-538, K8) with
//                       the level stack that stack_path_gather (:566) reads;
//   stark_merkle_forest forest_tail_levels_core (:510, K8 for forests: B
//                       trees side by side, each built down to its own
//                       root) and stark_tpu/batch.py's _forest_* (:53-138);
//   stark_sponge_absorb the incremental transcript sponge (:831-919, K9):
//                       sponge_from_bytes, sponge_absorb, sponge_state,
//                       state_alpha, device_sponge_root_alpha;
//   stark_constraint_challenges  stark_tpu/stark.py:_device_challenges_fn
//                       (:165, K15) over the same sponge;
//   stark_sample_indices  sample_indices_core (:964, K10) with
//                       seed_digest_rows_from_state (:951).
//
// Digests are node-major: node j is the 32 bytes at 32 * j, so a thread
// reads a digest as two 16-byte words and a parent's input left || right is
// the 64 contiguous bytes at 64 * j.
//
// What bounds K5-K7 on the card: integer instructions, not memory.  A hash
// of L bytes costs L absorb steps and ceil(L / 32) + 8 mix rounds, some
// 180 instructions per mix, against 32 bytes written and at most 64 read;
// all but the multiply-adds go through the SM's integer pipe, which takes
// a warp's instruction every second clock, and that pipe is what K5 and K7
// fill (hash.cuh says what the arithmetic does about it).  They keep one
// lane per thread with the whole state in registers, so the only memory
// traffic is the input once and the digest once, and fill the card with
// lanes.  The TPU's fixed-width fori_loop, segment compaction and semirev
// layout are Mosaic/XLA devices with no counterpart here.  Packing four
// state bytes into one register (SWAR) is a later redesign.
//
// What bounds K8: latency.  Level l + 1 of a tree needs level l, so the
// lg W levels above W nodes are lg W hashes one after the other, whatever
// the card's width, and one hash is ~1,800 integer-pipe instructions of
// one thread: a warp alone on its scheduler needs two clocks for each, 1.8
// us a level at 1980 MHz.  The instruction bound (W - 1 hashes over the
// card's issue rate) is far below that walk at every W this kernel is
// given.  The design therefore
//   - cuts the W nodes into subtrees, one block each (2^9 nodes on 128
//     blocks at W = 2^16), so the wide levels run on every SM at once; a
//     block reads its nodes from device memory, keeps the levels it builds
//     in shared memory (two buffers in turn: one barrier per level) and
//     writes each level's share into the level stack;
//   - reaches the root in the same launch: a block that has written its
//     subtree's root fences, takes a ticket (atomicAdd), and the block that
//     draws the last ticket - every other root is then visible to it -
//     reads the 2^lg_top roots back through L2 and walks the top, and sets
//     the ticket to 0 for the next launch.  A tree's tail is one launch;
//   - shares hash.cuh's arithmetic with K5-K7: fewer integer-pipe
//     instructions per hash shorten every one of the serial levels.  Only
//     the state's form between mix rounds is K8's own (hash.cuh Form:
//     kOwed, fewer instructions in all, where K5-K7 take kScaled).
//   - spreads each hash of a level narrower than the block over several
//     lanes (tail_lanes: the block's threads a hash, at most kTailLanes;
//     hash.cuh split_combine), so that a lone warp issues a fraction of
//     a hash's instructions and the levels near a root shorten; a level
//     that fills the block keeps one lane a hash, the fewest instructions.
// Tried and measured on an H100, no gain, and not kept (PERF.md): the
// diffusion sum of the mix as 2, 4 or 8 chains - the warp waits for the
// integer pipe, not for the chain of adds.  Not built: two hashes
// interleaved in one thread - the second state doubles the instructions
// the warp must issue, and where few hashes remain that pipe is the limit,
// not a lack of independent work.
// ptxas -v (sm_90a, CUDA 12; tools/tune_kernels.py prints it): K5/K6 48
// registers, K7 48, K8 and K8-forest 64 and 24,577 bytes of shared
// memory, K9 80, K15 52 (and 32 bytes a challenge of dynamic shared
// memory), K10 40 and 2,608 bytes of shared memory; no spills, no stack.
#include <cuda_runtime.h>
#include <stdint.h>

#include "field.cuh"
#include "hash.cuh"

namespace {

using stark::absorb_value;
using stark::pack4;
using stark::hash_combine;
using stark::hash_finish;
using stark::hash_init;
using stark::mix;
using stark::pack_digest;

constexpr int kLaneThreads = 256;
// K8: a block walks at most kTailMaxLg levels at a time (24 KB of shared
// memory: 2^9 digests of the level it wrote last, 2^8 of the one before),
// with at most kTailThreads threads.
constexpr int kTailMaxLg = 10;
constexpr int kTailThreads = 256;
// K8: at most kTailLanes lanes a hash in a level narrower than the block,
// and the form a split state keeps between mix rounds (hash.cuh Form):
// each set from tools/tune_kernels.py --only forest and chip_smoke.py's
// sweep on an H100 (PERF.md).
constexpr int kTailLanes = 8;
constexpr stark::Form kSplitForm = stark::Form::kOwed;

// Lanes a hash at a level of `count` hashes in a block of `threads`: the
// block's threads spread over the level, up to lanes_max a hash (1, 4 or
// 8); one lane where they would not give a hash four.  (Two lanes a hash
// measured slower than one on an H100, and every width of the split hash
// is code that a lone warp fetches cold, PERF.md.)
__device__ __forceinline__ int tail_lanes(int count, int threads, int lanes_max) {
  const int spread = threads / count;
  if (spread < 4) return 1;
  return spread < lanes_max ? spread : lanes_max;
}

// One level of a block's walk with L lanes a hash (hash.cuh split_combine):
// hash j of the level is threads L j .. L j + L - 1, and lane r reads and
// writes words kW r .. kW r + kW - 1 of each digest.  count L <= the
// block's threads.  A warp with any of the level's hashes runs whole: its
// lanes past them hash zeros and store nothing (the shuffles take the
// whole warp's mask).
template <int L>
__device__ __forceinline__ void tail_level_split(const uint32_t* in, bool global,
                                                 uint32_t* mine, uint32_t* out,
                                                 long long first, int count) {
  constexpr int kW = stark::SplitLane<L>::kW;
  const int u = threadIdx.x;
  // A warp with none of the level's hashes leaves; the vote's result is the
  // same in every lane, which the compiler can see.
  if (!__any_sync(0xFFFFFFFFu, u < count * L)) return;
  const bool mine_hash = u < count * L;
  const int j = u / L;
  const stark::SplitLane<L> ln(u & (L - 1));
  const uint32_t* pair = in + 16 * j + kW * ln.r;
  uint32_t l[kW], rt[kW];
#pragma unroll
  for (int w = 0; w < kW; ++w) {
    l[w] = !mine_hash ? 0u : global ? __ldcg(pair + w) : pair[w];
    rt[w] = !mine_hash ? 0u : global ? __ldcg(pair + 8 + w) : pair[8 + w];
  }
  uint32_t s[32 / L];
  stark::split_combine<L, kSplitForm>(s, l, rt, ln);
  if (!mine_hash) return;
#pragma unroll
  for (int w = 0; w < kW; ++w) {
    const uint32_t word = pack4(s[4 * w], s[4 * w + 1], s[4 * w + 2], s[4 * w + 3]);
    mine[8 * j + kW * ln.r + w] = word;
    out[8 * (first + j) + kW * ln.r + w] = word;
  }
}

// The 2^lg_n digests at src are level l0 of the part of a tree that this
// block owns, block b's share of a level `width >> l0` wide; build the
// lg_n levels above them.  Level l of the launch (width >> l nodes) starts
// at node width - (width >> (l - 1)) of out, and this block's share of it
// at b * its count of nodes.  The first level is read from device memory
// through L2 (the top's input was written by other blocks), the later ones
// from the shared buffer written one level before.  A level that fills the
// block hashes one lane a thread; a narrower one spreads each hash over
// tail_lanes lanes.
__device__ __forceinline__ void tail_walk(const uint4* src, uint4* out,
                                          long long width, int l0, int lg_n,
                                          long long b, uint4* buf_a,
                                          uint4* buf_b, int lanes_max) {
  const uint4* below = nullptr;
  for (int k = 1; k <= lg_n; ++k) {
    const int count = 1 << (lg_n - k);
    uint4* mine = (k & 1) ? buf_a : buf_b;
    const long long first = width - (width >> (l0 + k - 1)) + b * count;
    const int lanes = tail_lanes(count, blockDim.x, lanes_max);
    if (lanes > 1) {
      const uint32_t* in = reinterpret_cast<const uint32_t*>(k == 1 ? src : below);
      uint32_t* m32 = reinterpret_cast<uint32_t*>(mine);
      uint32_t* o32 = reinterpret_cast<uint32_t*>(out);
      if (lanes == 4)
        tail_level_split<4>(in, k == 1, m32, o32, first, count);
      else
        tail_level_split<8>(in, k == 1, m32, o32, first, count);
    } else {
      for (int j = threadIdx.x; j < count; j += blockDim.x) {
        uint4 l_lo, l_hi, r_lo, r_hi;
        if (k == 1) {
          l_lo = __ldcg(src + 4 * j);
          l_hi = __ldcg(src + 4 * j + 1);
          r_lo = __ldcg(src + 4 * j + 2);
          r_hi = __ldcg(src + 4 * j + 3);
        } else {
          l_lo = below[4 * j];
          l_hi = below[4 * j + 1];
          r_lo = below[4 * j + 2];
          r_hi = below[4 * j + 3];
        }
        uint32_t s[32];
        hash_combine<stark::Form::kOwed>(s, l_lo, l_hi, r_lo, r_hi);
        uint4 lo, hi;
        pack_digest(s, lo, hi);
        mine[2 * j] = lo;
        mine[2 * j + 1] = hi;
        out[2 * (first + j)] = lo;
        out[2 * (first + j) + 1] = hi;
      }
    }
    __syncthreads();  // `mine` is whole; every read of `below` is done
    below = mine;
  }
}

// The body of K8 and of its forest entry.  Block b builds the lg_sub levels
// above nodes [b 2^lg_sub, (b + 1) 2^lg_sub).  With lg_top > 0 the blocks
// come in trees of 2^lg_top (tree = b >> lg_top): the block of a tree that
// finishes last builds the lg_top levels above that tree's subtree roots,
// down to the tree's root; tickets[tree] is 0 at the launch and 0 again
// after.  A forest's trees lie side by side in every level, so tree t's
// share of a level of `count` nodes a tree starts at its node t count.
__device__ __forceinline__ void tail_body(const uint4* __restrict__ nodes,
                                          uint4* out, long long width,
                                          int lg_sub, int lg_top,
                                          unsigned int* tickets,
                                          uint4* buf_a, uint4* buf_b,
                                          int lanes_max) {
  __shared__ bool last;
  const long long b = blockIdx.x;
  tail_walk(nodes + 2 * (b << lg_sub), out, width, 0, lg_sub, b, buf_a, buf_b,
            lanes_max);
  if (lg_top == 0) return;

  const long long tree = b >> lg_top;
  __threadfence();  // this thread's digests, before the block's ticket
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(tickets + tree, 1u) == (1u << lg_top) - 1;
    if (last) tickets[tree] = 0;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  const long long roots = width - (width >> (lg_sub - 1)) + (tree << lg_top);
  tail_walk(out + 2 * roots, out, width, lg_sub, lg_top, tree, buf_a, buf_b,
            lanes_max);
}

}  // namespace

// C linkage, so that a profile names the kernels plainly.
extern "C" {

// values: (c, n) field values, row-major; out: n digests.  Lane i hashes
// the 8c bytes of column i (each value a little-endian u64) in 32-byte
// chunks of four values, a mix after each chunk; a last chunk of fewer
// values absorbs only its own bytes (it is not zero-padded).
__global__ void __launch_bounds__(kLaneThreads)
    stark_hash_rows_kernel(const uint32_t* __restrict__ values,
                           uint4* __restrict__ out, int c, long long n) {
  const long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  uint32_t s[32];
  hash_init(s);
  for (int r0 = 0; r0 < c; r0 += 4) {
    const uint32_t* col = values + (long long)r0 * n + lane;
    absorb_value<0>(s, col[0]);
    if (r0 + 1 < c) absorb_value<8>(s, col[n]);
    if (r0 + 2 < c) absorb_value<16>(s, col[2 * n]);
    if (r0 + 3 < c) absorb_value<24>(s, col[3 * n]);
    mix(s);
  }
  hash_finish(s);
  uint4 lo, hi;
  pack_digest(s, lo, hi);
  out[2 * lane] = lo;
  out[2 * lane + 1] = hi;
}

// nodes: 2 * parents digests; out: parents digests,
// out[j] = hash(nodes[2j] || nodes[2j + 1]).
__global__ void __launch_bounds__(kLaneThreads)
    stark_merkle_level_kernel(const uint4* __restrict__ nodes,
                              uint4* __restrict__ out, long long parents) {
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= parents) return;
  uint32_t s[32];
  hash_combine(s, nodes[4 * j], nodes[4 * j + 1], nodes[4 * j + 2],
               nodes[4 * j + 3]);
  uint4 lo, hi;
  pack_digest(s, lo, hi);
  out[2 * j] = lo;
  out[2 * j + 1] = hi;
}

// nodes: `width` digests, a multiple of 2^lg_sub; out: the levels above
// them, one after the other (width / 2 nodes, then width / 4, ...).  Block
// b builds the lg_sub levels above nodes [b 2^lg_sub, (b + 1) 2^lg_sub).
// With lg_top > 0 (then width = 2^(lg_sub + lg_top)) the block that
// finishes last builds the lg_top levels above the subtrees' roots too,
// down to the tree's root; *ticket is 0 at the launch and 0 again after.
__global__ void __launch_bounds__(kTailThreads)
    stark_merkle_tail_kernel(const uint4* __restrict__ nodes, uint4* out,
                             long long width, int lg_sub, int lg_top,
                             unsigned int* ticket, int lanes_max) {
  __shared__ uint4 buf_a[1 << kTailMaxLg];
  __shared__ uint4 buf_b[1 << (kTailMaxLg - 1)];
  tail_body(nodes, out, width, lg_sub, lg_top, ticket, buf_a, buf_b, lanes_max);
}

// K8 for a forest: `width` digests, trees of 2^(lg_sub + lg_top) nodes side
// by side (with lg_top = 0, of any multiple of 2^lg_sub); out: the levels
// above them, as K8 writes them, the last level the trees' roots (with
// lg_top > 0).  tickets: one zeroed word a tree.
__global__ void __launch_bounds__(kTailThreads)
    stark_merkle_forest_kernel(const uint4* __restrict__ nodes, uint4* out,
                               long long width, int lg_sub, int lg_top,
                               unsigned int* tickets, int lanes_max) {
  __shared__ uint4 buf_a[1 << kTailMaxLg];
  __shared__ uint4 buf_b[1 << (kTailMaxLg - 1)];
  tail_body(nodes, out, width, lg_sub, lg_top, tickets, buf_a, buf_b, lanes_max);
}

// K9: per lane (one thread), the incremental transcript sponge of
// stark_tpu/ops/hash_batch.py:831-919: one launch appends m bytes a lane
// (hash.cuh sponge_lane says how, and what bounds it) and, with alpha,
// writes each lane's FRI challenge mod p after them.
//   state, pending: (lanes, 32) u8, 16-byte aligned rows, updated in
//   place; fresh: start from the initial state (q must be 0); data:
//   (lanes, m) u8; copy: where the data bytes are also written (or null);
//   alpha: (lanes,) (or null).
// On an H100 its design before this one took 6.8 us against 1.2 for an
// empty launch and 4.9 with its mixes taken out (PERF.md): byte loads of
// the state, the tail and the data, each chunk byte behind two compares on
// q, byte loops for the new tail and the copy.  K4-dyn (fold.cu) runs the
// same step for the root of each FRI round but the last, in the launch
// that folds with the challenge.
__global__ void stark_sponge_absorb_kernel(uint4* state, uint4* pending, int q,
                                           int fresh,
                                           const uint8_t* __restrict__ data,
                                           int m, uint8_t* copy,
                                           uint32_t* alpha, int lanes) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  const bool vec = ((reinterpret_cast<uintptr_t>(data) | (uintptr_t)m) & 3) == 0;
  const bool copy_vec = ((reinterpret_cast<uintptr_t>(data) |
                          reinterpret_cast<uintptr_t>(copy) | (uintptr_t)m) & 15) == 0;
  const uint32_t a = stark::sponge_lane(
      state + 2 * lane, pending + 2 * lane, state + 2 * lane, pending + 2 * lane, true,
      q, fresh, data + (long long)m * lane, m, vec,
      copy == nullptr ? nullptr : copy + (long long)m * lane, copy_vec, alpha != nullptr);
  if (alpha != nullptr) alpha[lane] = a;
}

// K15: the constraint challenges of the STARK layer, counterpart of
// stark_tpu/stark.py::_device_challenges_fn (:165-197) over hash_batch.py's
// sponge_from_bytes, sponge_state and state_alpha (:831-883).  Proof b
// starts a fresh sponge with its trace root (roots: (lanes, 32) u8, read
// where the trace forest's stack keeps them, as K4-dyn reads a round's
// root) and draws `challenges` challenges: each the first 8 bytes of the
// digest of every byte so far, a little-endian u64, which the transcript
// then absorbs (stark.py _draw_constraint_challenges).  Written: the root
// at copy (lanes, 32) u8; each challenge's 8 bytes at digests (lanes,
// challenges, 8) u8, for the host's replay; the composition's weight words
// at weights (lanes, 2 challenges) u32, per pair (a, b) a R^2 mod p, its
// Shoup companion, b R mod p, its companion, as
// ops/compose.py:ComposeProgram.weights lays them out for K11; and the
// sponge after the last challenge's bytes, at state and pending (lanes, 32)
// u8, 16-byte aligned: the FRI commit chain goes on from it (q = 8
// challenges mod 32).
//
// What bounds it: latency, the chain of draws, each of which needs the
// bytes of the one before.  A group of 8 lanes serves a proof (hash.cuh's
// sponge over 8 lanes; a warp, the block, holds 4 proofs; the lanes past
// the last proof hash zeros and store nothing), and the sponge stays in its
// registers from draw to draw: `s`, the state after the last full chunk,
// and `a`, the state with every byte so far absorbed, those since that
// chunk not yet mixed.  A chunk's absorb goes byte by byte, so absorbing a
// draw's 8 bytes into `a` as they come continues the pending tail's partial
// absorb (hash.rs:25-27), and every fourth draw's completes the chunk's,
// which is then mixed into `a` and becomes `s`.  A draw is a copy of `a`
// and its mixes (the tail's and the 8 closing ones; 8 in all where no tail
// is pending, `a` being mixed already), then the digest's first 8 bytes,
// from lanes 0 and 1 to every lane, absorbed into `a` by every lane itself
// from the state's words at their positions, fetched before the mixes.
// Nothing goes through memory between draws.  The reductions and the
// digests' stores are not on the chain: each draw's raw u64 goes to shared
// memory, a window of kChallengeWindow draws at a time, and after a
// window's last draw lane r writes the digests of its pairs r, r + 8, ...
// and reduces them (raw mod p, a R^2 and b R mod p, their companions:
// 64-bit divisions by the constant p); the next window's draws reuse the
// buffer, the sponge staying in registers across.  A chain of at most a
// window (every AIR the paths prove) draws and stores as if there were no
// window; the count has no upper bound.
constexpr int kChallengeProofs = 4;  // proofs a block: one warp, 8 lanes each
// Draws a group keeps in shared memory: 8 bytes each, 32 KB a block of 4
// groups, under the 48 KB a launch takes without the opt-in attribute.
constexpr int kChallengeWindow = 1024;

// K15's stores of `draws` draws (an even count) from their raw words in
// shared memory: lane r of a group writes the digests of pairs r, r + 8,
// ... and K11's weight words from them (see the kernel).
__device__ __forceinline__ void challenge_words(const uint32_t* raw, int draws,
                                                uint32_t* digests, uint32_t* weights,
                                                int r) {
  constexpr uint32_t kR1 = (uint32_t)((1ull << 32) % stark::kP);
  constexpr uint32_t kR2 = (uint32_t)((uint64_t)kR1 * kR1 % stark::kP);
  for (int j = r; 2 * j < draws; j += 8) {
    const uint64_t x0 = raw[4 * j] | (uint64_t)raw[4 * j + 1] << 32;
    const uint64_t x1 = raw[4 * j + 2] | (uint64_t)raw[4 * j + 3] << 32;
    const uint32_t wa = (uint32_t)(x0 % stark::kP * kR2 % stark::kP);
    const uint32_t wb = (uint32_t)(x1 % stark::kP * kR1 % stark::kP);
    uint32_t* d = digests + 4 * j;
    uint32_t* w = weights + 4 * j;
#pragma unroll
    for (int i = 0; i < 4; ++i) d[i] = raw[4 * j + i];
    w[0] = wa;
    w[1] = (uint32_t)(((uint64_t)wa << 32) / stark::kP);
    w[2] = wb;
    w[3] = (uint32_t)(((uint64_t)wb << 32) / stark::kP);
  }
}

__global__ void __launch_bounds__(8 * kChallengeProofs)
    stark_constraint_challenges_kernel(const uint8_t* __restrict__ roots,
                                       uint32_t* state, uint32_t* pending, uint8_t* copy,
                                       uint32_t* digests, uint32_t* weights,
                                       int challenges, int lanes) {
  extern __shared__ uint32_t raws[];  // [group][draw of the window][2]: low, high word
  const int group = threadIdx.x >> 3;
  const long long lane = (long long)blockIdx.x * kChallengeProofs + group;
  const bool mine = lane < lanes;
  const stark::SpongeLanes ln(threadIdx.x & 7);
  const int window = challenges < kChallengeWindow ? challenges : kChallengeWindow;
  uint32_t* raw = raws + 2 * window * group;
  // Lanes 0 and 1 hold a draw's words: each keeps its own, one predicated
  // store a draw, no branch on the chain.
  uint32_t* kept = raw + (ln.r & 1);
  const bool keeps = ln.r < 2;
  // The root's word r (byte loads: a root row need not be aligned).
  uint32_t root = 0;
  if (mine) {
    const uint8_t* at = roots + 32 * lane + 4 * ln.r;
    uint8_t* to = copy + 32 * lane + 4 * ln.r;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint8_t byte = at[i];
      to[i] = byte;
      root |= (uint32_t)byte << (8 * i);
    }
  }
  uint32_t a[4], s[4];
  stark::split_init<8>(a, ln);
  const uint32_t chunk[1] = {root};
  stark::split_absorb<8>(a, chunk, ln);
  stark::split_mix<8, stark::Form::kBytes, stark::Form::kBytes>(a, ln);
#pragma unroll
  for (int j = 0; j < 4; ++j) s[j] = a[j];
  uint32_t pend = 0;  // the lane's word of the pending tail
  for (int base = 0; base < challenges; base += window) {
    const int end = challenges - base < window ? challenges : base + window;
    for (int k = base; k < end; ++k) {
      const int q = (8 * k) & 31;  // the tail's length, where this draw's bytes go
      const uint32_t word = stark::split_word(a);
      const uint32_t at0 = __shfl_sync(ln.mask, word, q >> 2, 8);
      const uint32_t at1 = __shfl_sync(ln.mask, word, (q >> 2) + 1, 8);
      uint32_t c[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) c[j] = a[j];
      stark::split_close(c, ln, q ? 9 : 8);
      const uint32_t dig = stark::split_word(c);
      const uint32_t d0 = __shfl_sync(ln.mask, dig, 0, 8);
      const uint32_t d1 = __shfl_sync(ln.mask, dig, 1, 8);
      if (keeps) kept[2 * (k - base)] = dig;
      stark::split_absorb_short<8>(a, at0, at1, d0, d1, q, ln);
      const uint32_t delta = (uint32_t)(ln.r - (q >> 2)) & 7u;
      pend = stark::select_bits(0u - (uint32_t)(delta == 0), d0,
                                stark::select_bits(0u - (uint32_t)(delta == 1), d1, pend));
      if (q == 24) {  // a full chunk: mixed, the new state, no tail
        stark::split_mix<8, stark::Form::kBytes, stark::Form::kBytes>(a, ln);
#pragma unroll
        for (int j = 0; j < 4; ++j) s[j] = a[j];
        pend = 0;
      }
    }
    // The window's draws: lanes 0 and 1 stored them, every lane reads them.
    __syncwarp();
    if (mine) {
      const long long at = 2 * ((long long)challenges * lane + base);
      challenge_words(raw, end - base, digests + at, weights + at, ln.r);
    }
    // Read before the next window's draws overwrite them.
    if (end < challenges) __syncwarp();
  }
  if (mine) {
    state[8 * lane + ln.r] = stark::split_word(s);
    pending[8 * lane + ln.r] = pend;
  }
}

// K10: the FRI query indices, one block a proof (lane), counterpart of
// stark_tpu/ops/hash_batch.py::sample_indices_core (:964-1040), with
// seed_digest_rows_from_state (:951), and of stark_tpu/batch.py::
// _sample_indices_batched (:449), the reference's Fri::sample_indices
// (fri.rs:168-213).  From lane b's sponge after the FRI commit's last root
// (state, pending: (lanes, 32) u8, 16-byte aligned, a tail of q bytes):
// the seed challenge's raw u64 (the first 8 bytes of the digest of every
// byte so far) and the seed H(those 8 bytes); then candidate c < m hashes
// to H(seed || c as a little-endian u32), index low32 mod size, reduced
// index low32 mod reduced (low32: the digest's last four bytes, most
// significant first; size and reduced powers of two).  Candidates are
// taken in order: one is accepted when its reduced index has not been
// seen, until `number` are.  Written: the accepted indices at out
// (lanes, number) u32 (0 past the count) and the count, at most number,
// at count (lanes,).  A count below number (m candidates gave fewer
// distinct reduced indices) leaves the host to sample.
//
// Every hash runs over 8 lanes (hash.cuh's sponge over 8 lanes).  The
// block's first warp draws the seed challenge, hashes the seed, and absorbs
// and mixes the seed as the candidates' first chunk, which is the same for
// every candidate, and leaves that state in shared memory; then each group
// of 8 lanes of the block hashes a candidate from it: its counter absorbed
// at positions 0 .. 3 (which reach 7 .. 10 and chain no further) and its 9
// mixes.  A pass hashes as many candidates as the block has groups (at
// most kSampleMaxPass; fewer where the tests or the candidates are fewer,
// so that a pass that suffices is no wider than it must be), their low32
// to shared memory, then the first warp walks them in order, 32 at a time:
// __match_any_sync finds the lanes of a group with its reduced index (the
// lowest of them is the first occurrence), a bit of a seen-mask in shared
// memory (reduced bits, at most kSampleMaxReduced) says whether an earlier
// group had it, and a ballot's prefix gives each accepted lane its
// position: the reference's order exactly.  The block stops after the pass
// that completes the count, or when it has hashed all m candidates.  What
// bounds it: latency, the seed's chain (the challenge's 8 or 9 mixes, the
// seed's 9, the first chunk's 1) and a candidate's 9 mixes a pass.
constexpr int kSampleMaxReduced = 1 << 14;
constexpr int kSampleMaxPass = 128;  // candidates a pass: 1,024 threads

__global__ void __launch_bounds__(8 * kSampleMaxPass)
    stark_sample_indices_kernel(const uint32_t* state, const uint32_t* pending,
                                int q, uint32_t size_mask, uint32_t reduced,
                                int number, int m, uint32_t* out,
                                uint32_t* count) {
  __shared__ uint32_t seen[kSampleMaxReduced / 32];
  __shared__ uint32_t low[kSampleMaxPass];
  __shared__ uint32_t first[8];  // the candidates' first chunk, absorbed and mixed
  __shared__ int found_all;
  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int pass = blockDim.x >> 3;
  const stark::SpongeLanes ln(t & 7);
  for (uint32_t i = t; i < (reduced + 31) / 32; i += blockDim.x) seen[i] = 0u;
  // The first warp (a vote: its result is the same in every lane of a warp,
  // which the compiler can see, so the shuffles below need no fallback).
  const bool lead = __any_sync(0xFFFFFFFFu, t < 32);
  if (lead) {
    uint32_t s[4];
    const uint32_t word = state[8 * b + ln.r];
#pragma unroll
    for (int j = 0; j < 4; ++j) s[j] = stark::byte_of(word, j);
    stark::split_absorb_prefix(s, pending[8 * b + ln.r], q, ln);
    stark::split_close(s, ln, q ? 9 : 8);
    const uint32_t dig = stark::split_word(s);
    const uint32_t d0 = __shfl_sync(ln.mask, dig, 0, 8);
    const uint32_t d1 = __shfl_sync(ln.mask, dig, 1, 8);
    stark::split_init<8>(s, ln);
    stark::split_absorb_short<8>(s, stark::kPrime0, stark::kPrime1, d0, d1, 0, ln);
    stark::split_close(s, ln, 9);
    const uint32_t seed[1] = {stark::split_word(s)};
    stark::split_init<8>(s, ln);
    stark::split_absorb<8>(s, seed, ln);
    stark::split_mix<8, stark::Form::kBytes, stark::Form::kBytes>(s, ln);
    if (t < 8) first[t] = stark::split_word(s);
  }
  __syncthreads();
  const uint32_t h0 = first[0], mine = first[ln.r];
  const int g = t >> 3;
  int found = 0;  // the same in every thread
  uint32_t* row = out + (long long)b * number;
  for (int base = 0; base < m && found < number; base += pass) {
    uint32_t s[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) s[j] = stark::byte_of(mine, j);
    stark::split_absorb_short<4>(s, h0, 0u, (uint32_t)(base + g), 0u, 0, ln);
    stark::split_close(s, ln, 9);
    if (ln.r == 7) low[g] = __byte_perm(stark::split_word(s), 0, 0x0123);
    __syncthreads();
    if (lead) {
      for (int sub = 0; sub < pass && found < number; sub += 32) {
        const int i = sub + t;
        const bool valid = i < pass && base + i < m;
        const uint32_t low32 = valid ? low[i] : 0u;
        const uint32_t red = low32 & (reduced - 1);
        // Lanes past the candidates match only one another (no reduced
        // index is all ones).
        const unsigned same = __match_any_sync(0xFFFFFFFFu, valid ? red : 0xFFFFFFFFu);
        const bool first_seen = valid && (__ffs(same) - 1) == t;
        const bool ok = first_seen && !((seen[red >> 5] >> (red & 31)) & 1u);
        const unsigned accepted = __ballot_sync(0xFFFFFFFFu, ok);
        const int pos = found + __popc(accepted & ((1u << t) - 1u));
        if (ok && pos < number) row[pos] = low32 & size_mask;
        __syncwarp();
        if (ok) atomicOr(&seen[red >> 5], 1u << (red & 31));
        __syncwarp();
        found += __popc(accepted);
      }
      if (t == 0) found_all = found;
    }
    __syncthreads();
    found = found_all;
  }
  if (found > number) found = number;
  for (int i = found + t; i < number; i += blockDim.x) row[i] = 0u;
  if (t == 0) count[b] = (uint32_t)found;
}

// K5/K6: (c, n) field values -> n digests.
int stark_hash_rows(const void* values, void* out, int c, long long n,
                    void* stream) {
  const long long blocks = (n + kLaneThreads - 1) / kLaneThreads;
  stark_hash_rows_kernel<<<(unsigned)blocks, kLaneThreads, 0,
                           (cudaStream_t)stream>>>(
      static_cast<const uint32_t*>(values), static_cast<uint4*>(out), c, n);
  return (int)cudaGetLastError();
}

// K7: 2 * parents node digests -> parents digests.
int stark_merkle_level(const void* nodes, void* out, long long parents,
                       void* stream) {
  const long long blocks = (parents + kLaneThreads - 1) / kLaneThreads;
  stark_merkle_level_kernel<<<(unsigned)blocks, kLaneThreads, 0,
                              (cudaStream_t)stream>>>(
      static_cast<const uint4*>(nodes), static_cast<uint4*>(out), parents);
  return (int)cudaGetLastError();
}

// K8: `width` node digests -> the lg_sub levels above them, and with
// lg_top > 0 every level above those, to the root.  1 <= lg_sub <= 10,
// 0 <= lg_top <= 10; 2^lg_sub divides width, and width is 2^(lg_sub +
// lg_top) when lg_top > 0.  ticket: one zeroed 32-bit word of device
// memory that only launches on this stream use: they follow one another,
// and each leaves the word at zero.  lanes: the most lanes a hash in the
// narrow levels (1, 4 or 8; 0: kTailLanes).
int stark_merkle_tail(const void* nodes, void* out, long long width,
                      int lg_sub, int lg_top, void* ticket, int lanes,
                      void* stream) {
  if (lanes == 0) lanes = kTailLanes;
  if (lanes != 1 && lanes != 4 && lanes != 8) return (int)cudaErrorInvalidValue;
  if (lg_sub < 1 || lg_sub > kTailMaxLg || lg_top < 0 ||
      lg_top > kTailMaxLg || (width & ((1LL << lg_sub) - 1)) ||
      (lg_top > 0 && (width != 1LL << (lg_sub + lg_top) || !ticket)))
    return (int)cudaErrorInvalidValue;
  int threads = 1 << ((lg_sub > lg_top ? lg_sub : lg_top) - 1);
  if (threads < 32) threads = 32;
  if (threads > kTailThreads) threads = kTailThreads;
  stark_merkle_tail_kernel<<<(unsigned)(width >> lg_sub), threads, 0,
                             (cudaStream_t)stream>>>(
      static_cast<const uint4*>(nodes), static_cast<uint4*>(out), width,
      lg_sub, lg_top, static_cast<unsigned int*>(ticket), lanes);
  return (int)cudaGetLastError();
}

// K8 for a forest: as stark_merkle_tail, `width` node digests in trees of
// 2^(lg_sub + lg_top) nodes (lg_top > 0), each built to its own root, the
// block of a tree that finishes last taking the top; with lg_top = 0 the
// lg_sub levels above every subtree.  tickets: one zeroed word a tree, left
// at zero, used only by launches on this stream.
int stark_merkle_forest(const void* nodes, void* out, long long width,
                        int lg_sub, int lg_top, void* tickets, int lanes,
                        void* stream) {
  if (lanes == 0) lanes = kTailLanes;
  if (lanes != 1 && lanes != 4 && lanes != 8) return (int)cudaErrorInvalidValue;
  if (lg_sub < 1 || lg_sub > kTailMaxLg || lg_top < 0 ||
      lg_top > kTailMaxLg || (width & ((1LL << (lg_sub + lg_top)) - 1)) ||
      (lg_top > 0 && !tickets))
    return (int)cudaErrorInvalidValue;
  int threads = 1 << ((lg_sub > lg_top ? lg_sub : lg_top) - 1);
  if (threads < 32) threads = 32;
  if (threads > kTailThreads) threads = kTailThreads;
  stark_merkle_forest_kernel<<<(unsigned)(width >> lg_sub), threads, 0,
                               (cudaStream_t)stream>>>(
      static_cast<const uint4*>(nodes), static_cast<uint4*>(out), width,
      lg_sub, lg_top, static_cast<unsigned int*>(tickets), lanes);
  return (int)cudaGetLastError();
}

// K9: append m bytes a lane to `lanes` sponges (see the kernel).
int stark_sponge_absorb(void* state, void* pending, int q, int fresh,
                        const void* data, int m, void* copy, void* alpha,
                        int lanes, void* stream) {
  if (q < 0 || q > 31 || m < 0 || lanes < 1 || (fresh && q))
    return (int)cudaErrorInvalidValue;
  const int threads = lanes < 128 ? lanes : 128;
  if ((reinterpret_cast<uintptr_t>(state) | reinterpret_cast<uintptr_t>(pending)) & 15)
    return (int)cudaErrorMisalignedAddress;
  stark_sponge_absorb_kernel<<<(lanes + threads - 1) / threads, threads, 0,
                               (cudaStream_t)stream>>>(
      static_cast<uint4*>(state), static_cast<uint4*>(pending), q, fresh,
      static_cast<const uint8_t*>(data), m, static_cast<uint8_t*>(copy),
      static_cast<uint32_t*>(alpha), lanes);
  return (int)cudaGetLastError();
}

// K15: `challenges` constraint challenges for each of `lanes` proofs (see
// the kernel).  state, pending: 16-byte aligned rows; digests, weights:
// 4-byte aligned.
int stark_constraint_challenges(const void* roots, void* state, void* pending,
                                void* copy, void* digests, void* weights,
                                int challenges, int lanes, void* stream) {
  if (challenges < 0 || challenges % 2 || lanes < 1)
    return (int)cudaErrorInvalidValue;
  if (((reinterpret_cast<uintptr_t>(state) | reinterpret_cast<uintptr_t>(pending)) & 15) ||
      ((reinterpret_cast<uintptr_t>(digests) | reinterpret_cast<uintptr_t>(weights)) & 3))
    return (int)cudaErrorMisalignedAddress;
  const int smem =
      8 * kChallengeProofs * (challenges < kChallengeWindow ? challenges : kChallengeWindow);
  stark_constraint_challenges_kernel<<<(lanes + kChallengeProofs - 1) / kChallengeProofs,
                                       8 * kChallengeProofs, smem, (cudaStream_t)stream>>>(
      static_cast<const uint8_t*>(roots), static_cast<uint32_t*>(state),
      static_cast<uint32_t*>(pending), static_cast<uint8_t*>(copy),
      static_cast<uint32_t*>(digests), static_cast<uint32_t*>(weights), challenges,
      lanes);
  return (int)cudaGetLastError();
}

// K10: `number` query indices for each of `lanes` proofs from m candidates
// (see the kernel); size and reduced powers of two, reduced at most
// kSampleMaxReduced, number at most reduced.
int stark_sample_indices(const void* state, const void* pending, int q,
                         long long size, long long reduced, int number, int m,
                         void* out, void* count, int lanes, void* stream) {
  if (q < 0 || q > 31 || lanes < 1 || number < 1 || m < 0 || size < 1 ||
      (size & (size - 1)) || size > (1LL << 31) || reduced < 1 ||
      (reduced & (reduced - 1)) || reduced > kSampleMaxReduced || number > reduced)
    return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(state) | reinterpret_cast<uintptr_t>(pending)) & 15)
    return (int)cudaErrorMisalignedAddress;
  // Candidates a pass: no more than the tests (rounded up to a warp's
  // walk), the candidates, or kSampleMaxPass; whole warps of 8-lane groups.
  int pass = (number + 31) / 32 * 32;
  if (pass > kSampleMaxPass) pass = kSampleMaxPass;
  if (pass > m) pass = m;
  const int threads = (8 * pass + 31) / 32 * 32;
  stark_sample_indices_kernel<<<lanes, threads < 32 ? 32 : threads, 0,
                                (cudaStream_t)stream>>>(
      static_cast<const uint32_t*>(state), static_cast<const uint32_t*>(pending), q,
      (uint32_t)(size - 1), (uint32_t)reduced, number, m,
      static_cast<uint32_t*>(out), static_cast<uint32_t*>(count));
  return (int)cudaGetLastError();
}

}  // extern "C"
