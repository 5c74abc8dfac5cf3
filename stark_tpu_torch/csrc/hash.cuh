// The commitment hash, one lane per thread (reference src/hash.rs:7-99,
// bit-exact with hashfn.py and native/hash.c).
//
// The 32-byte state of a lane is 32 registers, one state byte in the low 8
// bits of each.  THE BITS ABOVE THOSE 8 ARE NOT DEFINED: every step of the
// hash is arithmetic mod 256 (adds, multiplies, XORs, left shifts), whose
// low 8 bits depend on the low 8 bits of its operands only, so no step
// masks its result.  The two places that would see the high bits take care
// of them where they stand: a rotation reads its one right-shifted operand
// through a bit select that takes only the bits that came from inside the
// byte, and pack_digest picks byte 0 of every register.  On this card the
// kernels that hash are bound by the integer pipe, which takes a warp's
// instruction every second clock (multiply-adds go to the other pipe at
// one per clock); leaving the masks out, sharing the sbox's XOR constant
// in a group of four and, between two mix rounds, keeping the state in a
// form that pays the round constant in the next multiply-add (4.5) or
// whose sums are multiply-adds too (3.5; see Form) brings a mix round down
// from 8 integer-pipe instructions per state byte.
//
// Every index into the state is a compile-time constant: the loops over
// state bytes have constant bounds and are fully unrolled, and the absorb
// position is a template argument, so nothing here forces the state into
// local memory.
#pragma once

#include <stdint.h>

#include "field.cuh"

namespace stark {

// The initial state: the first 16 primes, cycled (hash.rs:10-12).
__device__ __forceinline__ void hash_init(uint32_t (&s)[32]) {
  constexpr uint32_t kPrimes[16] = {2,  3,  5,  7,  11, 13, 17, 19,
                                    23, 29, 31, 37, 41, 43, 47, 53};
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = kPrimes[i & 15];
}

// Bit by bit: mask ? a : b.  Written as the one LOP3 it is: from the C
// expression the compiler makes two (it first masks b with ~mask's bits).
__device__ __forceinline__ uint32_t select_bits(uint32_t mask, uint32_t a,
                                                uint32_t b) {
#ifdef __CUDA_ARCH__
  uint32_t d;
  asm("lop3.b32 %0, %1, %2, %3, 0xCA;" : "=r"(d) : "r"(mask), "r"(a), "r"(b));
  return d;
#else
  return (a & mask) | (b & ~mask);
#endif
}

// Absorb one byte at chunk position kPos (hash.rs:14-23): wrapping add,
// rotate left by 3, store, and XOR into position kPos + 7 mod 32.  Only
// the low 8 bits of b count.  The rotation of t = s + b takes bits 3..7
// from t << 3 and bits 0..2 from t >> 5, where they are t's bits 5..7.
template <int kPos>
__device__ __forceinline__ void absorb_byte(uint32_t (&s)[32], uint32_t b) {
  const uint32_t t = s[kPos] + b;
  const uint32_t v = select_bits(0xF8u, t << 3, t >> 5);
  s[kPos] = v;
  s[(kPos + 7) & 31] ^= v;
}

// Absorb the four bytes of a little-endian word at positions kPos..kPos+3.
template <int kPos>
__device__ __forceinline__ void absorb_word(uint32_t (&s)[32], uint32_t w) {
  absorb_byte<kPos>(s, w);
  absorb_byte<kPos + 1>(s, w >> 8);
  absorb_byte<kPos + 2>(s, w >> 16);
  absorb_byte<kPos + 3>(s, w >> 24);
}

// Absorb a field value as the 8 bytes of a little-endian u64 (the value is
// below 2^32, so the high four bytes are zero - and still absorbed: a zero
// byte rotates the state byte and XORs it onward).
template <int kPos>
__device__ __forceinline__ void absorb_value(uint32_t (&s)[32], uint32_t v) {
  absorb_word<kPos>(s, v);
  absorb_word<kPos + 4>(s, 0u);
}

// Absorb a 32-byte digest held as two 16-byte words at positions
// kPos..kPos+31 of a chunk (kPos is 0: a digest fills a chunk).
__device__ __forceinline__ void absorb_digest(uint32_t (&s)[32], uint4 lo,
                                              uint4 hi) {
  absorb_word<0>(s, lo.x);
  absorb_word<4>(s, lo.y);
  absorb_word<8>(s, lo.z);
  absorb_word<12>(s, lo.w);
  absorb_word<16>(s, hi.x);
  absorb_word<20>(s, hi.y);
  absorb_word<24>(s, hi.z);
  absorb_word<28>(s, hi.w);
}

// The forms a state byte takes on its way into and out of a mix round.
//   kBytes   the byte itself: what an absorb and pack_digest read.
//   kOwed    u, where the byte is u + its round constant: between two mix
//            rounds the next sbox's multiply-add, 502 u + 502 rc, adds the
//            constant for nothing.
//   kScaled  S = kChainMul * u, u as above.  kSboxMul is odd and kSboxMul *
//            kChainMul = 502 (mod 2^32), so the next sbox's multiply-add,
//            S * kSboxMul + 502 rc = 502 (u + rc), also undoes the scale,
//            while the sums that make S are multiply-adds by constants
//            that are no power of two: work for the pipe that multiplies,
//            which the hash otherwise leaves idle, not for the integer
//            pipe.  kChainMul is even, so S holds u mod 2^31: more than
//            the 8 bits that count.
// kScaled is the form for kernels that fill the card (fewest integer-pipe
// instructions, more instructions in all); kOwed for K8, where a warp is
// alone on its scheduler and every instruction it issues counts: on an
// H100 K8 at W = 2^16 took 38.5 and 39.7 us with kOwed against 43.1 and
// 43.2 with kScaled, the two built and run in turn (PERF.md).
enum class Form { kBytes, kOwed, kScaled };

constexpr uint32_t inverse_mod_2_32(uint32_t odd) {
  uint32_t inv = odd;  // right to 3 bits; each step doubles them
  for (int i = 0; i < 5; ++i) inv *= 2u - odd * inv;
  return inv;
}
constexpr uint32_t kSboxMul = 0x9E3779B1u;
constexpr uint32_t kChainMul = 502u * inverse_mod_2_32(kSboxMul);
static_assert(kSboxMul * kChainMul == 502u, "kSboxMul kChainMul = 502");

// The sbox without its closing XOR, rotl8(251 x, 1) in the low 8 bits, from
// z = 502 x = 2 * 251 x: bits 1..7 of z are the rotation's, and its bit 0,
// bit 7 of 251 x, is bit 8 of z.
__device__ __forceinline__ uint32_t sbox_rotated(uint32_t z) {
  return select_bits(0xFEu, z, z >> 8);
}

// One mix round (hash.rs:59-86): sbox, XOR mixing in groups of four, the
// neighbour diffusion, round constants; the state comes in as kIn and goes
// out as kOut.
//
// The sbox's XOR with 0x63.  Every output of the group mixing is the XOR
// of three sbox values, so it carries 0x63 exactly once; it is applied
// twice per group of four, not four times (see the loop).
//
// The diffusion is sequential in place in the reference: new[0] = g0 + g1
// + g31, new[i] = new[i-1] + g[i] + g[i+1], new[31] = g31 + new[0] +
// new[30]: a prefix sum of v[0] = g0 + g1 + g31, v[i] = g[i] + g[i+1], one
// three-operand add per step.  A scaled state takes it as new[i] = t[0] +
// ... + t[i] + g[i+1] with t[0] = g0 + g31 and t[k] = 2 g[k]: one
// multiply-add per step of that prefix sum (by 2 kChainMul) and one for
// the last term (by kChainMul).  The prefix sum runs as one chain of 31
// dependent steps, the fewest instructions: cut into 2, 4 or 8 shorter
// chains it was no faster on an H100, even where one warp hashes alone
// (PERF.md).
template <Form kIn, Form kOut>
__device__ __forceinline__ void mix(uint32_t (&s)[32]) {
  constexpr uint32_t kRc[32] = {
      0x01, 0x02, 0x04, 0x08, 0x10, 0x20, 0x40, 0x80, 0x1B, 0x36, 0x6C,
      0xD8, 0xAB, 0x4D, 0x9A, 0x2F, 0x5E, 0xBC, 0x63, 0xC6, 0x97, 0x35,
      0x6A, 0xD4, 0xB3, 0x7D, 0xFA, 0xEF, 0xC5, 0x91, 0x39, 0x72};
  constexpr uint32_t kInMul = kIn == Form::kScaled ? kSboxMul : 502u;
  uint32_t g[32];
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    uint32_t x[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = 4 * q + j;
      x[j] = sbox_rotated(s[i] * kInMul +
                          (kIn == Form::kBytes ? 0u : 502u * kRc[i]));
    }
    // The outputs are x0^x1^x3, x0^x2^x3, x0^x1^x2, x1^x2^x3, each ^ 0x63:
    // x0 carries it into the first three, x1 into the last.
    const uint32_t a = x[0] ^ 0x63u;
    g[4 * q] = a ^ x[1] ^ x[3];
    g[4 * q + 1] = a ^ x[2] ^ x[3];
    g[4 * q + 2] = a ^ x[1] ^ x[2];
    g[4 * q + 3] = (x[1] ^ 0x63u) ^ x[2] ^ x[3];
  }
  constexpr bool kScaled = kOut == Form::kScaled;
  uint32_t sum = 0;  // the prefix sum up to i: of v, or of kChainMul t
#pragma unroll
  for (int i = 0; i < 31; ++i) {
    if (kScaled) {
      sum = i == 0 ? g[0] * kChainMul + g[31] * kChainMul
                   : g[i] * (2u * kChainMul) + sum;
      s[i] = g[i + 1] * kChainMul + sum;
    } else {
      sum += i == 0 ? g[0] + g[1] + g[31] : g[i] + g[i + 1];
      s[i] = sum + (kOut == Form::kBytes ? kRc[i] : 0u);
    }
  }
  // new[31] = g31 + new[0] + new[30]; s[0] and s[30] hold those two, with
  // their round constants where the bytes themselves go out.
  s[31] = kScaled ? g[31] * kChainMul + (s[0] + s[30])
                  : g[31] + s[0] + s[30] +
                        (kOut == Form::kBytes ? kRc[31] - kRc[0] - kRc[30] : 0u);
}

// A mix round between an absorb and what reads the bytes next.
__device__ __forceinline__ void mix(uint32_t (&s)[32]) {
  mix<Form::kBytes, Form::kBytes>(s);
}

// The eight closing mixes (hash.rs:25-27); between them the state has the
// form kBetween (kOwed or kScaled).
template <Form kBetween = Form::kScaled>
__device__ __forceinline__ void hash_finish(uint32_t (&s)[32]) {
  mix<Form::kBytes, kBetween>(s);
#pragma unroll 1
  for (int r = 0; r < 6; ++r) mix<kBetween, kBetween>(s);
  mix<kBetween, Form::kBytes>(s);
}

// Hash::combine (hash.rs:41-46): the digest of left || right, 64 bytes, two
// full chunks.  Each digest arrives as two 16-byte words.
template <Form kBetween = Form::kScaled>
__device__ __forceinline__ void hash_combine(uint32_t (&s)[32], uint4 l0,
                                             uint4 l1, uint4 r0, uint4 r1) {
  hash_init(s);
  absorb_digest(s, l0, l1);
  mix(s);
  absorb_digest(s, r0, r1);
  mix(s);
  hash_finish<kBetween>(s);
}

// Byte 0 of each of four registers as one little-endian word (three byte
// permutes; the registers' higher bytes are not read).
__device__ __forceinline__ uint32_t pack4(uint32_t b0, uint32_t b1,
                                          uint32_t b2, uint32_t b3) {
  return __byte_perm(__byte_perm(b0, b1, 0x0040), __byte_perm(b2, b3, 0x0040),
                     0x5410);
}

// ---------------------------------------------------------------------------
// One hash spread over L lanes (L in {2, 4, 8}), for the levels of a tree
// that are narrower than the block (K8, hash.cu tail_walk).  The L lanes
// are consecutive threads of a warp, a group; lane r holds the kM = 32 / L
// state bytes at positions kM r .. kM r + kM - 1, one a register as above,
// so every group of four bytes lies in one lane: the sbox and the group XOR
// stay in the lane, and each lane issues 1 / L of their instructions.
//   - The diffusion, new[i] = T_i + g[i + 1] with T_i = g0 + g31 + 2 (g1 +
//     ... + g_i) (see mix), is a prefix sum: a lane sums its own bytes,
//     and adds the totals of the lanes before it, each fetched by its own
//     shuffle, all issued at once and summed as a tree; new[31] = g31 +
//     new[0] + new[30] takes g0 + g1 from lane 0.  g[i + 1] of a lane's
//     last byte and g31 come by a shuffle each, in the same batch: a mix
//     waits for one shuffle's latency, not for lg L of them in a row (a
//     scan with __shfl_up_sync), where a lone warp runs the level.
//   - The absorb chains position p into p + 7 (5 deep: 0 -> 7 -> ... ->
//     28), and p in 25..31 into p - 25 after that byte's own absorb.  Every
//     lane computes all its bytes in each of 5 waves, from the value at p -
//     7 that the wave before fetched (a shuffle a byte from the lane
//     holding it); a position of chain step k is right from wave k on.  One
//     more fetch gives the bytes 0..6 their XOR with 25..31.
// Shuffles have width L, so the groups of a warp shuffle apart, and the
// whole warp's mask: every lane of a warp that splits runs the split hash
// (lanes past a level's hashes on inputs they do not store), so the
// compiler emits plain shuffles.  With a group's own mask, which it cannot
// prove convergent, it wrapped each in a warp-synchronous fallback
// (WARPSYNC.COLLECTIVE) that doubled a hash's latency on an H100
// (PERF.md).

// The initial state and the round constants, four bytes to a word: a lane
// reads the words of its own positions.  In device memory, not in the
// constant bank: the lanes of a warp read different words, which the
// constant cache would serve one after another and L1 serves at once.
constexpr uint32_t bytes4(uint32_t b0, uint32_t b1, uint32_t b2, uint32_t b3) {
  return b0 | b1 << 8 | b2 << 16 | b3 << 24;
}
constexpr uint32_t kPrime0 = bytes4(2, 3, 5, 7), kPrime1 = bytes4(11, 13, 17, 19),
                   kPrime2 = bytes4(23, 29, 31, 37), kPrime3 = bytes4(41, 43, 47, 53);
constexpr uint32_t kRc0 = bytes4(0x01, 0x02, 0x04, 0x08), kRc1 = bytes4(0x10, 0x20, 0x40, 0x80),
                   kRc2 = bytes4(0x1B, 0x36, 0x6C, 0xD8), kRc3 = bytes4(0xAB, 0x4D, 0x9A, 0x2F),
                   kRc4 = bytes4(0x5E, 0xBC, 0x63, 0xC6), kRc5 = bytes4(0x97, 0x35, 0x6A, 0xD4),
                   kRc6 = bytes4(0xB3, 0x7D, 0xFA, 0xEF), kRc7 = bytes4(0xC5, 0x91, 0x39, 0x72);
__device__ const uint32_t kPrimeWords[4] = {kPrime0, kPrime1, kPrime2, kPrime3};
__device__ const uint32_t kRcWords[8] = {kRc0, kRc1, kRc2, kRc3, kRc4, kRc5, kRc6, kRc7};

// A lane's part of one split hash: its group position r, and its round
// constants rc (and 502 rc, the sbox's share) at its positions.
template <int L>
struct SplitLane {
  static_assert(L == 2 || L == 4 || L == 8, "2, 4 or 8 lanes a hash");
  static constexpr int kM = 32 / L;  // state bytes a lane
  static constexpr int kW = kM / 4;  // words a lane holds of a digest
  static constexpr unsigned mask = 0xFFFFFFFFu;  // the whole warp (above)
  int r;
  uint32_t rc[kM], rc502[kM];

  __device__ __forceinline__ explicit SplitLane(int lane) : r(lane) {
#pragma unroll
    for (int w = 0; w < kW; ++w) {
      const uint32_t word = __ldg(kRcWords + r * kW + w);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        rc[4 * w + j] = word >> (8 * j);
        rc502[4 * w + j] = 502u * rc[4 * w + j];
      }
    }
  }
  // All ones where own byte j is at a position below 7, else 0.  (The
  // lane-dependent choices here are masks, not branches: the compiler
  // keeps a split hash free of branches, around which it would wrap each
  // shuffle in a warp-synchronous fallback.)
  __device__ __forceinline__ uint32_t low(int j) const {
    return 0u - (uint32_t)(kM * r + j < 7);
  }
};

template <int L>
__device__ __forceinline__ void split_init(uint32_t (&s)[32 / L],
                                           const SplitLane<L>& ln) {
  constexpr int kW = SplitLane<L>::kW;
#pragma unroll
  for (int w = 0; w < kW; ++w) {
    const uint32_t word = __ldg(kPrimeWords + ((ln.r * kW + w) & 3));
#pragma unroll
    for (int j = 0; j < 4; ++j) s[4 * w + j] = word >> (8 * j);
  }
}

// x[j] = v at position (kM r + j - 7) mod 32: the lane's own byte j - 7,
// or byte j - 7 + back kM of the lane `back` before it in the group.
template <int L>
__device__ __forceinline__ void split_fetch7(uint32_t (&x)[32 / L],
                                             const uint32_t (&v)[32 / L],
                                             const SplitLane<L>& ln) {
  constexpr int kM = SplitLane<L>::kM;
#pragma unroll
  for (int j = 0; j < kM; ++j) {
    const int byte = (j + 32 - 7) % kM;  // j - 7, or j - 7 + back kM
    const int back = (7 - j + kM - 1) / kM;
    x[j] = j >= 7 ? v[byte] : __shfl_sync(ln.mask, v[byte], ln.r - back + L, L);
  }
}

// Absorb a 32-byte chunk; the lane holds its bytes kM r .. kM r + kM - 1
// as kW little-endian words d (hash.rs:14-23, absorb_byte).
template <int L>
__device__ __forceinline__ void split_absorb(uint32_t (&s)[32 / L],
                                             const uint32_t (&d)[32 / L / 4],
                                             const SplitLane<L>& ln) {
  constexpr int kM = SplitLane<L>::kM;
  uint32_t v[kM], x[kM];
#pragma unroll
  for (int j = 0; j < kM; ++j) x[j] = 0u;
#pragma unroll 1
  for (int wave = 0; wave < 5; ++wave) {  // rolled: less code to fetch
#pragma unroll
    for (int j = 0; j < kM; ++j) {
      const uint32_t t = (s[j] ^ x[j]) + (d[j >> 2] >> (8 * (j & 3)));
      v[j] = select_bits(0xF8u, t << 3, t >> 5);
    }
    split_fetch7<L>(x, v, ln);
    if (wave < 4) {
#pragma unroll
      for (int j = 0; j < kM; ++j) x[j] &= ~ln.low(j);
    }
  }
#pragma unroll
  for (int j = 0; j < kM; ++j) s[j] = v[j] ^ (x[j] & ln.low(j));
}

// One mix round (mix above) of a split state, kIn -> kOut.
template <int L, Form kIn, Form kOut>
__device__ __forceinline__ void split_mix(uint32_t (&s)[32 / L],
                                          const SplitLane<L>& ln) {
  constexpr int kM = SplitLane<L>::kM;
  constexpr uint32_t kInMul = kIn == Form::kScaled ? kSboxMul : 502u;
  // The diffusion's scale: kScaled sums kChainMul u (multiply-adds).
  constexpr uint32_t kK = kOut == Form::kScaled ? kChainMul : 1u;
  uint32_t g[kM];
#pragma unroll
  for (int q = 0; q < kM / 4; ++q) {
    uint32_t x[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = 4 * q + j;
      x[j] = sbox_rotated(s[i] * kInMul + (kIn == Form::kBytes ? 0u : ln.rc502[i]));
    }
    const uint32_t a = x[0] ^ 0x63u;
    g[4 * q] = a ^ x[1] ^ x[3];
    g[4 * q + 1] = a ^ x[2] ^ x[3];
    g[4 * q + 2] = a ^ x[1] ^ x[2];
    g[4 * q + 3] = (x[1] ^ 0x63u) ^ x[2] ^ x[3];
  }
  // Every shuffle the diffusion needs, at once: one hop of latency a mix.
  // g[p + 1] of the lane's last byte, g31, g0 + g1 (lane 0's), and the
  // lane totals of the local sums (below) of every lane before this one.
  const uint32_t g_next = __shfl_down_sync(ln.mask, g[0], 1, L);  // unused at r = L - 1
  const uint32_t g31 = __shfl_sync(ln.mask, g[kM - 1], L - 1, L);
  const uint32_t g01 = __shfl_sync(ln.mask, g[0] + g[1], 0, L);
  // loc[j]: T at the lane's byte j less K g31 (which every T holds): the
  // lane's own positions' shares, position 0 K g0, every other 2 K g.
  uint32_t loc[kM];
  loc[0] = g[0] * select_bits(0u - (uint32_t)(ln.r == 0), kK, 2u * kK);
#pragma unroll
  for (int j = 1; j < kM; ++j) loc[j] = g[j] * (2u * kK) + loc[j - 1];
  uint32_t part[L];  // lane d's total where d < r, else 0
#pragma unroll
  for (int d = 0; d < L; ++d) {
    const uint32_t t = __shfl_sync(ln.mask, loc[kM - 1], d, L);
    part[d] = t & (0u - (uint32_t)(d < ln.r));
  }
#pragma unroll
  for (int w = 1; w < L; w <<= 1)  // a tree: lg L dependent adds
#pragma unroll
    for (int d = 0; d + w < L; d += 2 * w) part[d] += part[d + w];
  const uint32_t before = part[0] + g31 * kK;
  uint32_t n[kM];  // new[p] before its round constant
#pragma unroll
  for (int j = 0; j < kM; ++j)
    n[j] = (j + 1 < kM ? g[j + 1] : g_next) * kK + (before + loc[j]);
  // new[31] = g31 + new[0] + new[30], new[0] = g0 + g31 + g1, in the last
  // lane.
  n[kM - 1] = select_bits(0u - (uint32_t)(ln.r == L - 1), (g31 + g31 + g01) * kK + n[kM - 2],
                          n[kM - 1]);
#pragma unroll
  for (int j = 0; j < kM; ++j) s[j] = n[j] + (kOut == Form::kBytes ? ln.rc[j] : 0u);
}

// Hash::combine (hash.rs:41-46) of a split state: l and rt are the lane's
// words of the left and the right digest.
template <int L, Form kBetween>
__device__ __forceinline__ void split_combine(uint32_t (&s)[32 / L],
                                              const uint32_t (&l)[32 / L / 4],
                                              const uint32_t (&rt)[32 / L / 4],
                                              const SplitLane<L>& ln) {
  split_init<L>(s, ln);
  split_absorb<L>(s, l, ln);
  split_mix<L, Form::kBytes, Form::kBytes>(s, ln);
  split_absorb<L>(s, rt, ln);
  split_mix<L, Form::kBytes, Form::kBytes>(s, ln);
  split_mix<L, Form::kBytes, kBetween>(s, ln);
#pragma unroll 1
  for (int k = 0; k < 6; ++k) split_mix<L, kBetween, kBetween>(s, ln);
  split_mix<L, kBetween, Form::kBytes>(s, ln);
}

// The state as a digest: two 16-byte words, byte i of the digest = the low
// byte of s[i].
__device__ __forceinline__ void pack_digest(const uint32_t (&s)[32], uint4& lo,
                                            uint4& hi) {
  lo = make_uint4(pack4(s[0], s[1], s[2], s[3]), pack4(s[4], s[5], s[6], s[7]),
                  pack4(s[8], s[9], s[10], s[11]),
                  pack4(s[12], s[13], s[14], s[15]));
  hi = make_uint4(pack4(s[16], s[17], s[18], s[19]),
                  pack4(s[20], s[21], s[22], s[23]),
                  pack4(s[24], s[25], s[26], s[27]),
                  pack4(s[28], s[29], s[30], s[31]));
}

// ---------------------------------------------------------------------------
// The Fiat-Shamir sponge of the device commit chain, one lane a thread: K9
// (hash.cu stark_sponge_absorb) and K4-dyn (fold.cu, which draws each FRI
// round's challenge itself) run sponge_lane.

// Word j of a lane's data (bytes 4j .. 4j + 3, little-endian), 0 for j
// < 0 and past the m bytes.  ``vec``: the rows are 4-byte aligned, one
// load a word; else four byte loads.
__device__ __forceinline__ uint32_t sponge_data_word(const uint8_t* in, int m,
                                                     bool vec, int j) {
  if (j < 0 || 4 * j >= m) return 0u;
  if (vec) return reinterpret_cast<const uint32_t*>(in)[j];
  uint32_t w = 0;
#pragma unroll
  for (int x = 0; x < 4; ++x)
    if (4 * j + x < m) w |= (uint32_t)in[4 * j + x] << (8 * x);
  return w;
}

// Chunk t of a lane's stream pending (q bytes) || data, as 8
// little-endian words, bytes past the stream 0.  q = 4 a + r is the same
// for every lane.  Stream word u = 8 t + k is pending word u for u < a;
// after that it is data bytes 4 u - q .. 4 u - q + 3: the last r bytes of
// data word u - a - 1 and the first 4 - r of word u - a, one funnel shift
// of the two (at u = a the first part is pending word a's r bytes).  No
// branch on a byte: a chunk is 9 word loads (one trip to memory) and a
// funnel shift a word.
__device__ __forceinline__ void sponge_chunk(uint32_t (&w)[8],
                                             const uint32_t (&pend)[8], int q,
                                             const uint8_t* in, int m,
                                             bool vec, int t) {
  const int a = q >> 2;
  const int shift = 32 - 8 * (q & 3);  // 32: the word is data word u - a
  uint32_t d[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) d[k] = sponge_data_word(in, m, vec, 8 * t + k - a - 1);
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int u = 8 * t + k;
    const uint32_t lo = u == a ? __funnelshift_lc(0u, pend[k], shift) : d[k];
    const uint32_t word = __funnelshift_rc(lo, d[k + 1], shift);
    w[k] = u < a ? pend[k] : word;
  }
}

// Absorb bytes kPos .. len - 1 of the chunk held in w (hash.rs:14-23):
// every state index stays a compile-time constant.
template <int kPos>
__device__ __forceinline__ void absorb_prefix(uint32_t (&s)[32],
                                              const uint32_t (&w)[8], int len) {
  if constexpr (kPos < 32) {
    if (kPos < len) {
      absorb_byte<kPos>(s, w[kPos >> 2] >> (8 * (kPos & 3)));
      absorb_prefix<kPos + 1>(s, w, len);
    }
  }
}

// One lane's step (stark_tpu/ops/hash_batch.py:831-919): a lane's state is
// the hash state after every full 32-byte chunk it has absorbed (32 bytes)
// and the pending tail of q < 32 bytes after them (then zeros).  Append the
// m bytes at `in`: the stream pending || data is cut into full chunks, each
// absorbed and mixed into the state (hash.rs:13-24), and what is left,
// fewer than 32 bytes, becomes the new pending tail.  The state and
// pending rows (two 16-byte words each) are read at state, pending
// (fresh: the initial state, state not read) and, with store, written at
// state_out, pending_out (the same rows, or others); the data bytes are
// also written at copy (where not null).  vec: the data rows are
// 4-byte aligned (one load a word), copy_vec: data and copy rows are
// 16-byte aligned (16-byte words); the launch decides both from its base
// pointers, so that they are the same in every lane.  With alpha, a copy of
// the state is then finalized as a hash of every byte so far would be (the
// pending tail absorbed as a partial chunk and mixed, then the 8 closing
// mixes, hash.rs:25-27) and its first 8 digest bytes, a little-endian u64,
// are returned reduced mod p: the FRI challenge the host transcript draws
// (fiat_shamir.rs:19-25), and written unreduced at raw (where not null:
// the u64 a transcript absorbs as its 8 bytes, K15, or the seed of the
// index sampling, K10); else 0.
//
// What bounds it: latency, the chain of one thread: its trips to memory,
// then the mixes one after the other (a root's absorb and the 8 closing
// mixes, ~1.9 us on an H100).  State, pending, the new tail and (for rows
// of 16-byte words) the copy move as 16-byte words, a chunk is assembled
// from data words by funnel shifts (sponge_chunk), and the loads of the
// first chunk and of the tail are issued before any arithmetic: for a
// root absorb (m = 32) that is every load of the step, one trip
// (sponge_load; sponge_step is the rest, from those words).
struct SpongeIn {
  uint32_t pend[8];  // the pending tail's words
  uint4 s0, s1;      // the state's
  uint32_t first[8], tail[8];  // the stream's first chunk, its last (partial) one
};

__device__ __forceinline__ void sponge_load(SpongeIn& v, const uint4* state,
                                            const uint4* pending, int q,
                                            bool fresh,
                                            const uint8_t* __restrict__ in,
                                            int m, bool vec) {
  const uint4 p0 = pending[0], p1 = pending[1];
  const uint32_t pend[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
#pragma unroll
  for (int k = 0; k < 8; ++k) v.pend[k] = pend[k];
  v.s0 = make_uint4(0, 0, 0, 0);
  v.s1 = v.s0;
  if (!fresh) {
    v.s0 = state[0];
    v.s1 = state[1];
  }
  sponge_chunk(v.first, pend, q, in, m, vec, 0);
  sponge_chunk(v.tail, pend, q, in, m, vec, (q + m) >> 5);
}

__device__ __forceinline__ uint32_t sponge_step(const SpongeIn& v,
                                                uint4* state_out,
                                                uint4* pending_out, bool store,
                                                int q, bool fresh,
                                                const uint8_t* __restrict__ in,
                                                int m, bool vec, uint8_t* copy,
                                                bool copy_vec, bool alpha,
                                                uint64_t* raw = nullptr) {
  const uint32_t(&pend)[8] = v.pend;
  const uint32_t(&first)[8] = v.first;
  const uint32_t(&tail)[8] = v.tail;
  const uint4 s0 = v.s0, s1 = v.s1;
  const int total = q + m;
  const int full = total >> 5;
  const int rest = total & 31;
  if (copy != nullptr) {
    if (copy_vec) {
      const uint4* src = reinterpret_cast<const uint4*>(in);
      for (int j = 0; j < m / 16; ++j) reinterpret_cast<uint4*>(copy)[j] = src[j];
    } else {
      for (int i = 0; i < m; ++i) copy[i] = in[i];
    }
  }
  uint32_t s[32];
  if (fresh) {
    hash_init(s);
  } else {
    const uint32_t st[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = st[i >> 2] >> (8 * (i & 3));  // byte i, low 8 bits
  }
  for (int t = 0; t < full; ++t) {
    uint32_t w[8];
    if (t == 0) {
#pragma unroll
      for (int k = 0; k < 8; ++k) w[k] = first[k];
    } else {
      sponge_chunk(w, pend, q, in, m, vec, t);
    }
    absorb_word<0>(s, w[0]);
    absorb_word<4>(s, w[1]);
    absorb_word<8>(s, w[2]);
    absorb_word<12>(s, w[3]);
    absorb_word<16>(s, w[4]);
    absorb_word<20>(s, w[5]);
    absorb_word<24>(s, w[6]);
    absorb_word<28>(s, w[7]);
    mix(s);
  }
  if (store) {
    uint4 lo, hi;
    pack_digest(s, lo, hi);
    state_out[0] = lo;
    state_out[1] = hi;
    pending_out[0] = make_uint4(tail[0], tail[1], tail[2], tail[3]);
    pending_out[1] = make_uint4(tail[4], tail[5], tail[6], tail[7]);
  }
  if (!alpha) return 0u;
  if (rest > 0) {
    absorb_prefix<0>(s, tail, rest);
    mix(s);
  }
  hash_finish<Form::kOwed>(s);  // a lone thread: fewest instructions
  const uint64_t digest = (uint64_t)pack4(s[0], s[1], s[2], s[3]) |
                          (uint64_t)pack4(s[4], s[5], s[6], s[7]) << 32;
  if (raw != nullptr) *raw = digest;
  return (uint32_t)(digest % kP);
}

__device__ __forceinline__ uint32_t sponge_lane(
    const uint4* state, const uint4* pending, uint4* state_out,
    uint4* pending_out, bool store, int q, bool fresh, const uint8_t* __restrict__ in,
    int m, bool vec, uint8_t* copy, bool copy_vec, bool alpha) {
  SpongeIn v;
  sponge_load(v, state, pending, q, fresh, in, m, vec);
  return sponge_step(v, state_out, pending_out, store, q, fresh, in, m, vec, copy,
                     copy_vec, alpha);
}

// ---------------------------------------------------------------------------
// The Fiat-Shamir sponge over 8 lanes, its state in registers from one draw
// to the next: K15 (hash.cu stark_constraint_challenges) and K10
// (stark_sample_indices).  A group of 8 consecutive lanes holds one sponge
// as the split hash above lays it out (lane r: state bytes 4r .. 4r + 3, one
// a register), so each of the chain's mix rounds costs a lane a quarter of
// a state byte's share of a lane-a-hash round.  What a draw needs besides
// its mixes comes to one shuffle: the 8 bytes it appends go to every lane
// of the group (two shuffles issued together), and every lane computes
// their whole absorb itself from them and from the state's words at the
// bytes' positions, fetched before the draw's mixes began.
using SpongeLanes = SplitLane<8>;

// Byte j of a little-endian word, in the low 8 bits (the bits above them
// are not defined, as everywhere in the hash).
__device__ __forceinline__ uint32_t byte_of(uint32_t word, int j) { return word >> (8 * j); }

// The four state bytes a lane holds as one little-endian word.
__device__ __forceinline__ uint32_t split_word(const uint32_t (&s)[4]) {
  return pack4(s[0], s[1], s[2], s[3]);
}

// The `mixes` rounds that finalize a split state (kBytes in and out): the
// tail's mix, where there is a tail, and the 8 closing mixes (hash.rs:
// 25-27), kOwed between rounds (fewest instructions where a warp is alone on
// its scheduler, as in K8).
__device__ __forceinline__ void split_close(uint32_t (&s)[4], const SpongeLanes& ln,
                                            int mixes) {
  split_mix<8, Form::kBytes, Form::kOwed>(s, ln);
#pragma unroll 1
  for (int i = 2; i < mixes; ++i) split_mix<8, Form::kOwed, Form::kOwed>(s, ln);
  split_mix<8, Form::kOwed, Form::kBytes>(s, ln);
}

// Absorb kN <= 8 bytes at chunk positions q .. q + kN - 1 (q a multiple of
// 4, q + kN <= 32) into a split state in kBytes form.  at0, at1: the state's
// words q / 4 and q / 4 + 1 (the bytes at those positions before the
// absorb); d0, d1: the data's words.  Every lane of the group computes the
// kN absorbed bytes v (hash.rs:14-23: only byte 7 chains, from byte 0), then
// keeps its own: a position q + o takes v[o] where o < kN, and its own byte
// XOR v[o - 7] where the absorb of byte o - 7 reached it (o is 4 ((r - q /
// 4) mod 8) + j; with q = 24 the bytes 25 .. 31 reach positions 0 .. 6, as
// in a whole chunk).  Lane-dependent choices are masks: no branch.
template <int kN>
__device__ __forceinline__ void split_absorb_short(uint32_t (&s)[4], uint32_t at0,
                                                   uint32_t at1, uint32_t d0, uint32_t d1,
                                                   int q, const SpongeLanes& ln) {
  static_assert(kN >= 1 && kN <= 8, "at most 8 bytes");
  uint32_t v[kN];
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    const uint32_t a = byte_of(i < 4 ? at0 : at1, i & 3);
    const uint32_t t = (i >= 7 ? a ^ v[i >= 7 ? i - 7 : 0] : a) + byte_of(i < 4 ? d0 : d1, i & 3);
    v[i] = select_bits(0xF8u, t << 3, t >> 5);
  }
  const uint32_t delta = (uint32_t)(ln.r - (q >> 2)) & 7u;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    uint32_t out = s[j];
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      const int o = 4 * d + j;
      const uint32_t here = 0u - (uint32_t)(delta == (uint32_t)d);
      if (o < kN)
        out = select_bits(here, v[o < kN ? o : 0], out);
      else if (o >= 7 && o - 7 < kN)
        out = select_bits(here, s[j] ^ v[o - 7 < kN ? o - 7 : 0], out);
    }
    s[j] = out;
  }
}

// Absorb bytes 0 .. n - 1 of a chunk (0 <= n <= 32; the lane's word d of
// it) into a split state: split_absorb's waves, as many as the chain p ->
// p + 7 of n bytes is deep (ceil(n / 7)), the positions past n left out of
// the absorb and only taking the XOR of the byte 7 before them.
__device__ __forceinline__ void split_absorb_prefix(uint32_t (&s)[4], uint32_t d, int n,
                                                    const SpongeLanes& ln) {
  uint32_t v[4], x[4], in[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    in[j] = 0u - (uint32_t)(4 * ln.r + j < n);
    x[j] = 0u;
    v[j] = 0u;
  }
  const int waves = (n + 6) / 7;
#pragma unroll 1
  for (int wave = 0; wave < waves; ++wave) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t t = (s[j] ^ (x[j] & ~ln.low(j))) + byte_of(d, j);
      v[j] = select_bits(0xF8u, t << 3, t >> 5) & in[j];
    }
    split_fetch7<8>(x, v, ln);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) s[j] = select_bits(in[j], v[j] ^ (x[j] & ln.low(j)), s[j] ^ x[j]);
}

}  // namespace stark
