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

}  // namespace stark
