// The commitment hash, one lane per thread (reference src/hash.rs:7-99,
// bit-exact with hashfn.py and native/hash.c).
//
// The 32-byte state of a lane is 32 registers, one byte value each in the
// low bits of a uint32_t.  Every index into the state is a compile-time
// constant: the loops over state bytes have constant bounds and are fully
// unrolled, and the absorb position is a template argument, so nothing
// here forces the state into local memory.  Byte arithmetic is mod 256:
// 32-bit sums and products are masked with 0xFF before any shift, compare
// or store that could see the high bits.
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

// Absorb one byte at chunk position kPos (hash.rs:14-23): wrapping add,
// rotate left by 3, store, and XOR into position kPos + 7 mod 32.
template <int kPos>
__device__ __forceinline__ void absorb_byte(uint32_t (&s)[32], uint32_t b) {
  const uint32_t t = (s[kPos] + b) & 0xFFu;
  const uint32_t v = ((t << 3) | (t >> 5)) & 0xFFu;
  s[kPos] = v;
  s[(kPos + 7) & 31] ^= v;
}

// Absorb the four bytes of a little-endian word at positions kPos..kPos+3.
template <int kPos>
__device__ __forceinline__ void absorb_word(uint32_t (&s)[32], uint32_t w) {
  absorb_byte<kPos>(s, w & 0xFFu);
  absorb_byte<kPos + 1>(s, (w >> 8) & 0xFFu);
  absorb_byte<kPos + 2>(s, (w >> 16) & 0xFFu);
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

__device__ __forceinline__ uint32_t sbox(uint32_t x) {
  const uint32_t y = (x * 251u) & 0xFFu;
  return (((y << 1) | (y >> 7)) & 0xFFu) ^ 0x63u;
}

// One mix round (hash.rs:59-86): sbox, XOR mixing in groups of four, the
// neighbour diffusion, round constants.  The diffusion is sequential in
// place in the reference: new[0] = g0 + g1 + g31, new[i] = new[i-1] + g[i]
// + g[i+1], new[31] = g31 + new[0] + new[30] - a chain of 31 dependent adds
// in registers.  The running sum stays unmasked (it cannot reach 2^32) and
// is masked where it is stored.
__device__ __forceinline__ void mix(uint32_t (&s)[32]) {
  constexpr uint32_t kRc[32] = {
      0x01, 0x02, 0x04, 0x08, 0x10, 0x20, 0x40, 0x80, 0x1B, 0x36, 0x6C,
      0xD8, 0xAB, 0x4D, 0x9A, 0x2F, 0x5E, 0xBC, 0x63, 0xC6, 0x97, 0x35,
      0x6A, 0xD4, 0xB3, 0x7D, 0xFA, 0xEF, 0xC5, 0x91, 0x39, 0x72};
  uint32_t g[32];
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const uint32_t a = sbox(s[4 * q]);
    const uint32_t b = sbox(s[4 * q + 1]);
    const uint32_t c = sbox(s[4 * q + 2]);
    const uint32_t d = sbox(s[4 * q + 3]);
    g[4 * q] = a ^ b ^ d;
    g[4 * q + 1] = a ^ c ^ d;
    g[4 * q + 2] = a ^ b ^ c;
    g[4 * q + 3] = b ^ c ^ d;
  }
  const uint32_t first = g[0] + g[1] + g[31];
  uint32_t run = first;
  s[0] = (run + kRc[0]) & 0xFFu;
#pragma unroll
  for (int i = 1; i < 31; ++i) {
    run += g[i] + g[i + 1];
    s[i] = (run + kRc[i]) & 0xFFu;
  }
  s[31] = (g[31] + first + run + kRc[31]) & 0xFFu;
}

// The eight closing mixes (hash.rs:25-27).
__device__ __forceinline__ void hash_finish(uint32_t (&s)[32]) {
#pragma unroll 1
  for (int r = 0; r < 8; ++r) mix(s);
}

// Hash::combine (hash.rs:41-46): the digest of left || right, 64 bytes, two
// full chunks.  Each digest arrives as two 16-byte words.
__device__ __forceinline__ void hash_combine(uint32_t (&s)[32], uint4 l0,
                                             uint4 l1, uint4 r0, uint4 r1) {
  hash_init(s);
  absorb_digest(s, l0, l1);
  mix(s);
  absorb_digest(s, r0, r1);
  mix(s);
  hash_finish(s);
}

__device__ __forceinline__ uint32_t pack4(uint32_t b0, uint32_t b1,
                                          uint32_t b2, uint32_t b3) {
  return b0 | (b1 << 8) | (b2 << 16) | (b3 << 24);
}

// The state as a digest: two 16-byte words, byte i of the digest = s[i].
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
