/* Native host engine for the stark_tpu_torch control plane (a copy of
 * stark_tpu/native/hash.c, so the port never imports the JAX package).
 *
 * Bit-exact C implementation of the commitment hash (contract: reference
 * src/hash.rs:7-99) plus the host-sequential protocol loops built on it:
 * FRI index sampling (fri.rs:168-213), Merkle levels and Merkle path
 * verification (merkle.rs:18-29, 82-96).
 *
 * Bulk hashing runs on the device (ops/hash_batch.py); this library takes
 * the host-side scalar path and the narrow Merkle levels.
 *
 * Build (done at first use by utils/build.py):
 *   cc -O3 -shared -fPIC -o libstark_host.so hash.c
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

static const uint8_t PRIMES[16] = {2, 3, 5, 7, 11, 13, 17, 19,
                                   23, 29, 31, 37, 41, 43, 47, 53};

/* hash.rs:96-99 */
static const uint8_t RC[32] = {
    0x01, 0x02, 0x04, 0x08, 0x10, 0x20, 0x40, 0x80,
    0x1B, 0x36, 0x6C, 0xD8, 0xAB, 0x4D, 0x9A, 0x2F,
    0x5E, 0xBC, 0x63, 0xC6, 0x97, 0x35, 0x6A, 0xD4,
    0xB3, 0x7D, 0xFA, 0xEF, 0xC5, 0x91, 0x39, 0x72};

static inline uint8_t rotl8(uint8_t x, int n) {
  return (uint8_t)((uint8_t)(x << n) | (x >> (8 - n)));
}

/* One mix round (hash.rs:59-86). */
static void mix_state(uint8_t s[32]) {
  uint8_t t[32];
  int i;
  /* sbox: mul 251 mod 256, rotl 1, xor 0x63 (hash.rs:88-94) */
  for (i = 0; i < 32; i++)
    t[i] = (uint8_t)(rotl8((uint8_t)(s[i] * 251u), 1) ^ 0x63u);
  /* 4-byte-group XOR mixing (hash.rs:63-75) */
  for (i = 0; i < 8; i++) {
    uint8_t a = t[4 * i], b = t[4 * i + 1], c = t[4 * i + 2], d = t[4 * i + 3];
    s[4 * i] = (uint8_t)(a ^ b ^ d);
    s[4 * i + 1] = (uint8_t)(a ^ c ^ d);
    s[4 * i + 2] = (uint8_t)(a ^ b ^ c);
    s[4 * i + 3] = (uint8_t)(b ^ c ^ d);
  }
  /* sequential in-place neighbor diffusion (hash.rs:77-81) */
  for (i = 0; i < 32; i++)
    s[i] = (uint8_t)(s[i] + s[(i + 1) & 31] + s[(i + 31) & 31]);
  /* round constants (hash.rs:83-85) */
  for (i = 0; i < 32; i++) s[i] = (uint8_t)(s[i] + RC[i]);
}

/* 32-byte digest of data (hash.rs:7-30). */
void stark_hash(const uint8_t *data, uint64_t len, uint8_t out[32]) {
  uint8_t s[32];
  uint64_t start;
  int i;
  for (i = 0; i < 32; i++) s[i] = PRIMES[i & 15];
  for (start = 0; start < len; start += 32) {
    uint64_t chunk = len - start < 32 ? len - start : 32;
    for (i = 0; i < (int)chunk; i++) {
      uint8_t v = (uint8_t)(s[i] + data[start + i]);
      v = rotl8(v, 3);
      s[i] = v;
      s[(i + 7) & 31] ^= v;
    }
    mix_state(s);
  }
  for (i = 0; i < 8; i++) mix_state(s);
  memcpy(out, s, 32);
}

/* Hash::combine (hash.rs:41-46). */
void stark_combine(const uint8_t left[32], const uint8_t right[32],
                   uint8_t out[32]) {
  uint8_t buf[64];
  memcpy(buf, left, 32);
  memcpy(buf + 32, right, 32);
  stark_hash(buf, 64, out);
}

/* Fold 32 digest bytes into a u128 accumulator mod size (fri.rs:168-174). */
static uint64_t sample_index(const uint8_t d[32], uint64_t size) {
  unsigned __int128 acc = 0;
  int i;
  for (i = 0; i < 32; i++) acc = (acc << 8) ^ d[i];
  return (uint64_t)(acc % size);
}

/* sample_indices (fri.rs:176-213): seeded hash + LE u32 counter, dedup on
 * index %% reduced_size, keep the unreduced index.  Returns the number of
 * counter iterations used (indices written to out).  reduced_size must be
 * <= 2^32 (a bitmap is allocated). */
int64_t stark_sample_indices(const uint8_t seed[32], uint64_t size,
                             uint64_t reduced_size, uint64_t number,
                             uint64_t *out) {
  uint8_t buf[36];
  uint8_t d[32];
  uint8_t *seen;
  uint64_t found = 0;
  uint32_t counter = 0;
  if (number > reduced_size) return -1;
  seen = (uint8_t *)calloc((reduced_size + 7) / 8, 1);
  if (!seen) return -2;
  memcpy(buf, seed, 32);
  while (found < number) {
    uint64_t idx, red;
    buf[32] = (uint8_t)(counter & 0xFF);
    buf[33] = (uint8_t)((counter >> 8) & 0xFF);
    buf[34] = (uint8_t)((counter >> 16) & 0xFF);
    buf[35] = (uint8_t)((counter >> 24) & 0xFF);
    stark_hash(buf, 36, d);
    idx = sample_index(d, size);
    red = idx % reduced_size;
    counter++;
    if (!(seen[red >> 3] & (1u << (red & 7)))) {
      seen[red >> 3] |= (uint8_t)(1u << (red & 7));
      out[found++] = idx;
    }
  }
  free(seen);
  return (int64_t)counter;
}

/* ---- SoA lane-parallel hash engine ----------------------------------
 *
 * The byte hash run across SOA_K independent states at once: state is
 * s[32][SOA_K] — byte-position-major, lane-minor — so every per-byte
 * step of the scalar state machine (sbox, group XOR, the sequential
 * in-place diffusion, absorb) becomes one SOA_K-wide inner loop with a
 * constant trip count that the compiler auto-vectorizes (SSE2 = 4 ops
 * per row, AVX2 = 2).  Same layout trick as the TPU engine across
 * vector lanes (ops/hash_batch.py).  Bit-exactness: each lane's
 * sequence of byte ops is IDENTICAL to stark_hash/mix_state above
 * (hash.rs:7-99) — the loops below keep the exact in-place update
 * order of the scalar code. */
#define SOA_K 64

static void soa_mix(uint8_t s[32][SOA_K]) {
  uint8_t t[32][SOA_K];
  int i, q;
  /* sbox (hash.rs:88-94) */
  for (i = 0; i < 32; i++)
    for (q = 0; q < SOA_K; q++)
      t[i][q] = (uint8_t)(rotl8((uint8_t)(s[i][q] * 251u), 1) ^ 0x63u);
  /* 4-byte-group XOR mixing (hash.rs:63-75) */
  for (i = 0; i < 8; i++)
    for (q = 0; q < SOA_K; q++) {
      uint8_t a = t[4 * i][q], b = t[4 * i + 1][q];
      uint8_t c = t[4 * i + 2][q], d = t[4 * i + 3][q];
      s[4 * i][q] = (uint8_t)(a ^ b ^ d);
      s[4 * i + 1][q] = (uint8_t)(a ^ c ^ d);
      s[4 * i + 2][q] = (uint8_t)(a ^ b ^ c);
      s[4 * i + 3][q] = (uint8_t)(b ^ c ^ d);
    }
  /* sequential in-place neighbor diffusion (hash.rs:77-81): the i loop
   * order + in-place updates replicate the scalar semantics per lane. */
  for (i = 0; i < 32; i++)
    for (q = 0; q < SOA_K; q++)
      s[i][q] =
          (uint8_t)(s[i][q] + s[(i + 1) & 31][q] + s[(i + 31) & 31][q]);
  for (i = 0; i < 32; i++)
    for (q = 0; q < SOA_K; q++) s[i][q] = (uint8_t)(s[i][q] + RC[i]);
}

/* Absorb one chunk of chunk_len (<= 32) bytes into every lane
 * (hash.rs:14-23; same ascending-i in-place order as stark_hash). */
static void soa_absorb(uint8_t s[32][SOA_K],
                       const uint8_t chunk[32][SOA_K], int chunk_len) {
  int i, q;
  for (i = 0; i < chunk_len; i++)
    for (q = 0; q < SOA_K; q++) {
      uint8_t v = rotl8((uint8_t)(s[i][q] + chunk[i][q]), 3);
      s[i][q] = v;
      s[(i + 7) & 31][q] ^= v;
    }
}

/* Hash K lane rows of len bytes each (rows ``stride`` apart) into SoA
 * digests s[32][SOA_K]; lanes >= K compute garbage on zero input and are
 * ignored by the caller. */
static void soa_hash(const uint8_t *in, uint64_t stride, uint64_t len,
                     int K, uint8_t s[32][SOA_K]) {
  uint8_t chunk[32][SOA_K];
  uint64_t start;
  int i, q;
  for (i = 0; i < 32; i++)
    for (q = 0; q < SOA_K; q++) s[i][q] = PRIMES[i & 15];
  for (start = 0; start < len; start += 32) {
    int clen = (int)(len - start < 32 ? len - start : 32);
    memset(chunk, 0, sizeof(chunk));
    for (i = 0; i < clen; i++)
      for (q = 0; q < K; q++) chunk[i][q] = in[q * stride + start + i];
    soa_absorb(s, chunk, clen);
    soa_mix(s);
  }
  for (i = 0; i < 8; i++) soa_mix(s);
}

/* Hash::combine across lanes: 64-byte hash of (left || right) given as
 * the two 32-byte chunk planes (hash.rs:41-46). */
static void soa_combine(uint8_t cur[32][SOA_K],
                        const uint8_t chl[32][SOA_K],
                        const uint8_t chr[32][SOA_K]) {
  int i, q;
  for (i = 0; i < 32; i++)
    for (q = 0; q < SOA_K; q++) cur[i][q] = PRIMES[i & 15];
  soa_absorb(cur, chl, 32);
  soa_mix(cur);
  soa_absorb(cur, chr, 32);
  soa_mix(cur);
  for (i = 0; i < 8; i++) soa_mix(cur);
}

/* Leaf digests of u64 values: Hash::from_field_elements(&[v]) per value
 * (hash.rs:32-39) — 8 LE bytes each; SOA_K values per SoA tile. */
void stark_hash_u64s(const uint64_t *values, uint64_t count, uint8_t *out) {
  uint64_t base;
  for (base = 0; base < count; base += SOA_K) {
    int K = (int)(count - base < SOA_K ? count - base : SOA_K);
    uint8_t le[SOA_K][8];
    uint8_t s[32][SOA_K];
    int q, b, i;
    for (q = 0; q < K; q++) {
      uint64_t v = values[base + q];
      for (b = 0; b < 8; b++) le[q][b] = (uint8_t)(v >> (8 * b));
    }
    soa_hash(&le[0][0], 8, 8, K, s);
    for (q = 0; q < K; q++)
      for (i = 0; i < 32; i++) out[(base + q) * 32 + i] = s[i][q];
  }
}

/* All tree levels bottom-up from w leaf digests (merkle.rs:18-29):
 * out receives 2w-1 digests — level 0 (w), level 1 (w/2), ..., root.
 * Each level's pairwise combines run SOA_K lanes at a time. */
void stark_merkle_levels(const uint8_t *leaves, uint64_t w, uint8_t *out) {
  uint64_t off = 0, base;
  memcpy(out, leaves, w * 32);
  while (w > 1) {
    const uint8_t *cur = out + off * 32;
    uint8_t *nxt = out + (off + w) * 32;
    for (base = 0; base < w / 2; base += SOA_K) {
      int K = (int)(w / 2 - base < SOA_K ? w / 2 - base : SOA_K);
      uint8_t chl[32][SOA_K], chr[32][SOA_K], s[32][SOA_K];
      int q, j;
      memset(chl, 0, sizeof(chl));
      memset(chr, 0, sizeof(chr));
      for (q = 0; q < K; q++)
        for (j = 0; j < 32; j++) {
          chl[j][q] = cur[64 * (base + q) + j];
          chr[j][q] = cur[64 * (base + q) + 32 + j];
        }
      soa_combine(s, chl, chr);
      for (q = 0; q < K; q++)
        for (j = 0; j < 32; j++) nxt[32 * (base + q) + j] = s[j][q];
    }
    off += w;
    w /= 2;
  }
}

/* Merkle path verification (merkle.rs:82-96): refold by index parity. */
int stark_merkle_verify(const uint8_t leaf[32], uint64_t index,
                        const uint8_t *path, uint64_t path_len,
                        const uint8_t root[32]) {
  uint8_t cur[32];
  uint64_t l;
  memcpy(cur, leaf, 32);
  for (l = 0; l < path_len; l++) {
    uint8_t nxt[32];
    if ((index & 1) == 0)
      stark_combine(cur, path + 32 * l, nxt);
    else
      stark_combine(path + 32 * l, cur, nxt);
    memcpy(cur, nxt, 32);
    index >>= 1;
  }
  return memcmp(cur, root, 32) == 0;
}

/* Batched path verification: k paths of equal length, each with its own
 * leaf ROW of c raw u64 values (leaf digest = stark_hash of the 8*c LE
 * bytes, matching Hash::from_field_elements — hash.rs:32-35), index and
 * root.  Returns -1 when every path verifies, else the smallest failing
 * path position (the caller maps it back to the reference's per-path
 * failure reason).  Lane-parallel: paths are processed in SOA_K-wide
 * tiles, every tree level one SoA combine across the tile
 * (merkle.rs:82-96 refold-by-parity semantics per lane). */
int64_t stark_merkle_verify_batch(const uint64_t *leaf_values, uint64_t c,
                                  const uint64_t *indices,
                                  const uint8_t *paths, uint64_t path_len,
                                  const uint8_t *roots, uint64_t k) {
  uint64_t base, l, j;
  if (c == 0 || c > 64) return -2; /* caller falls back */
  for (base = 0; base < k; base += SOA_K) {
    int K = (int)(k - base < SOA_K ? k - base : SOA_K);
    uint8_t le[SOA_K][8 * 64];
    uint8_t cur[32][SOA_K], chl[32][SOA_K], chr[32][SOA_K];
    int i, q, b;
    for (q = 0; q < K; q++)
      for (j = 0; j < c; j++) {
        uint64_t v = leaf_values[(base + q) * c + j];
        for (b = 0; b < 8; b++) le[q][8 * j + b] = (uint8_t)(v >> (8 * b));
      }
    soa_hash(&le[0][0], sizeof(le[0]), 8 * c, K, cur);
    for (l = 0; l < path_len; l++) {
      /* Gather (left || right) = parity-ordered (cur, sibling) pairs
       * into the two 32-byte chunk planes of the 64-byte combine. */
      memset(chl, 0, sizeof(chl));
      memset(chr, 0, sizeof(chr));
      for (q = 0; q < K; q++) {
        const uint8_t *sib = paths + ((base + q) * path_len + l) * 32;
        int bit = (int)((indices[base + q] >> l) & 1);
        for (i = 0; i < 32; i++) {
          uint8_t cv = cur[i][q];
          chl[i][q] = bit ? sib[i] : cv;
          chr[i][q] = bit ? cv : sib[i];
        }
      }
      soa_combine(cur, chl, chr);
    }
    for (q = 0; q < K; q++)
      for (i = 0; i < 32; i++)
        if (cur[i][q] != roots[(base + q) * 32 + i])
          return (int64_t)(base + q);
  }
  return -1;
}
