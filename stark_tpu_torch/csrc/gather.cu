// The query phase's gather for Hopper: kernel K13.  Replaces what the JAX
// package leaves to XLA to fuse into one dispatch per prove: the FRI
// rounds' value and sibling-path reads (stark_tpu/fri.py:_query_gather_fn,
// :307), the trace openings (stark_tpu/stark.py:_trace_open_fn, :201) and
// the packing of all of them into one buffer for one fetch (fri.py:
// _pack_u8_core, :339).  In eager torch the same reads are ~60 small
// launches; here they are one launch, and its output is one buffer that
// comes back to the host in one copy (ops/gather.py).
//
// Operands: the whole plan rides in the launch's parameter space, one
// __grid_constant__ struct of 4, 16 or 32 KB (32,764 bytes of parameters
// are allowed from CUDA 12.1 on, Volta and later), encoded on the host by
// ops/gather.py:GatherPlan.encode and RulePlan.encode, as 32-bit words:
//   header (8 words): n_src, n_slot, n_task, n_payload, out address (2),
//     index buffer address (2; rule slots only)
//   sources, 4 words each: address (2), a, kind << 31 | b
//     kind 0, field values: a (c, n) int32 array; a = n, b = c;
//     kind 1, a tree's level stack: a (2W - 1, 32) u8 array; a = W,
//       b = depth = log2 W; or a forest's, B trees of width 2^b side by
//       side, (2W - B, 32): leaf i of tree b is leaf b 2^b + i, and the
//       formula below gives its path;
//   slots, 4 words each: source | rule << 31, requests k, first output
//     word, its payload's first word; a request j < k of the slot writes
//     its w words (values: c; paths: 8 depth) from first + j w on;
//   tasks, 1 word each, a warp's: slot | first request j0 << 16
//     a warp takes 32 / w requests of a slot where w <= 32, else one;
//   payload: an index slot's indices, 1 word a request; a rule slot's rule
//     (ops/gather.py:Rule), 9 + F words: j_start, number, h | F << 8 |
//     order << 16, half - 1, wrap - 1 (all ones: no wrap), stride, own =
//     rank | log2 D << 8 | log2 points << 16 | shift << 24, lo, the output
//     stride between requests, then F offsets.  Request j of a rule slot
//     (j_start + j of the whole rule) is j = ((row h + e) number + q) F + u
//     (order 0) or ((row number + q) h + e) F + u (order 1), at the point
//       x = ((idx[row number + q] & (half - 1)) + e half + offset[u])
//         & (wrap - 1)
//     of its row, idx the (rows, number) u32 index buffer at the header's
//     address (the FRI query indices K10 writes on the card): the rule
//     slots carry no index, so a prove's plan is the same for every prove
//     of its shape.  The request is this rank's where (x << log2 D) >>
//     log2 points == rank (a single device: D = 1, points 2^32): it reads
//     index ((x - lo) >> shift) + row stride; on every other rank of a
//     mesh its words are zeros, so that the ranks' outputs sum to the
//     whole (parallel/pmerkle.py:ShardedRulePlan).  Its words lie from
//     first + j * (output stride) on.
// A request's words: values, src[i * n + index] for i < c; paths, the
// depth digests of index's authentication path, bottom-up: the sibling on
// level l is stack row 2W - 2W / 2^l + ((index >> l) ^ 1) (merkle.py:
// path_rows), 8 words each.
//
// What bounds it on the card: latency.  A Fibonacci T = 2^20 prove gathers
// ~0.4 MB in ~1.6k requests (0.13 us of device-memory time each way at
// 3.35 TB/s).  So the table rides in the constant bank that the launch
// itself carries: no copy goes up before the launch, and a warp's only
// trip to device memory is its data.  Lanes go to requests by width, so a
// warp serves 32 single-value requests at once and a path's 8 depth words
// take a warp.
#include <cuda_runtime.h>
#include <stdint.h>

constexpr uint32_t kHeaderWords = 8;

template <int kBytes>
struct GatherParams {
  uint32_t w[kBytes / 4];
};

// Every read of the table indexes the parameter struct itself (no pointer
// into it), so that each stays a load from the constant bank.
template <int kBytes>
__global__ void __launch_bounds__(256)
stark_query_gather_kernel(const __grid_constant__ GatherParams<kBytes> p) {
  const uint32_t n_src = p.w[0], n_slot = p.w[1], n_task = p.w[2];
  const uint32_t task = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (task >= n_task) return;
  uint32_t* out = reinterpret_cast<uint32_t*>((uint64_t)p.w[4] | (uint64_t)p.w[5] << 32);
  const uint32_t slots = kHeaderWords + 4 * n_src;
  const uint32_t tasks = slots + 4 * n_slot;
  const uint32_t t_word = p.w[tasks + task];
  const uint32_t slot = slots + 4 * (t_word & 0xffffu);
  const uint32_t j0 = t_word >> 16;
  const bool rule = p.w[slot] >> 31;
  const uint32_t src = kHeaderWords + 4 * (p.w[slot] & 0x7fffffffu);
  const uint32_t* base = reinterpret_cast<const uint32_t*>(
      (uint64_t)p.w[src] | (uint64_t)p.w[src + 1] << 32);
  const uint64_t a = p.w[src + 2];
  const bool path = p.w[src + 3] >> 31;
  const uint32_t b = p.w[src + 3] & 0x7fffffffu;
  const uint32_t width = path ? 8 * b : b;
  const uint32_t per_warp = width <= 32 ? 32 / width : 1;
  const uint32_t count = min(per_warp, p.w[slot + 1] - j0);
  const uint32_t payload = tasks + n_task + p.w[slot + 3];
  const uint32_t step = rule ? p.w[payload + 8] : width;
  uint32_t* dst = out + p.w[slot + 2];
  const uint32_t* idx = reinterpret_cast<const uint32_t*>(
      (uint64_t)p.w[6] | (uint64_t)p.w[7] << 32);
  for (uint32_t t = threadIdx.x & 31; t < count * width; t += 32) {
    const uint32_t q = count == 1 ? 0 : t / width;
    const uint32_t word = t - q * width;
    uint64_t i;
    bool mine = true;
    if (rule) {
      uint32_t j = p.w[payload] + j0 + q;
      const uint32_t number = p.w[payload + 1], shape = p.w[payload + 2];
      const uint32_t h = shape & 0xffu, f = (shape >> 8) & 0xffu;
      const uint32_t u = j % f;
      j /= f;
      uint32_t e, k, row;
      if (shape >> 16) {
        e = j % h;
        j /= h;
        k = j % number;
        row = j / number;
      } else {
        k = j % number;
        j /= number;
        e = j % h;
        row = j / h;
      }
      const uint32_t mask = p.w[payload + 3];
      const uint32_t x = ((idx[(uint64_t)row * number + k] & mask) + e * (mask + 1u) +
                          p.w[payload + 9 + u]) & p.w[payload + 4];
      const uint32_t own = p.w[payload + 6];
      mine = (((uint64_t)x << ((own >> 8) & 0xffu)) >> ((own >> 16) & 0xffu)) == (own & 0xffu);
      i = (uint64_t)((x - p.w[payload + 7]) >> (own >> 24)) + (uint64_t)row * p.w[payload + 5];
    } else {
      i = p.w[payload + j0 + q];
    }
    uint64_t at;
    if (path) {
      const int l = word >> 3;
      at = 8 * ((2 * a - ((2 * a) >> l)) + ((i >> l) ^ 1)) + (word & 7);
    } else {
      at = word * a + i;
    }
    dst[(uint64_t)(j0 + q) * step + word] = mine ? base[at] : 0u;
  }
}

namespace {

template <int kBytes>
int launch(const void* params, cudaStream_t stream) {
  const uint32_t n_task = static_cast<const uint32_t*>(params)[2];
  const int threads = 256;  // 8 warps, a task each
  const int blocks = (int)((n_task + 7) / 8);
  void* args[] = {const_cast<void*>(params)};
  return (int)cudaLaunchKernel((const void*)stark_query_gather_kernel<kBytes>,
                               dim3(blocks > 0 ? blocks : 1), dim3(threads),
                               args, 0, stream);
}

}  // namespace

// C linkage for the entry; the kernel is a template, which a profile shows
// as stark_query_gather_kernel<kBytes>.
extern "C" {

// params: the encoded plan, nbytes of it, one of the sizes
// ops/gather.py:PARAM_BYTES names (the struct the kernel is built for):
// the launch copies it into the parameter space.  One launch, on `stream`.
int stark_query_gather(const void* params, int nbytes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nbytes) {
    case 4096: return launch<4096>(params, s);
    case 16384: return launch<16384>(params, s);
    case 32752: return launch<32752>(params, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
