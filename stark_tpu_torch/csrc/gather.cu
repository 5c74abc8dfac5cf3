// The query phase's gather for Hopper: kernel K13.  Replaces what the JAX
// package leaves to XLA to fuse into one dispatch per prove: the FRI
// rounds' value and sibling-path reads (stark_tpu/fri.py:_query_gather_fn,
// :307), the trace openings (stark_tpu/stark.py:_trace_open_fn, :201) and
// the packing of all of them into one buffer for one fetch (fri.py:
// _pack_u8_core, :339).  In eager torch the same reads are ~60 small
// launches; here they are one launch, and its output is one buffer that
// comes back to the host in one copy (ops/gather.py).
//
// Operands, one int64 table built on the host (ops/gather.py:GatherPlan):
//   sources, 4 words each: device address, kind, a, b
//     kind 0, field values: a (c, n) int32 array; a = n, b = c;
//     kind 1, a tree's level stack: a (2W - 1, 32) u8 array; a = W,
//       b = depth = log2 W;
//   requests, 3 words each: source, index, first output word
//     values: the c words src[j * n + index], j < c;
//     paths: the depth digests of index's authentication path, bottom-up;
//       the sibling on level l is stack row 2W - 2W / 2^l + ((index >> l) ^ 1)
//       (merkle.py:path_rows), 8 words each.
//
// What bounds it on the card: nothing but latency.  A Fibonacci T = 2^20
// prove gathers ~0.45 MB in ~1.6k requests (0.3 us of device-memory time at
// 3.35 TB/s); each request costs a table read and then its dependent loads.
// So the design is the plainest one that keeps every access coalesced where
// the data allows: a warp per request, grid-stride over requests, lanes over
// the request's words, so a warp reads four whole 32-byte digests per turn.
#include <cuda_runtime.h>
#include <stdint.h>

// C linkage, so that a profile names the kernel plainly.
extern "C" {

__global__ void stark_query_gather_kernel(const long long* __restrict__ table,
                                          int n_src, int n_req,
                                          uint32_t* __restrict__ out) {
  const long long* reqs = table + 4 * (long long)n_src;
  const int lane = threadIdx.x & 31;
  const int warps = (gridDim.x * blockDim.x) >> 5;
  for (int r = (blockIdx.x * blockDim.x + threadIdx.x) >> 5; r < n_req;
       r += warps) {
    const long long* req = reqs + 3 * (long long)r;
    const long long* src = table + 4 * req[0];
    const long long index = req[1];
    uint32_t* dst = out + req[2];
    const uint32_t* base = reinterpret_cast<const uint32_t*>(src[0]);
    const int b = (int)src[3];
    if (src[1] == 0) {
      const long long n = src[2];
      for (int j = lane; j < b; j += 32) dst[j] = base[j * n + index];
    } else {
      const long long w2 = 2 * src[2];
      for (int t = lane; t < 8 * b; t += 32) {
        const int l = t >> 3;
        const long long row = (w2 - (w2 >> l)) + ((index >> l) ^ 1);
        dst[t] = base[8 * row + (t & 7)];
      }
    }
  }
}

// table: 4 * n_src + 3 * n_req int64 words on the card; out: the output
// words.  One launch, on ``stream``.
int stark_query_gather(const void* table, int n_src, int n_req, void* out,
                       void* stream) {
  const int threads = 256;  // 8 warps, a request each
  int blocks = (n_req + 7) / 8;
  if (blocks > 1024) blocks = 1024;
  if (blocks < 1) blocks = 1;
  stark_query_gather_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      static_cast<const long long*>(table), n_src, n_req,
      static_cast<uint32_t*>(out));
  return (int)cudaGetLastError();
}

}  // extern "C"
