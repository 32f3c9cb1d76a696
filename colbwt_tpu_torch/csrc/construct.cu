// Multi-MUM window kernel for Hopper (sm_90a): K8 and K9.
//
// Replaces two jitted XLA programs of colbwt_tpu/ops/construct_jax.py:
// _mum_scan_chunk (:245, K8: one chunk of C window starts with a 2N+2 halo,
// with _sliding_min :158) and multi_mum_scan (:193, K9: the whole array,
// which the wrapper pads as one chunk).  For every window start i of the
// chunk it evaluates the multi-MUM conditions of oracle.find_multi_mums:
//
//   ell      = min lcp[i+1 .. i+N-1]
//   uniq     = lcp[i] < ell and lcp[i+N] < ell
//   covers   = min over j in [i, i+N) of j + d[j] >= i + N, where d[j] is
//              the least t in [1, N+1] with docs[j+t] == docs[j], else N+1
//              (the cap is exact: a longer distance never breaks a window)
//   left_max = some run change in (i, i+N-1]
//   hit      = ell >= min_mum and uniq and covers and left_max and
//              i <= limit
//
// and writes ell (int32, C) and the hits packed little-endian, as
// jnp.packbits(bitorder="little") does: a 32-bit __ballot_sync of one warp
// stored as one little-endian word holds bit k of byte b at position
// 32w + 8b + k.  K9's argsort-built next-same-doc array is not carried
// over: the capped distance gives the same windows.
//
// What bounds it on an H100: the inputs are 7 bytes a position (lcp, the
// document id as uint16, the run-change byte), read once from device
// memory at 3.35 TB/s, about 0.14 ms at C = 2^26; the window loops read
// each element N times more, but neighbouring threads read neighbouring
// words, so those re-reads hit L1/L2.  The simple design: two passes, one
// thread per position each (distances into a scratch array, then the
// window test), O(N) work a position, as JAX's fori_loop over N+1 offsets
// does.  Sliding-window minima with O(1) work a position are later work.
//
// All in-chunk arithmetic is int32 (the wrapper keeps C + 2N + 2 < 2^31).
// Plain C interface (ctypes); launches on the caller's stream, allocates
// nothing and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// pass 1: d[j] for j in [0, C + N); reads docs[j .. j + N + 1]
template <typename Doc>
__global__ void next_same_doc_kernel(const Doc* __restrict__ docs,
                                     int32_t probe_len, int32_t N,
                                     int32_t* __restrict__ d) {
  const int32_t j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= probe_len) return;
  const Doc v = docs[j];
  int32_t dist = N + 1;
  for (int32_t t = 1; t <= N + 1; ++t) {
    if (docs[j + t] == v) {
      dist = t;
      break;
    }
  }
  d[j] = dist;
}

// pass 2: one thread per window start; every thread of a launched block
// reaches the ballot, and lane 0 of each warp that covers a start stores
// its word
__global__ void window_kernel(const int32_t* __restrict__ lcp,
                              const uint8_t* __restrict__ chg,
                              const int32_t* __restrict__ d, int32_t C,
                              int32_t N, int32_t limit, int32_t min_mum,
                              uint32_t* __restrict__ packed,
                              int32_t* __restrict__ ell_out) {
  const int32_t i = blockIdx.x * blockDim.x + threadIdx.x;
  bool hit = false;
  if (i < C) {
    int32_t ell = INT32_MAX;
    bool left_max = false;
    for (int32_t j = i + 1; j < i + N; ++j) {
      ell = min(ell, lcp[j]);
      left_max = left_max || chg[j] != 0;
    }
    const bool uniq = lcp[i] < ell && lcp[i + N] < ell;
    int32_t reach = INT32_MAX;
    for (int32_t j = i; j < i + N; ++j) reach = min(reach, j + d[j]);
    hit = ell >= min_mum && uniq && reach >= i + N && left_max && i <= limit;
    ell_out[i] = ell;
  }
  const unsigned word = __ballot_sync(0xffffffffu, hit);
  if ((threadIdx.x & 31) == 0 && i < C) packed[i >> 5] = word;
}

}  // namespace

extern "C" {

int colbwt_mum_window(const void* lcp, const void* docs, int64_t docs_u16,
                      const void* chg, int64_t C, int64_t N, int64_t limit,
                      int64_t min_mum, void* scratch, void* packed,
                      void* ell, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t probe_len = C + N;
  const int64_t blocks1 = (probe_len + kThreads - 1) / kThreads;
  if (docs_u16) {
    next_same_doc_kernel<uint16_t><<<blocks1, kThreads, 0, s>>>(
        static_cast<const uint16_t*>(docs), static_cast<int32_t>(probe_len),
        static_cast<int32_t>(N), static_cast<int32_t*>(scratch));
  } else {
    next_same_doc_kernel<int32_t><<<blocks1, kThreads, 0, s>>>(
        static_cast<const int32_t*>(docs), static_cast<int32_t>(probe_len),
        static_cast<int32_t>(N), static_cast<int32_t*>(scratch));
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t mm = min_mum > INT32_MAX ? INT32_MAX : min_mum;
  window_kernel<<<(C + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      static_cast<const int32_t*>(lcp), static_cast<const uint8_t*>(chg),
      static_cast<const int32_t*>(scratch), static_cast<int32_t>(C),
      static_cast<int32_t>(N), static_cast<int32_t>(limit),
      static_cast<int32_t>(mm), static_cast<uint32_t*>(packed),
      static_cast<int32_t*>(ell));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
