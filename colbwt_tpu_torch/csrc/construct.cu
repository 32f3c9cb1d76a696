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
//              (the cap is exact: a longer distance never breaks a window),
//              that is, the N documents of [i, i+N) are all distinct
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
// What bounds it on an H100: the bytes, 11.1 a position at N = 16 (lcp,
// the document id as uint16 and the run-change byte read once, ell and the
// hit bit written once), 0.22 ms at C = 2^26.  The design (mum_tile_kernel):
// a block a tile of kMumTile window starts, its inputs for [tile, tile +
// kMumTile + N + 1) staged into shared memory once with 16-byte loads; no
// scratch array in device memory.  ell is a sliding minimum in shared
// memory by floor(log2(N - 1)) doubling passes (f_2s[k] = min(f_s[k],
// f_s[k+s]), then min(f_s[k], f_s[k+N-1-s]), as JAX's _sliding_min below
// w = 128); left_max a difference of two prefix counts of the run-change
// marks (a warp's ballot a 32-position word, the words' prefix by one
// warp); coverage is tested only where the other conditions hold: a 64-bit
// mask of the window's documents up to N = 64, else (or where a document
// id is 64 or more) the capped next-same-document probe over shared
// memory.  Per-position work does not grow with N but for the log2 passes.
//
// Above kMumTileMaxN (ops/construct.py _TILE_MAX_N) the halo outgrows the
// tile and a candidate's probe grows as N^2, so the wrapper routes such
// shapes to the earlier two-pass kernels (mum_window_two_pass): distances
// into a scratch array, then the window test, O(N) work a position.
//
// All in-chunk arithmetic is int32 (the wrapper keeps C + 2N + 2 < 2^31).
// Plain C interface (ctypes); launches on the caller's stream, allocates
// nothing and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMumTile = 2048;      // window starts a block
constexpr int kMumThreads = 256;
constexpr int kMumTileMaxN = 1024;  // the tile route's largest N
constexpr int kMaskN = 64;          // coverage by a 64-bit mask up to here
constexpr int kThreads = 256;       // the two-pass kernels' blocks

static_assert(kMumTile % kMumThreads == 0 && kMumThreads % 32 == 0,
              "a tile is whole warps of starts");

__host__ __device__ constexpr int round_up(int x, int k) {
  return (x + k - 1) / k * k;
}

// The shared layout of a tile for N: lcp of positions [0, T + N], the two
// ping-pong arrays of the doubling passes, the documents of [0, T + N),
// the run-change bytes of [0, 32 words), each 16-byte aligned; then the
// run-change words and their prefix.
__host__ __device__ constexpr int lcp_slots(int N) {
  return round_up(kMumTile + N + 1, 4);
}
template <typename Doc>
__host__ __device__ constexpr int doc_slots(int N) {
  return round_up(kMumTile + N, 16 / static_cast<int>(sizeof(Doc)));
}
__host__ __device__ constexpr int mark_words(int N) {
  return ((kMumTile + N) >> 5) + 1;
}
template <typename Doc>
__host__ __device__ constexpr int tile_smem_bytes(int N) {
  return 12 * lcp_slots(N) + static_cast<int>(sizeof(Doc)) * doc_slots<Doc>(N)
         + 32 * mark_words(N) + 8 * mark_words(N);
}

// dst[k] = src[base + k] for k < count, `fill` where base + k >= len; a
// 16-byte load a thread where src + base is 16-byte aligned (dst is)
template <typename T>
__device__ __forceinline__ void stage(T* __restrict__ dst,
                                      const T* __restrict__ src,
                                      int32_t base, int32_t count,
                                      int32_t len, T fill) {
  constexpr int kVec = 16 / sizeof(T);
  const int32_t avail = max(0, min(count, len - base));
  int32_t done = 0;
  if ((reinterpret_cast<uintptr_t>(src + base) & 15) == 0) {
    const int32_t vecs = avail / kVec;
    const uint4* s4 = reinterpret_cast<const uint4*>(src + base);
    uint4* d4 = reinterpret_cast<uint4*>(dst);
#pragma unroll 4
    for (int32_t v = threadIdx.x; v < vecs; v += blockDim.x) {
      d4[v] = __ldg(s4 + v);
    }
    done = vecs * kVec;
  }
  for (int32_t k = done + threadIdx.x; k < count; k += blockDim.x) {
    dst[k] = k < avail ? src[base + k] : fill;
  }
}

// the N documents at d are all distinct
template <typename Doc>
__device__ bool distinct_docs(const Doc* d, int32_t N) {
  if (N <= kMaskN) {
    uint64_t mask = 0;
    bool wide = false;  // an id of 64 or more (or negative): probe instead
    for (int32_t j = 0; j < N; ++j) {
      const uint32_t v = static_cast<uint32_t>(d[j]);
      wide |= v >= 64;
      mask |= uint64_t{1} << (v & 63);
    }
    if (__popcll(mask) == N) return true;
    if (!wide) return false;
  }
  // the capped next-same-document probe: does docs[j] recur before the
  // window's end
  for (int32_t j = 0; j + 1 < N; ++j) {
    const Doc v = d[j];
    for (int32_t t = j + 1; t < N; ++t) {
      if (d[t] == v) return false;
    }
  }
  return true;
}

template <typename Doc>
__global__ void __launch_bounds__(kMumThreads)
    mum_tile_kernel(const int32_t* __restrict__ lcp,
                    const Doc* __restrict__ docs,
                    const uint8_t* __restrict__ chg, int32_t C, int32_t N,
                    int32_t limit, int32_t min_mum,
                    uint32_t* __restrict__ packed,
                    int32_t* __restrict__ ell_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int32_t L = C + 2 * N + 2;
  const int32_t t0 = blockIdx.x * kMumTile;
  int32_t* s_lcp = reinterpret_cast<int32_t*>(smem);
  int32_t* s_f = s_lcp + lcp_slots(N);
  int32_t* s_g = s_f + lcp_slots(N);
  Doc* s_docs = reinterpret_cast<Doc*>(s_g + lcp_slots(N));
  const int32_t words = mark_words(N);
  uint8_t* s_chg = reinterpret_cast<uint8_t*>(s_docs + doc_slots<Doc>(N));
  uint32_t* s_marks = reinterpret_cast<uint32_t*>(s_chg + 32 * words);
  uint32_t* s_wp = s_marks + words;

  stage(s_lcp, lcp, t0, kMumTile + N + 1, L, 0);
  stage(s_docs, docs, t0, kMumTile + N, L, Doc(0));
  stage(s_chg, chg, t0, 32 * words, L, uint8_t{0});
  __syncthreads();
  // run-change marks of positions t0 .. t0 + 32 words - 1, a word a warp's
  // ballot (every lane of a warp takes the same trips)
  for (int32_t k = threadIdx.x; k < 32 * words; k += blockDim.x) {
    const unsigned w = __ballot_sync(0xffffffffu, s_chg[k] != 0);
    if ((threadIdx.x & 31) == 0) s_marks[k >> 5] = w;
  }
  __syncthreads();
  // marks below word w, by warp 0
  if (threadIdx.x < 32) {
    const int32_t lane = threadIdx.x;
    const int32_t per = (words + 31) / 32;
    const int32_t w0 = lane * per, w1 = min(w0 + per, words);
    int32_t sum = 0;
    for (int32_t w = w0; w < w1; ++w) sum += __popc(s_marks[w]);
    int32_t incl = sum;
    for (int o = 1; o < 32; o <<= 1) {
      const int32_t v = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += v;
    }
    int32_t run = incl - sum;
    for (int32_t w = w0; w < w1; ++w) {
      s_wp[w] = run;
      run += __popc(s_marks[w]);
    }
  }
  // ell: doubling passes over x[k] = lcp[t0 + 1 + k]; f_s is needed at
  // k < T + w - s for the final min
  const int32_t w = N - 1;
  const int32_t* f = s_lcp + 1;
  int32_t* dst = s_f;
  int32_t s = 1;
  while (2 * s <= w) {
    __syncthreads();
    const int32_t len = kMumTile + w - 2 * s;
    for (int32_t k = threadIdx.x; k < len; k += blockDim.x) {
      dst[k] = min(f[k], f[k + s]);
    }
    f = dst;
    dst = dst == s_f ? s_g : s_f;
    s *= 2;
  }
  __syncthreads();
  const int32_t shift = w - s;
  auto marks_below = [&](int32_t p) {
    return s_wp[p >> 5] + __popc(s_marks[p >> 5] & ((1u << (p & 31)) - 1));
  };
  for (int32_t k = threadIdx.x; k < kMumTile; k += kMumThreads) {
    const int32_t i = t0 + k;
    bool hit = false;
    if (i < C) {
      const int32_t ell = min(f[k], f[k + shift]);
      const bool uniq = s_lcp[k] < ell && s_lcp[k + N] < ell;
      // run changes at (i, i+N-1]: marks below i+N less marks below i+1
      const bool left_max = marks_below(k + N) > marks_below(k + 1);
      if (ell >= min_mum && uniq && left_max && i <= limit) {
        hit = distinct_docs(s_docs + k, N);
      }
      ell_out[i] = ell;
    }
    const unsigned word = __ballot_sync(0xffffffffu, hit);
    if ((threadIdx.x & 31) == 0 && i < C) packed[i >> 5] = word;
  }
}

// The tile kernel's shared memory past 48 KB (the largest N it takes),
// allowed once a device and document type.
template <typename Doc>
cudaError_t mum_allow_smem() {
  constexpr int kMaxDevices = 64;
  static bool allowed[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && allowed[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(mum_tile_kernel<Doc>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             tile_smem_bytes<Doc>(kMumTileMaxN));
  if (err == cudaSuccess && dev < kMaxDevices) allowed[dev] = true;
  return err;
}

template <typename Doc>
cudaError_t launch_tile(const void* lcp, const void* docs, const void* chg,
                        int32_t C, int32_t N, int32_t limit, int32_t min_mum,
                        void* packed, void* ell, cudaStream_t s) {
  const cudaError_t err = mum_allow_smem<Doc>();
  if (err != cudaSuccess) return err;
  mum_tile_kernel<Doc><<<(C + kMumTile - 1) / kMumTile, kMumThreads,
                         tile_smem_bytes<Doc>(N), s>>>(
      static_cast<const int32_t*>(lcp), static_cast<const Doc*>(docs),
      static_cast<const uint8_t*>(chg), C, N, limit, min_mum,
      static_cast<uint32_t*>(packed), static_cast<int32_t*>(ell));
  return cudaGetLastError();
}

// The large-N route, pass 1: d[j] for j in [0, C + N); reads
// docs[j .. j + N + 1]
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

int32_t clamp_i32(int64_t v) {
  return static_cast<int32_t>(v > INT32_MAX ? INT32_MAX
                              : v < INT32_MIN ? INT32_MIN : v);
}

}  // namespace

extern "C" {

// The tile route: one launch; 2 <= N <= kMumTileMaxN, C >= 1, C + 2N + 2 <
// 2^31; lcp, docs (uint16 if docs_u16, else int32), chg (uint8) of C + 2N
// + 2 positions; packed gets ceil(C / 32) words, ell C int32.
int colbwt_mum_window(const void* lcp, const void* docs, int64_t docs_u16,
                      const void* chg, int64_t C, int64_t N, int64_t limit,
                      int64_t min_mum, void* packed, void* ell,
                      void* stream) {
  if (N < 2 || N > kMumTileMaxN || C < 1 ||
      C + 2 * N + 2 >= (int64_t{1} << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t c = static_cast<int32_t>(C), n = static_cast<int32_t>(N);
  const cudaError_t err =
      docs_u16 ? launch_tile<uint16_t>(lcp, docs, chg, c, n, clamp_i32(limit),
                                       clamp_i32(min_mum), packed, ell, s)
               : launch_tile<int32_t>(lcp, docs, chg, c, n, clamp_i32(limit),
                                      clamp_i32(min_mum), packed, ell, s);
  return static_cast<int>(err);
}

// The large-N route: two launches, `scratch` C + N int32 for the
// distances; the same arguments otherwise, any N >= 2.
int colbwt_mum_window_two_pass(const void* lcp, const void* docs,
                               int64_t docs_u16, const void* chg, int64_t C,
                               int64_t N, int64_t limit, int64_t min_mum,
                               void* scratch, void* packed, void* ell,
                               void* stream) {
  if (N < 2 || C < 1 || C + 2 * N + 2 >= (int64_t{1} << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
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
  window_kernel<<<(C + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      static_cast<const int32_t*>(lcp), static_cast<const uint8_t*>(chg),
      static_cast<const int32_t*>(scratch), static_cast<int32_t>(C),
      static_cast<int32_t>(N), clamp_i32(limit), clamp_i32(min_mum),
      static_cast<uint32_t*>(packed), static_cast<int32_t*>(ell));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
