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
// Above kMumTileMaxN (ops/construct.py _TILE_MAX_N), where the coverage
// mask gives way to a probe that grows as N^2 (the tile route lost to the
// large-N one from 96 documents on, PERF.md), the wrapper routes such
// shapes to the large-N route (mum_window_two_pass), two launches whose
// work a window start does not grow with N:
//
//   pass 1 (mum_summary_kernel): for tiles of T positions (T = kSpan from
//     N = kSpan + 2, else the largest power of two <= N - 2, 1 below N =
//     3), the tile's least lcp and whether it holds a run change, into a
//     scratch array of ceil(L / T) int2;
//   pass 2 (mum_span_kernel): a block a span of kSpan window starts, a
//     thread 8 consecutive ones.  The window [i+1, i+N-1] of ell and left_max
//     runs from a's tile (a = i+1) to e's (e = i+N-1), which differ as N - 2
//     >= T: its head, a's tile from a on, is a suffix scan of the span's own
//     positions (kept in registers), its tail, e's tile up to e, a prefix scan
//     of the two spans that hold [t0+N-1, t0+kSpan+N-1] (in shared memory,
//     read back as 16-byte windows), and the tiles between come from pass 1:
//     the ones every start of the block covers (its core) reduced once a
//     block, at most one more on each side a start (van Herk/Gil-Werman on
//     tiles).  The segmented scans run on 8 consecutive positions a thread in
//     registers, across a tile's threads by warp shuffles and across its warps
//     through shared memory.  Coverage is tested only where the other
//     conditions hold: such windows are disjoint (two overlapping windows
//     cannot both have lcp[i], lcp[i+N] below their ell), so a chunk has at
//     most C/N + 1 and their O(N) tests cost O(C + N) in all.  The block tests
//     each in turn: the window's N ids marked in a shared bitmap of kIdBits
//     (atomicOr: a bit found set is a repeat), int32 ids in passes of kIdBits
//     over their [min, max] (no pass when max - min + 1 < N).
//
// What bounds the route on an H100 is the bytes, 11.1 a position (lcp, the
// document id as uint16 and the run-change byte read once, ell and the hit
// bit written once); it reads lcp and the run changes twice (pass 1 and pass
// 2's spans, the tails' from the L2) and the document ids only of the
// windows it tests.  Measured at 3.5x that bound, pass 2 takes most of it;
// issuing its reads up front did not move it, so its bytes do not hold it
// (PERF.md).
//
// All in-chunk arithmetic is int32 (the wrapper keeps C + 2N + 2 < 2^31).
// Plain C interface (ctypes); launches on the caller's stream, allocates
// nothing and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMumTile = 2048;      // window starts a block
constexpr int kMumThreads = 256;
constexpr int kMumTileMaxN = 64;    // the tile route's largest N
constexpr int kMaskN = 64;          // coverage by a 64-bit mask up to here
constexpr int kSpan = 2048;         // large-N route: window starts a block
constexpr int kSpanThreads = 256;
constexpr int kPerThread = kSpan / kSpanThreads;  // consecutive positions
constexpr int kIdBits = 65536;      // a coverage pass's bitmap of ids

static_assert(kMumTile % kMumThreads == 0 && kMumThreads % 32 == 0,
              "a tile is whole warps of starts");
static_assert(kPerThread == 8 && kSpanThreads == 256,
              "a thread scans 8 positions, a span is 8 warps");

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

// `kernel`'s shared memory past 48 KB, `bytes` at most, allowed once a
// device (`allowed`: a flag a device, one array a kernel)
constexpr int kMaxDevices = 64;
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes,
                       bool (&allowed)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && allowed[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess && dev < kMaxDevices) allowed[dev] = true;
  return err;
}

// the tile kernel's, to that of the largest N it takes
template <typename Doc>
cudaError_t mum_allow_smem() {
  static bool allowed[kMaxDevices] = {};
  return allow_smem(mum_tile_kernel<Doc>, tile_smem_bytes<Doc>(kMumTileMaxN),
                    allowed);
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

// ---------------------------------------------------------------------------
// The large-N route (mum_window_two_pass)
// ---------------------------------------------------------------------------

// The route's tile for N documents: kSpan from N = kSpan + 2, else the
// largest power of two <= N - 2 (1 below N = 3), so that a window's first
// and last positions (N - 2 apart) lie in different tiles, or (N = 2) are
// one position.  Returns log2 of it.
__host__ __device__ inline int span_tile_shift(int32_t N) {
  int shift = 0;
  while (shift < 11 && (int32_t{2} << shift) <= N - 2) ++shift;
  return shift;
}
static_assert(kSpan == 1 << 11, "span_tile_shift stops at kSpan");

// (least lcp, any run change) of a stretch of positions
__device__ __forceinline__ int2 none() { return make_int2(INT32_MAX, 0); }
__device__ __forceinline__ int2 comb(int2 a, int2 b) {
  return make_int2(min(a.x, b.x), a.y | b.y);
}
__device__ __forceinline__ int2 shfl_up2(int2 v, int d) {
  return make_int2(__shfl_up_sync(0xffffffffu, v.x, d),
                   __shfl_up_sync(0xffffffffu, v.y, d));
}
__device__ __forceinline__ int2 shfl_down2(int2 v, int d) {
  return make_int2(__shfl_down_sync(0xffffffffu, v.x, d),
                   __shfl_down_sync(0xffffffffu, v.y, d));
}

// The raw inputs of 8 consecutive positions, base + 8 * threadIdx.x on:
// lcp in a and b, the run-change bytes in c
struct RawSpan {
  int4 a, b;
  uint2 c;
};

// two 16-byte and one 8-byte load where the pointers allow, else loads of
// the positions below L (INT32_MAX lcp, no run change past it)
__device__ __forceinline__ void load_raw(RawSpan& r,
                                         const int32_t* __restrict__ lcp,
                                         const uint8_t* __restrict__ chg,
                                         int64_t base, int32_t L) {
  const int64_t p = base + kPerThread * threadIdx.x;
  const bool lcp_vec = (reinterpret_cast<uintptr_t>(lcp) & 15) == 0;
  const bool chg_vec = (reinterpret_cast<uintptr_t>(chg) & 7) == 0;
  if (p + kPerThread <= L && lcp_vec && chg_vec) {
    const int4* l4 = reinterpret_cast<const int4*>(lcp + p);
    r.a = __ldg(l4);
    r.b = __ldg(l4 + 1);
    r.c = __ldg(reinterpret_cast<const uint2*>(chg + p));
    return;
  }
  int32_t x[kPerThread];
  uint32_t c[2] = {0, 0};
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    x[j] = p + j < L ? lcp[p + j] : INT32_MAX;
    c[j >> 2] |= (p + j < L ? uint32_t{chg[p + j]} : 0u) << (8 * (j & 3));
  }
  r.a = make_int4(x[0], x[1], x[2], x[3]);
  r.b = make_int4(x[4], x[5], x[6], x[7]);
  r.c = make_uint2(c[0], c[1]);
}

// v[j] = (lcp, run change) of the span's j-th position
__device__ __forceinline__ void unpack(const RawSpan& r,
                                       int2 (&v)[kPerThread]) {
  const int32_t x[kPerThread] = {r.a.x, r.a.y, r.a.z, r.a.w,
                                 r.b.x, r.b.y, r.b.z, r.b.w};
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const uint32_t word = j < 4 ? r.c.x : r.c.y;
    v[j] = make_int2(x[j], ((word >> (8 * (j & 3))) & 0xFF) != 0);
  }
}

// The inclusive scan of v (a span's positions) within tiles of 1 <<
// tshift positions: a prefix, or with kSuffix a suffix.  A tile's threads
// combine by warp shuffles, its warps (tiles past 256 positions) through
// s_warp, one int2 a warp; every thread of the block calls it.
template <bool kSuffix>
__device__ void tile_scan(int2 (&v)[kPerThread], int tshift, int2* s_warp) {
  const int T = 1 << tshift;
  const int p0 = kPerThread * threadIdx.x;
  if (kSuffix) {
#pragma unroll
    for (int j = kPerThread - 2; j >= 0; --j) {
      if (((p0 + j + 1) & (T - 1)) != 0) v[j] = comb(v[j], v[j + 1]);
    }
  } else {
#pragma unroll
    for (int j = 1; j < kPerThread; ++j) {
      if (((p0 + j) & (T - 1)) != 0) v[j] = comb(v[j - 1], v[j]);
    }
  }
  if (T <= kPerThread) return;
  const int lanes = T / kPerThread;  // threads a tile: 2 ... 256
  const int seg = min(lanes, 32);
  const int lane = threadIdx.x & 31;
  const int in_seg = lane & (seg - 1);
  int2 agg = kSuffix ? v[0] : v[kPerThread - 1];
  for (int d = 1; d < seg; d <<= 1) {
    if (kSuffix) {
      const int2 o = shfl_down2(agg, d);
      if (in_seg + d < seg) agg = comb(agg, o);
    } else {
      const int2 o = shfl_up2(agg, d);
      if (in_seg >= d) agg = comb(o, agg);
    }
  }
  int2 carry = kSuffix ? shfl_down2(agg, 1) : shfl_up2(agg, 1);
  if (in_seg == (kSuffix ? seg - 1 : 0)) carry = none();
  if (lanes > 32) {
    const int warp = threadIdx.x >> 5;
    const int per = lanes >> 5;  // warps a tile: 2 ... 8
    if (lane == (kSuffix ? 0 : 31)) s_warp[warp] = agg;
    __syncthreads();
    const int first = warp & ~(per - 1);
    for (int w = first; w < first + per; ++w) {
      if (kSuffix ? w > warp : w < warp) carry = comb(carry, s_warp[w]);
    }
  }
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) v[j] = comb(v[j], carry);
}

// Pass 1: summary[t] = (least lcp, any run change) of tile t's positions
// below L, for t < tiles; a block kSpan positions.
__global__ void __launch_bounds__(kSpanThreads)
    mum_summary_kernel(const int32_t* __restrict__ lcp,
                       const uint8_t* __restrict__ chg, int32_t L,
                       int tshift, int64_t tiles,
                       int2* __restrict__ summary) {
  __shared__ int2 s_warp[kSpanThreads / 32];
  const int64_t base = int64_t{blockIdx.x} * kSpan;
  RawSpan raw;
  load_raw(raw, lcp, chg, base, L);
  int2 v[kPerThread];
  unpack(raw, v);
  tile_scan<false>(v, tshift, s_warp);
  const int64_t T = int64_t{1} << tshift;
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int64_t p = base + kPerThread * threadIdx.x + j;
    if (((p + 1) & (T - 1)) == 0 && (p >> tshift) < tiles) {
      summary[p >> tshift] = v[j];
    }
  }
}

// Pass 2's shared memory: the tails' two spans of prefix-scanned lcp and
// of raw lcp (kPad past them for the last thread's aligned window), their
// scanned run-change flags (a byte of 8 positions), the scans' warp
// totals, each warp's first head, the hit words, the core and a coverage
// test's reductions; the coverage bitmap (kIdBits bits) reuses the
// scanned lcp once the window tests are done.
constexpr int kPad = 4;
constexpr int kSpanSmem = 2 * (2 * kSpan + kPad) * 4 + 2 * kSpan / 8
                          + 3 * (kSpanThreads / 32) * 8
                          + (kSpanThreads / 32) * 8 + kSpan / 32 * 4 + 8
                          + 17 * 4;
static_assert(kIdBits / 8 <= 2 * kSpan * 4, "the bitmap fits the tails");

// the N documents at d are all distinct; every thread of the block calls
// it.  The ids are marked in s_bits in passes of kIdBits over [min, max]
// (uint16 ids: one pass over all 65,536); an id found marked is a repeat.
template <typename Doc>
__device__ bool distinct_span(const Doc* __restrict__ d, int32_t N,
                              uint32_t* s_bits, int32_t* s_red) {
  __syncthreads();  // the previous test has read s_red and s_bits
  int64_t lo = 0, hi = 65535;
  if constexpr (sizeof(Doc) == 4) {
    int32_t mn = INT32_MAX, mx = INT32_MIN;
    for (int32_t j = threadIdx.x; j < N; j += kSpanThreads) {
      const int32_t v = d[j];
      mn = min(mn, v);
      mx = max(mx, v);
    }
    for (int o = 16; o > 0; o >>= 1) {
      mn = min(mn, __shfl_xor_sync(0xffffffffu, mn, o));
      mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    }
    if ((threadIdx.x & 31) == 0) {
      s_red[threadIdx.x >> 5] = mn;
      s_red[8 + (threadIdx.x >> 5)] = mx;
    }
    __syncthreads();
    mn = s_red[0];
    mx = s_red[8];
    for (int w = 1; w < kSpanThreads / 32; ++w) {
      mn = min(mn, s_red[w]);
      mx = max(mx, s_red[8 + w]);
    }
    lo = mn;
    hi = mx;
    if (hi - lo + 1 < N) return false;  // N distinct ids need N values
  }
  int32_t* s_dup = s_red + 16;
  for (int64_t base = lo; base <= hi; base += kIdBits) {
    const int64_t span = hi - base + 1 < kIdBits ? hi - base + 1 : kIdBits;
    const int32_t words = static_cast<int32_t>((span + 31) >> 5);
    for (int32_t k = threadIdx.x; k < words; k += kSpanThreads) s_bits[k] = 0;
    if (threadIdx.x == 0) *s_dup = 0;
    __syncthreads();
    bool dup = false;
    for (int32_t j = threadIdx.x; j < N; j += kSpanThreads) {
      const int64_t v = static_cast<int64_t>(d[j]) - base;
      if (v >= 0 && v < kIdBits) {
        const uint32_t bit = 1u << (v & 31);
        dup |= (atomicOr(s_bits + (v >> 5), bit) & bit) != 0;
      }
    }
    if (dup) *s_dup = 1;
    __syncthreads();
    const bool repeat = *s_dup != 0;
    __syncthreads();  // s_dup read before the next pass clears it
    if (repeat) return false;
  }
  return true;
}

// w[j] = w[j + sh] for j < 8, sh in [0, 4) the same in every thread
__device__ __forceinline__ void shift_window(int32_t (&w)[12], int sh) {
  if (sh & 2) {
#pragma unroll
    for (int j = 0; j < 10; ++j) w[j] = w[j + 2];
  }
  if (sh & 1) {
#pragma unroll
    for (int j = 0; j < 11; ++j) w[j] = w[j + 1];
  }
}

// w[0 .. 12) = a[p & ~3 ...], three 16-byte loads of shared memory
__device__ __forceinline__ void load_window(int32_t (&w)[12],
                                            const int32_t* a, int p) {
  const int4* a4 = reinterpret_cast<const int4*>(a + (p & ~3));
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    const int4 x = a4[q];
    w[4 * q] = x.x;
    w[4 * q + 1] = x.y;
    w[4 * q + 2] = x.z;
    w[4 * q + 3] = x.w;
  }
}

// Pass 2: a block the window starts [t0, t0 + kSpan) of the chunk, a
// thread 8 consecutive starts.  The span [t0, t0 + kSpan), suffix-scanned
// within tiles, stays in registers: a start's raw lcp[i] is the thread's
// own, its head the next position's scan (the next lane's first, the next
// warp's through s_first, past the span a whole tile from pass 1).  The
// tails come from the two spans [q0, q0 + 2 kSpan), q0 the span that
// holds t0 + N - 1, prefix-scanned into shared memory and read back as
// aligned 16-byte windows.
template <typename Doc>
__global__ void __launch_bounds__(kSpanThreads, 4)
    mum_span_kernel(const int32_t* __restrict__ lcp,
                    const Doc* __restrict__ docs,
                    const uint8_t* __restrict__ chg, int32_t C, int32_t N,
                    int32_t limit, int32_t min_mum, int tshift,
                    const int2* __restrict__ summary,
                    uint32_t* __restrict__ packed,
                    int32_t* __restrict__ ell_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  int32_t* s_tmin = reinterpret_cast<int32_t*>(smem);
  int32_t* s_traw = s_tmin + 2 * kSpan + kPad;
  uint8_t* s_tchg = reinterpret_cast<uint8_t*>(s_traw + 2 * kSpan + kPad);
  int2* s_warp = reinterpret_cast<int2*>(s_tchg + 2 * kSpan / 8);
  int2* s_first = s_warp + 3 * (kSpanThreads / 32);
  uint32_t* s_hits = reinterpret_cast<uint32_t*>(s_first
                                                 + kSpanThreads / 32);
  int2* s_core = reinterpret_cast<int2*>(s_hits + kSpan / 32);
  int32_t* s_red = reinterpret_cast<int32_t*>(s_core + 1);
  uint32_t* s_bits = reinterpret_cast<uint32_t*>(smem);

  const int32_t L = C + 2 * N + 2;
  const int32_t t0 = blockIdx.x * kSpan;
  const int32_t q0 = (t0 + N - 1) / kSpan * kSpan;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // every read of the three spans issued before any is used
  RawSpan raw[3];
#pragma unroll
  for (int s = 0; s < 3; ++s) {
    load_raw(raw[s], lcp, chg, s == 0 ? t0 : q0 + int64_t{s - 1} * kSpan,
             L);
  }
  // the tiles between every start's head and tail (the core): after the
  // tile of the last start's head, before that of the first start's tail
  const int64_t head_tile = (int64_t{t0} + kSpan) >> tshift;
  const int32_t last_head = head_tile < INT32_MAX
                                ? static_cast<int32_t>(head_tile)
                                : INT32_MAX;
  const int32_t c_hi = ((t0 + N - 1) >> tshift) - 1;
  if (warp == 0) {
    int2 acc = none();
    for (int64_t m = head_tile + 1 + lane; m <= c_hi; m += 32) {
      acc = comb(acc, __ldg(summary + m));
    }
    for (int o = 16; o > 0; o >>= 1) {
      acc = comb(acc, make_int2(__shfl_xor_sync(0xffffffffu, acc.x, o),
                                __shfl_xor_sync(0xffffffffu, acc.y, o)));
    }
    if (lane == 0) *s_core = acc;
  }
  // the tails: spans 1 and 2, prefix-scanned
#pragma unroll
  for (int s = 1; s < 3; ++s) {
    int2 v[kPerThread];
    unpack(raw[s], v);
    const int off = (s - 1) * kSpan + kPerThread * threadIdx.x;
    int4* raw4 = reinterpret_cast<int4*>(s_traw + off);
    raw4[0] = make_int4(v[0].x, v[1].x, v[2].x, v[3].x);
    raw4[1] = make_int4(v[4].x, v[5].x, v[6].x, v[7].x);
    tile_scan<false>(v, tshift, s_warp + s * (kSpanThreads / 32));
    int4* min4 = reinterpret_cast<int4*>(s_tmin + off);
    min4[0] = make_int4(v[0].x, v[1].x, v[2].x, v[3].x);
    min4[1] = make_int4(v[4].x, v[5].x, v[6].x, v[7].x);
    uint32_t flags = 0;
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) flags |= uint32_t(v[j].y) << j;
    s_tchg[off >> 3] = static_cast<uint8_t>(flags);
  }
  // the heads: span 0, suffix-scanned, kept in registers
  int2 h[kPerThread];
  unpack(raw[0], h);
  int32_t x0[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) x0[j] = h[j].x;
  tile_scan<true>(h, tshift, s_warp);
  if (lane == 0) s_first[warp] = h[0];
  __syncthreads();
  const int2 core = *s_core;
  // the head of start 8 * threadIdx.x + 7: the next thread's first
  // position, past the span a whole tile
  int2 next = make_int2(__shfl_down_sync(0xffffffffu, h[0].x, 1),
                        __shfl_down_sync(0xffffffffu, h[0].y, 1));
  const int32_t k0 = kPerThread * threadIdx.x;
  if (lane == 31) {
    next = warp + 1 < kSpanThreads / 32
               ? s_first[warp + 1]
               : (t0 + kSpan <= C ? __ldg(summary + last_head) : none());
  }
  // the tails of the thread's starts: positions pe = t0 + N - 1 - q0 + k
  // of spans 1-2, and lcp[i + N] at pe + 1
  const int pe0 = t0 + N - 1 - q0 + k0;
  int32_t tmin[12], traw[12];
  load_window(tmin, s_tmin, pe0);
  load_window(traw, s_traw, pe0 + 1);
  shift_window(tmin, pe0 & 3);
  shift_window(traw, (pe0 + 1) & 3);
  const uint32_t tflags =
      (uint32_t{s_tchg[pe0 >> 3]} | uint32_t{s_tchg[(pe0 >> 3) + 1]} << 8)
      >> (pe0 & 7);
  uint32_t cand_bits = 0;
  int32_t ell[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int32_t i = t0 + k0 + j;
    const int32_t ta = (i + 1) >> tshift, te = (i + N - 1) >> tshift;
    int2 acc = j + 1 < kPerThread ? h[j + 1] : next;
    acc = comb(acc, make_int2(tmin[j], (tflags >> j) & 1));
    acc = comb(acc, core);
    // the tiles between outside the core: at most one on each side
    if (i < C && ta + 1 <= min(last_head, te - 1)) {
      acc = comb(acc, __ldg(summary + ta + 1));
    }
    const int32_t lo2 = max(c_hi + 1, ta + 1);
    if (i < C && lo2 <= te - 1) acc = comb(acc, __ldg(summary + lo2));
    ell[j] = acc.x;
    const bool uniq = x0[j] < acc.x && traw[j] < acc.x;
    const bool cand = i < C && acc.x >= min_mum && uniq && acc.y != 0 &&
                      i <= limit;
    cand_bits |= uint32_t(cand) << j;
  }
  const int32_t i0 = t0 + k0;
  if (i0 + kPerThread <= C &&
      (reinterpret_cast<uintptr_t>(ell_out) & 15) == 0) {
    int4* e4 = reinterpret_cast<int4*>(ell_out + i0);
    e4[0] = make_int4(ell[0], ell[1], ell[2], ell[3]);
    e4[1] = make_int4(ell[4], ell[5], ell[6], ell[7]);
  } else {
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      if (i0 + j < C) ell_out[i0 + j] = ell[j];
    }
  }
  // a hit word is 4 threads' bytes
  uint32_t word = cand_bits;
  word |= __shfl_down_sync(0xffffffffu, cand_bits, 1) << 8;
  word |= __shfl_down_sync(0xffffffffu, cand_bits, 2) << 16;
  word |= __shfl_down_sync(0xffffffffu, cand_bits, 3) << 24;
  if ((lane & 3) == 0) s_hits[threadIdx.x >> 2] = word;
  __syncthreads();
  // coverage, a candidate at a time (the loop is the same in every thread)
  for (int w = 0; w < kSpan / 32; ++w) {
    uint32_t bits = s_hits[w];
    while (bits != 0) {
      const int b = __ffs(bits) - 1;
      bits &= bits - 1;
      if (!distinct_span(docs + t0 + 32 * w + b, N, s_bits, s_red)) {
        if (threadIdx.x == 0) s_hits[w] &= ~(1u << b);
      }
    }
  }
  __syncthreads();
  if (threadIdx.x < kSpan / 32 && t0 + 32 * static_cast<int32_t>(threadIdx.x)
                                      < C) {
    packed[(t0 >> 5) + threadIdx.x] = s_hits[threadIdx.x];
  }
}

template <typename Doc>
cudaError_t span_allow_smem() {
  static bool allowed[kMaxDevices] = {};
  return allow_smem(mum_span_kernel<Doc>, kSpanSmem, allowed);
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

// The large-N route: two launches; `scratch` holds the tiles' summaries,
// scratch_bytes at least 8 * ceil((C + 2N + 2) / T) with T the tile of
// span_tile_shift; the same arguments otherwise, any N >= 2.
int colbwt_mum_window_two_pass(const void* lcp, const void* docs,
                               int64_t docs_u16, const void* chg, int64_t C,
                               int64_t N, int64_t limit, int64_t min_mum,
                               void* scratch, int64_t scratch_bytes,
                               void* packed, void* ell, void* stream) {
  if (N < 2 || C < 1 || C + 2 * N + 2 >= (int64_t{1} << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int32_t c = static_cast<int32_t>(C), n = static_cast<int32_t>(N);
  const int32_t L = c + 2 * n + 2;
  const int tshift = span_tile_shift(n);
  const int64_t tiles = ((int64_t{L} - 1) >> tshift) + 1;
  if (scratch_bytes < 8 * tiles) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int2* summary = static_cast<int2*>(scratch);
  mum_summary_kernel<<<(int64_t{L} + kSpan - 1) / kSpan, kSpanThreads, 0, s>>>(
      static_cast<const int32_t*>(lcp), static_cast<const uint8_t*>(chg), L,
      tshift, tiles, summary);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t blocks = (int64_t{c} + kSpan - 1) / kSpan;
  if (docs_u16) {
    err = span_allow_smem<uint16_t>();
    if (err != cudaSuccess) return static_cast<int>(err);
    mum_span_kernel<uint16_t><<<blocks, kSpanThreads, kSpanSmem, s>>>(
        static_cast<const int32_t*>(lcp), static_cast<const uint16_t*>(docs),
        static_cast<const uint8_t*>(chg), c, n, clamp_i32(limit),
        clamp_i32(min_mum), tshift, summary, static_cast<uint32_t*>(packed),
        static_cast<int32_t*>(ell));
  } else {
    err = span_allow_smem<int32_t>();
    if (err != cudaSuccess) return static_cast<int>(err);
    mum_span_kernel<int32_t><<<blocks, kSpanThreads, kSpanSmem, s>>>(
        static_cast<const int32_t*>(lcp), static_cast<const int32_t*>(docs),
        static_cast<const uint8_t*>(chg), c, n, clamp_i32(limit),
        clamp_i32(min_mum), tshift, summary, static_cast<uint32_t*>(packed),
        static_cast<int32_t*>(ell));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
