// Suffix array, LCP and threshold kernels for Hopper (sm_90a): K11a, K11b
// and K12.
//
// Replaces three jitted XLA programs of colbwt_tpu/ops/construct_jax.py:
//
// - K11a `colbwt_doubling_round` (:51 _doubling_round, with :39 _rerank):
//   one prefix-doubling round.  JAX sorts by (rank[i], rank[i+k]) with two
//   stable argsorts; here one uint64 key packs (rank[i], rank[i+k] + 1, or 0
//   past the end) and a hand-written LSD radix sort of (key, index) pairs
//   sorts it, 8 bits a pass: per-tile digit histograms, an exclusive scan
//   over digits x tiles, and a stable scatter.  The sort is stable and
//   starts from the identity, so ties keep index order, as the two stable
//   argsorts do, and `order` equals JAX's in every round.  The dense
//   re-rank is a flag pass (key changed), an exclusive scan and a scatter
//   that also writes the order and the largest rank.
// - K11b `colbwt_lcp_lift` (:106 lcp_from_pyramid): one thread per adjacent
//   pair (sa[i-1], sa[i]) probes widths 2^R ... 2 through the pyramid's
//   levels R-1 ... 0, then width 1 through the base ranks.  An
//   out-of-range probe reads -1 for a and -2 for b, so it never matches.
//   Positions are int64 inside: a + h passes 2^31 - 1 near the top of
//   int32 n, where JAX's int32 arithmetic would wrap.
// - K12 `colbwt_segmented_argmin` (:494 _segmented_argmin): one warp per
//   segment [lo, hi] of the lcp array takes the minimum of (lcp, position),
//   so the first position of the minimum wins, as np.argmin's does; JAX's
//   two segment_min passes over a per-position segment id are not needed.
//
// What bounds them on an H100: all three move bytes.  K11a reads and
// writes 12 bytes a position a pass (key and index) plus the histogram
// read, with 2 * bit_length(n) key bits in 8-bit passes (6 passes at
// n = 4M, 7 at n = 72M); the scatter's writes land in 256 streams a tile.
// K11b makes R + 1 dependent pairs of random 4-byte gathers a position,
// each a 32-byte sector from device memory.  K12 reads each position of
// its segments once, coalesced within a warp.  The simple designs here
// (one 8-bit digit a pass, one match_any rank a warp, a warp a segment)
// are right first; making them fast is later work.
//
// All positions are < 2^31 (the wrappers check n); ranks and offsets are
// int32.  Plain C interface (ctypes); every entry launches on the caller's
// stream, allocates nothing and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRadixThreads = 256;  // one thread a digit in the tile loops
constexpr int kRadixWarps = kRadixThreads / 32;
constexpr int64_t kRadixTile = 4096;  // positions a radix block owns
constexpr int kScanThreads = 1024;
constexpr int kScanItems = 4;
constexpr int64_t kScanTile = kScanThreads * kScanItems;
constexpr int kMaxLevels = 32;

// ---------------------------------------------------------------------------
// exclusive scan of int32 counts, in place: one tile of 4,096 a block, the
// block totals scanned recursively in `scratch`, then added back
// ---------------------------------------------------------------------------

__global__ void scan_tile_kernel(int32_t* __restrict__ data, int64_t m,
                                 int32_t* __restrict__ sums) {
  __shared__ int32_t warp_sums[kScanThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t base =
      static_cast<int64_t>(blockIdx.x) * kScanTile + threadIdx.x * kScanItems;
  int32_t v[kScanItems];
  int32_t s = 0;
  for (int q = 0; q < kScanItems; ++q) {
    v[q] = base + q < m ? data[base + q] : 0;
    s += v[q];
  }
  int32_t x = s;  // inclusive scan of the thread sums within the warp
  for (int o = 1; o < 32; o <<= 1) {
    const int32_t y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int32_t w = warp_sums[lane];
    for (int o = 1; o < 32; o <<= 1) {
      const int32_t y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    warp_sums[lane] = w;
  }
  __syncthreads();
  int32_t run = x - s + (warp > 0 ? warp_sums[warp - 1] : 0);
  for (int q = 0; q < kScanItems; ++q) {
    if (base + q < m) data[base + q] = run;
    run += v[q];
  }
  if (threadIdx.x == kScanThreads - 1) sums[blockIdx.x] = run;
}

__global__ void add_offsets_kernel(int32_t* __restrict__ data, int64_t m,
                                   const int32_t* __restrict__ offsets) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i < m) data[i] += offsets[i / kScanTile];
}

// scratch holds ceil(m / 4096) + ceil(m / 4096^2) + ... entries (the
// wrapper's _scan_scratch_len)
cudaError_t exclusive_scan(int32_t* data, int64_t m, int32_t* scratch,
                           cudaStream_t s) {
  const int64_t blocks = (m + kScanTile - 1) / kScanTile;
  scan_tile_kernel<<<blocks, kScanThreads, 0, s>>>(data, m, scratch);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || blocks == 1) return err;
  err = exclusive_scan(scratch, blocks, scratch + blocks, s);
  if (err != cudaSuccess) return err;
  add_offsets_kernel<<<(m + 255) / 256, 256, 0, s>>>(data, m, scratch);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K11a: key build, radix passes, re-rank
// ---------------------------------------------------------------------------

// key[i] = rank[i] << lo_bits | (rank[i + k] + 1, or 0 where i >= n - k);
// val[i] = i
__global__ void pair_keys_kernel(const int32_t* __restrict__ rank, int64_t n,
                                 int64_t k, int lo_bits,
                                 uint64_t* __restrict__ keys,
                                 int32_t* __restrict__ vals) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= n) return;
  const uint64_t lo =
      i < n - k ? static_cast<uint64_t>(rank[i + k]) + 1u : 0u;
  keys[i] = (static_cast<uint64_t>(rank[i]) << lo_bits) | lo;
  vals[i] = static_cast<int32_t>(i);
}

// counts of each digit in each tile, digit-major: hist[d * tiles + t]
__global__ void radix_hist_kernel(const uint64_t* __restrict__ keys,
                                  int64_t n, int shift,
                                  int32_t* __restrict__ hist, int64_t tiles) {
  __shared__ int32_t counts[256];
  counts[threadIdx.x] = 0;
  __syncthreads();
  const int64_t start = static_cast<int64_t>(blockIdx.x) * kRadixTile;
  const int64_t end = start + kRadixTile < n ? start + kRadixTile : n;
  for (int64_t i = start + threadIdx.x; i < end; i += kRadixThreads) {
    atomicAdd(&counts[(keys[i] >> shift) & 255u], 1);
  }
  __syncthreads();
  hist[threadIdx.x * tiles + blockIdx.x] = counts[threadIdx.x];
}

// stable scatter of one tile, 256 positions at a time in index order: a
// position goes to its digit's running offset, plus the same digit's count
// in the earlier warps of this step, plus its rank among the equal digits
// of its own warp (__match_any_sync)
__global__ void radix_scatter_kernel(const uint64_t* __restrict__ keys_in,
                                     const int32_t* __restrict__ vals_in,
                                     int64_t n, int shift,
                                     const int32_t* __restrict__ offsets,
                                     int64_t tiles,
                                     uint64_t* __restrict__ keys_out,
                                     int32_t* __restrict__ vals_out) {
  __shared__ int32_t running[256];
  __shared__ int32_t warp_counts[kRadixWarps][256];
  const int t = threadIdx.x;
  const int warp = t >> 5;
  const unsigned below = (1u << (t & 31)) - 1u;
  running[t] = offsets[static_cast<int64_t>(t) * tiles + blockIdx.x];
  for (int w = 0; w < kRadixWarps; ++w) warp_counts[w][t] = 0;
  __syncthreads();
  const int64_t start = static_cast<int64_t>(blockIdx.x) * kRadixTile;
  const int64_t end = start + kRadixTile < n ? start + kRadixTile : n;
  for (int64_t c = start; c < end; c += kRadixThreads) {
    const int64_t i = c + t;
    const bool valid = i < end;
    const uint64_t key = valid ? keys_in[i] : 0u;
    const int32_t val = valid ? vals_in[i] : 0;
    const int d = valid ? static_cast<int>((key >> shift) & 255u) : 256;
    const unsigned peers = __match_any_sync(0xffffffffu, d);
    const int rank_in_warp = __popc(peers & below);
    if (valid && rank_in_warp == 0) warp_counts[warp][d] = __popc(peers);
    __syncthreads();
    if (valid) {
      int32_t off = running[d] + rank_in_warp;
      for (int w = 0; w < warp; ++w) off += warp_counts[w][d];
      keys_out[off] = key;
      vals_out[off] = val;
    }
    __syncthreads();
    int32_t total = 0;
    for (int w = 0; w < kRadixWarps; ++w) {
      total += warp_counts[w][t];
      warp_counts[w][t] = 0;
    }
    running[t] += total;
    __syncthreads();
  }
}

__device__ __forceinline__ int32_t key_changed(const uint64_t* keys,
                                               int64_t j) {
  return j == 0 || keys[j] != keys[j - 1] ? 1 : 0;
}

__global__ void change_flags_kernel(const uint64_t* __restrict__ keys,
                                    int64_t n, int32_t* __restrict__ flags) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (j < n) flags[j] = key_changed(keys, j);
}

// new_rank[order[j]] = (changes before j) + changed[j] - 1
__global__ void rerank_kernel(const uint64_t* __restrict__ keys,
                              const int32_t* __restrict__ vals,
                              const int32_t* __restrict__ before, int64_t n,
                              int32_t* __restrict__ order,
                              int32_t* __restrict__ new_rank,
                              int32_t* __restrict__ max_rank) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (j >= n) return;
  const int32_t o = vals[j];
  const int32_t r = before[j] + key_changed(keys, j) - 1;
  order[j] = o;
  new_rank[o] = r;
  if (j == n - 1) *max_rank = r;
}

// ---------------------------------------------------------------------------
// K11b, K12
// ---------------------------------------------------------------------------

struct Levels {
  const int32_t* p[kMaxLevels];
};

__device__ __forceinline__ bool same_rank(const int32_t* level, int64_t pa,
                                          int64_t pb, int64_t n) {
  const int32_t ra = pa < n ? level[pa] : -1;
  const int32_t rb = pb < n ? level[pb] : -2;
  return ra == rb;
}

__global__ void lcp_lift_kernel(const int32_t* __restrict__ ranks0,
                                const int32_t* __restrict__ sa, Levels levels,
                                int num_levels, int64_t n,
                                int32_t* __restrict__ lcp) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= n) return;
  if (i == 0) {
    lcp[0] = 0;
    return;
  }
  const int64_t a = sa[i - 1];
  const int64_t b = sa[i];
  int64_t h = 0;
  for (int j = num_levels - 1; j >= 0; --j) {
    if (same_rank(levels.p[j], a + h, b + h, n)) h += int64_t{2} << j;
  }
  if (same_rank(ranks0, a + h, b + h, n)) h += 1;
  lcp[i] = static_cast<int32_t>(h);
}

__global__ void segmented_argmin_kernel(const int32_t* __restrict__ lcp,
                                        const int64_t* __restrict__ lo,
                                        const int64_t* __restrict__ hi,
                                        int64_t m,
                                        int64_t* __restrict__ out) {
  const int64_t g = (static_cast<int64_t>(blockIdx.x) * blockDim.x +
                     threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (g >= m) return;  // a whole warp: g is the same on all its lanes
  int32_t best = INT32_MAX;
  int64_t where = INT64_MAX;
  for (int64_t p = lo[g] + lane; p <= hi[g]; p += 32) {
    const int32_t v = lcp[p];
    if (v < best) {  // strict: a lane keeps its first position of a tie
      best = v;
      where = p;
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    const int32_t ob = __shfl_down_sync(0xffffffffu, best, o);
    const int64_t ow = __shfl_down_sync(0xffffffffu, where, o);
    if (ob < best || (ob == best && ow < where)) {
      best = ob;
      where = ow;
    }
  }
  if (lane == 0) out[g] = where;
}

}  // namespace

extern "C" {

// One round: `order`, `new_rank` (int32, n) and `max_rank` (one int32).
// keys_a/keys_b hold n uint64, vals_a/vals_b n int32, hist 256 * tiles
// int32 (tiles = ceil(n / 4096)), scratch the scan's block totals for
// max(256 * tiles, n) counts.  `passes` 8-bit digits cover the key's bits.
int colbwt_doubling_round(const void* rank, int64_t n, int64_t k,
                          int64_t lo_bits, int64_t passes, void* keys_a,
                          void* keys_b, void* vals_a, void* vals_b,
                          void* hist, void* scratch, void* order,
                          void* new_rank, void* max_rank, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint64_t* kin = static_cast<uint64_t*>(keys_a);
  uint64_t* kout = static_cast<uint64_t*>(keys_b);
  int32_t* vin = static_cast<int32_t*>(vals_a);
  int32_t* vout = static_cast<int32_t*>(vals_b);
  int32_t* h = static_cast<int32_t*>(hist);
  int32_t* sc = static_cast<int32_t*>(scratch);
  const int64_t tiles = (n + kRadixTile - 1) / kRadixTile;
  const int64_t blocks = (n + 255) / 256;
  pair_keys_kernel<<<blocks, 256, 0, s>>>(static_cast<const int32_t*>(rank),
                                          n, k, static_cast<int>(lo_bits),
                                          kin, vin);
  cudaError_t err = cudaGetLastError();
  for (int64_t p = 0; p < passes && err == cudaSuccess; ++p) {
    const int shift = static_cast<int>(8 * p);
    radix_hist_kernel<<<tiles, kRadixThreads, 0, s>>>(kin, n, shift, h,
                                                      tiles);
    err = cudaGetLastError();
    if (err != cudaSuccess) break;
    err = exclusive_scan(h, 256 * tiles, sc, s);
    if (err != cudaSuccess) break;
    radix_scatter_kernel<<<tiles, kRadixThreads, 0, s>>>(
        kin, vin, n, shift, h, tiles, kout, vout);
    err = cudaGetLastError();
    uint64_t* kt = kin;
    kin = kout;
    kout = kt;
    int32_t* vt = vin;
    vin = vout;
    vout = vt;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  // sorted pairs in kin/vin; vout is free for the change flags
  change_flags_kernel<<<blocks, 256, 0, s>>>(kin, n, vout);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = exclusive_scan(vout, n, sc, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  rerank_kernel<<<blocks, 256, 0, s>>>(kin, vin, vout, n,
                                       static_cast<int32_t*>(order),
                                       static_cast<int32_t*>(new_rank),
                                       static_cast<int32_t*>(max_rank));
  return static_cast<int>(cudaGetLastError());
}

// `levels` is a host array of `num_levels` device pointers (pyramid[0 ..
// R-1], n int32 each); lcp gets n int32.
int colbwt_lcp_lift(const void* ranks0, const void* sa,
                    const void* const* levels, int64_t num_levels, int64_t n,
                    void* lcp, void* stream) {
  if (num_levels < 0 || num_levels > kMaxLevels) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Levels lv = {};
  for (int64_t j = 0; j < num_levels; ++j) {
    lv.p[j] = static_cast<const int32_t*>(levels[j]);
  }
  lcp_lift_kernel<<<(n + 255) / 256, 256, 0, static_cast<cudaStream_t>(
                                                   stream)>>>(
      static_cast<const int32_t*>(ranks0), static_cast<const int32_t*>(sa),
      lv, static_cast<int>(num_levels), n, static_cast<int32_t*>(lcp));
  return static_cast<int>(cudaGetLastError());
}

// out[g] = the first position of min lcp[lo[g] .. hi[g]] (inclusive), for
// m segments
int colbwt_segmented_argmin(const void* lcp, const void* lo, const void* hi,
                            int64_t m, void* out, void* stream) {
  const int64_t threads = 256;
  const int64_t blocks = (m * 32 + threads - 1) / threads;
  segmented_argmin_kernel<<<blocks, threads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(lcp), static_cast<const int64_t*>(lo),
      static_cast<const int64_t*>(hi), m, static_cast<int64_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
