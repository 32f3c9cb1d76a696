// Suffix array, LCP and threshold kernels for Hopper (sm_90a): K11a, K11b
// and K12.
//
// Replaces three jitted XLA programs of colbwt_tpu/ops/construct_jax.py:
//
// - K11a `colbwt_doubling_round` (:51 _doubling_round, with :39 _rerank):
//   one prefix-doubling round.  JAX sorts by (rank[i], rank[i+k]) with two
//   stable argsorts.  Here the previous round's order, the stable argsort
//   of `rank`, gives the order by (rank[i+k], i) for free (Manber-Myers):
//   the positions n-k .. n-1 (next rank -1) in index order, then
//   order[j] - k for each j with order[j] >= k, in order.  One stable sort
//   of that sequence by the 32-bit key rank[i] alone gives JAX's order.
//   The sort is an LSD radix sort in the Onesweep design (Adinets and
//   Merrill, 2022): one histogram kernel for every digit of the round, then
//   one scatter kernel a digit.  A scatter block takes its tile from an
//   atomic counter, ranks the tile's 4,096 keys stably in shared memory
//   (match_any within a warp, counts a warp), publishes its digit counts and
//   finds the counts of the tiles before it by decoupled look-back, then
//   writes the tile out digit by digit, so a warp's stores land in few
//   sectors.  Tiles are taken in order, so a block only waits for blocks
//   already running.  The first pass reads the shifted order itself (the
//   compaction above, the dropped positions skipped in the ranking) and
//   gathers its keys from `rank`; the last writes `order`.  The dense
//   re-rank is one more look-back scan: the change flag of sorted position
//   j compares (rank, rank[o + k]) with j - 1's, and the scan's result is
//   scattered to new_rank[o], the last one also to the largest rank.
//   Without a given order the round first sorts the identity by rank the
//   same way.  A round makes 3 + passes launches (a memset, the histogram,
//   the scatters, the re-rank), 3 + 2 passes without an order.
// - K11b `colbwt_lcp_lift` (:106 lcp_from_pyramid): the same values as
//   JAX's lift, lcp[0] = 0 and lcp[i] = min(LCE(sa[i-1], sa[i]),
//   2^(R+1) - 1), computed in text order as Kasai computes them.  A warp
//   walks 32 x kLcpSpan consecutive text positions, its lanes side by side;
//   for position p, j = isa[p] and partner q = sa[j-1], a lane lifts a
//   known common prefix of q and p through the pyramid (a gallop up the
//   widths 1, 2, 4, ..., then a descent down them) and stores the value
//   at plcp[p]; a second kernel gathers lcp[j] = plcp[sa[j]].  The known
//   prefix is the lane's previous value less the 32 positions stepped
//   over (Kasai's bound, which the cap keeps); a lane's first position
//   takes the full descending lift.  isa is the pyramid's top level when
//   it ranks the last suffix of sa n - 1 (ranks are dense and grow along
//   sa, so that is its largest rank and every suffix has its own: always,
//   after suffix_array), else a scatter kernel builds it first; the kernels
//   read that rank themselves, so the host never waits.  An out-of-range
//   probe reads -1 for q and -2 for p, so it never matches.  Positions are
//   int64 inside: p + h passes 2^31 - 1 near the top of int32 n, where
//   JAX's int32 arithmetic would wrap.
// - K12 `colbwt_segmented_argmin` (:494 _segmented_argmin): one warp per
//   segment [lo, hi] of the lcp array takes the minimum of (lcp, position),
//   so the first position of the minimum wins, as np.argmin's does; JAX's
//   two segment_min passes over a per-position segment id are not needed.
//
// What bounds them on an H100: K11a and K12 move bytes.  K11a's passes read
// and write 8 bytes a position (a 4-byte key and a 4-byte index), with
// ceil(bit_length(max rank) / 8) passes (3 at n = 4M, 4 at n = 72M), plus
// three random 4-byte accesses a position: the first pass's key gather,
// the re-rank's next-rank gather and its new_rank scatter, each a 32-byte
// sector; at n = 4M the re-rank, mostly that scatter, takes over a third
// of a round.
// K11b is bound by sectors, not bytes: JAX's lift makes R + 1 pairs of
// random 4-byte probes a position (22 at R = 10), each a 32-byte sector.
// The walk makes a gather of sa[j-1], the probes at q + h and the plcp
// gather in SA order; the isa reads, the probes at p + h and the plcp
// stores of a warp fall on four consecutive sectors, where lanes a run of
// positions apart would touch 32, and a scatter into SA order would cost a
// random write a position where the gather costs a random read.
// K12 reads each position of its segments once, coalesced within a warp.
//
// All positions are < 2^31 (the wrappers check n); ranks and offsets are
// int32.  Plain C interface (ctypes); every entry launches on the caller's
// stream, allocates nothing and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 32;

// ---------------------------------------------------------------------------
// K11a: Onesweep radix sort of 32-bit rank keys, look-back re-rank
// ---------------------------------------------------------------------------

constexpr int kSortThreads = 256;
constexpr int kSortWarps = kSortThreads / 32;
constexpr int kSortItems = 16;  // a thread's keys, warp-striped
constexpr int64_t kSortTile = kSortThreads * kSortItems;  // 4,096
constexpr int kDigitBits = 8;
constexpr int kBins = 1 << kDigitBits;  // one thread a digit
constexpr int kMaxPasses = 4;           // 32-bit keys
constexpr int kCounters = 16;           // tile counters: 2 sorts + re-rank
constexpr uint32_t kUnranked = 0xffffffffu;
// the state buffer: the histogram, the tile counters (both cleared each
// round), then the look-back words, one a (tile, digit), zeroed once
constexpr int64_t kHistBytes = kMaxPasses * kBins * 4;
constexpr int64_t kStatusOffset = kHistBytes + kCounters * 4;
// a look-back word: epoch << 33 | flag << 31 | count, count < 2^31.  Every
// pass has its own epoch, so a word left by an earlier pass reads as not
// yet published and the words never need clearing.
constexpr uint64_t kAggregate = 1;
constexpr uint64_t kPrefix = 2;

__device__ __forceinline__ uint64_t lb_word(uint32_t epoch, uint64_t flag,
                                            uint64_t count) {
  return (static_cast<uint64_t>(epoch) << 33) | (flag << 31) | count;
}

__device__ __forceinline__ void lb_store(unsigned long long* p, uint64_t v) {
  *reinterpret_cast<volatile unsigned long long*>(p) = v;
}

// the inclusive count of the tiles before `tile` (its own included once it
// publishes), for one look-back chain `words[j * stride]`
__device__ __forceinline__ uint64_t look_back(unsigned long long* words,
                                              int64_t tile, int64_t stride,
                                              uint32_t epoch) {
  uint64_t sum = 0;
  for (int64_t j = tile - 1; j >= 0;) {
    const uint64_t w =
        *reinterpret_cast<volatile unsigned long long*>(words + j * stride);
    if ((w >> 33) != epoch) continue;  // tile j has not published yet
    sum += w & 0x7fffffffu;
    if (((w >> 31) & 3u) == kPrefix) break;
    --j;
  }
  return sum;
}

// counts of every digit of every pass over rank[0 .. n), in shared memory
// first (aggregating equal digits of a warp with match_any was slower)
__global__ void rank_hist_kernel(const int32_t* __restrict__ rank, int64_t n,
                                 int passes, uint32_t* __restrict__ hist) {
  __shared__ uint32_t h[kMaxPasses * kBins];
  for (int i = threadIdx.x; i < passes * kBins; i += blockDim.x) h[i] = 0;
  __syncthreads();
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const uint32_t key = static_cast<uint32_t>(rank[i]);
    for (int p = 0; p < passes; ++p)
      atomicAdd(&h[p * kBins + ((key >> (kDigitBits * p)) & (kBins - 1))],
                1u);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < passes * kBins; i += blockDim.x)
    if (h[i] != 0) atomicAdd(&hist[i], h[i]);
}

struct PassArgs {
  const uint32_t* keys_in;  // nullptr: the first pass, keys are rank[val]
  const int32_t* vals_in;   // a later pass's input
  const int32_t* order;     // first pass: the order to shift (null: 0..n-1)
  const int32_t* rank;
  int64_t len;   // input positions, the dropped ones included
  int64_t n;
  int64_t k;     // first pass: order[j] - k, dropped where order[j] < k
  int64_t head;  // first pass: the positions n - head .. n - 1 come first
  int shift;
  const uint32_t* hist;  // this digit's counts over all n keys
  uint32_t* tile_counter;
  unsigned long long* status;  // a word a (tile, digit)
  uint32_t epoch;
  uint32_t* keys_out;  // nullptr: the sorted keys are not needed
  int32_t* vals_out;
};

// exclusive scans of x and y over the block's 256 threads, and x's total
__device__ __forceinline__ void block_scan2(uint32_t x, uint32_t y,
                                            uint32_t* x_excl,
                                            uint32_t* y_excl,
                                            uint32_t* x_total,
                                            uint32_t (*sums)[2]) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  uint32_t xi = x;
  uint32_t yi = y;
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t u = __shfl_up_sync(0xffffffffu, xi, o);
    const uint32_t v = __shfl_up_sync(0xffffffffu, yi, o);
    if (lane >= o) {
      xi += u;
      yi += v;
    }
  }
  if (lane == 31) {
    sums[warp][0] = xi;
    sums[warp][1] = yi;
  }
  __syncthreads();
  uint32_t xo = 0, yo = 0, xt = 0;
  for (int w = 0; w < kSortWarps; ++w) {
    if (w < warp) {
      xo += sums[w][0];
      yo += sums[w][1];
    }
    xt += sums[w][0];
  }
  *x_excl = xo + xi - x;
  *y_excl = yo + yi - y;
  *x_total = xt;
}

// one stable scatter pass over one tile of 4,096 input positions
__global__ void __launch_bounds__(kSortThreads)
    onesweep_kernel(const PassArgs a) {
  __shared__ uint32_t s_tile;
  __shared__ uint32_t s_valid;
  __shared__ uint32_t warp_counts[kSortWarps][kBins];
  __shared__ uint32_t s_start[kBins];
  __shared__ int64_t s_base[kBins];
  __shared__ uint32_t s_sums[kSortWarps][2];
  __shared__ uint32_t s_keys[kSortTile];
  __shared__ int32_t s_vals[kSortTile];
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  if (t == 0) s_tile = atomicAdd(a.tile_counter, 1u);
  for (int w = 0; w < kSortWarps; ++w) warp_counts[w][t] = 0;
  __syncthreads();
  const int64_t tile = s_tile;
  const unsigned lower = (1u << lane) - 1u;
  // warp w owns positions [w * 512, w * 512 + 512) of the tile, 32 a round
  const int64_t first = tile * kSortTile + warp * (32 * kSortItems) + lane;
  uint32_t key[kSortItems];
  int32_t val[kSortItems];
  uint32_t rnk[kSortItems];  // rank among the warp's equal digits so far
  // every load first, so their latencies overlap (the ranking below syncs
  // the warp each round, and loads do not move across that); what is read
  // once is loaded evict-first, to keep `rank` in the L2 for the gathers
#pragma unroll
  for (int i = 0; i < kSortItems; ++i) {
    const int64_t q = first + 32 * i;
    bool valid = q < a.len;
    uint32_t kk = 0;
    int32_t v = 0;
    if (valid) {
      if (a.keys_in != nullptr) {
        kk = __ldcs(a.keys_in + q);
        v = __ldcs(a.vals_in + q);
      } else if (q < a.head) {
        v = static_cast<int32_t>(a.n - a.head + q);
      } else {
        const int64_t o = a.order != nullptr ? __ldcs(a.order + (q - a.head))
                                             : q - a.head;
        valid = o >= a.k;
        v = static_cast<int32_t>(o - a.k);
      }
    }
    key[i] = kk;
    val[i] = v;
    rnk[i] = valid ? 0u : kUnranked;
  }
  if (a.keys_in == nullptr) {
#pragma unroll
    for (int i = 0; i < kSortItems; ++i)
      if (rnk[i] != kUnranked) key[i] = static_cast<uint32_t>(a.rank[val[i]]);
  }
#pragma unroll
  for (int i = 0; i < kSortItems; ++i) {
    const bool valid = rnk[i] != kUnranked;
    const int d = valid ? static_cast<int>((key[i] >> a.shift) & (kBins - 1))
                        : kBins;
    const unsigned peers = __match_any_sync(0xffffffffu, d);
    const uint32_t before = valid ? warp_counts[warp][d] : 0u;
    __syncwarp();
    if (valid && (peers & lower) == 0)
      warp_counts[warp][d] = before + __popc(peers);
    __syncwarp();
    rnk[i] = valid ? before + __popc(peers & lower) : kUnranked;
  }
  __syncthreads();
  // digit t: the earlier warps' counts, and the tile's
  uint32_t total = 0;
  for (int w = 0; w < kSortWarps; ++w) {
    const uint32_t c = warp_counts[w][t];
    warp_counts[w][t] = total;
    total += c;
  }
  unsigned long long* mine = a.status + tile * kBins + t;
  lb_store(mine, lb_word(a.epoch, tile == 0 ? kPrefix : kAggregate, total));
  uint32_t tile_excl, glob_excl, tile_total;
  block_scan2(total, a.hist[t], &tile_excl, &glob_excl, &tile_total, s_sums);
  uint64_t before_tiles = 0;
  if (tile > 0) {
    before_tiles = look_back(a.status + t, tile, kBins, a.epoch);
    lb_store(mine, lb_word(a.epoch, kPrefix, before_tiles + total));
  }
  s_start[t] = tile_excl;
  s_base[t] = static_cast<int64_t>(glob_excl) +
              static_cast<int64_t>(before_tiles) - tile_excl;
  if (t == 0) s_valid = tile_total;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kSortItems; ++i) {
    if (rnk[i] == kUnranked) continue;
    const int d = static_cast<int>((key[i] >> a.shift) & (kBins - 1));
    const uint32_t s = s_start[d] + warp_counts[warp][d] + rnk[i];
    s_keys[s] = key[i];
    s_vals[s] = val[i];
  }
  __syncthreads();
  // the tile in digit order: neighbouring threads write neighbouring words
  for (uint32_t s = t; s < s_valid; s += kSortThreads) {
    const uint32_t kk = s_keys[s];
    const int64_t dst = s_base[(kk >> a.shift) & (kBins - 1)] + s;
    if (a.keys_out != nullptr) a.keys_out[dst] = kk;
    a.vals_out[dst] = s_vals[s];
  }
}

__device__ __forceinline__ int32_t next_rank_at(const int32_t* rank,
                                                int64_t o, int64_t k,
                                                int64_t n) {
  return o + k < n ? rank[o + k] : -1;
}

struct RerankArgs {
  const uint32_t* keys;  // rank[order[j]], sorted
  const int32_t* order;
  const int32_t* rank;
  int64_t n;
  int64_t k;
  uint32_t* tile_counter;
  unsigned long long* status;  // a word a tile
  uint32_t epoch;
  int32_t* new_rank;
  int32_t* max_rank;
};

// new_rank[order[j]] = (positions j' <= j whose (rank, next rank) differs
// from j' - 1's) - 1, by a look-back scan over tiles of 4,096
__global__ void __launch_bounds__(kSortThreads)
    rerank_kernel(const RerankArgs a) {
  __shared__ uint32_t s_tile;
  __shared__ uint32_t s_warp[kSortWarps];
  __shared__ uint64_t s_prefix;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  if (t == 0) s_tile = atomicAdd(a.tile_counter, 1u);
  __syncthreads();
  const int64_t tile = s_tile;
  const int64_t wfirst = tile * kSortTile + warp * (32 * kSortItems);
  // the key pair of the position before each lane's; lane 0 of round 0
  // reads the one before the warp's first
  uint32_t pk = 0;
  int32_t pn = 0;
  if (lane == 0 && wfirst > 0 && wfirst - 1 < a.n) {
    pk = a.keys[wfirst - 1];
    pn = next_rank_at(a.rank, a.order[wfirst - 1], a.k, a.n);
  }
  uint32_t incl[kSortItems];
  int32_t ord[kSortItems];
  int32_t nxt[kSortItems];
  uint32_t kv[kSortItems];
  // the loads and gathers first, so their latencies overlap; keys and
  // order evict-first, to keep `rank` and `new_rank` in the L2
#pragma unroll
  for (int i = 0; i < kSortItems; ++i) {
    const int64_t j = wfirst + 32 * i + lane;
    kv[i] = j < a.n ? __ldcs(a.keys + j) : 0u;
    ord[i] = j < a.n ? __ldcs(a.order + j) : 0;
  }
#pragma unroll
  for (int i = 0; i < kSortItems; ++i) {
    const int64_t j = wfirst + 32 * i + lane;
    nxt[i] = j < a.n ? next_rank_at(a.rank, ord[i], a.k, a.n) : 0;
  }
  uint32_t run = 0;
#pragma unroll
  for (int i = 0; i < kSortItems; ++i) {
    const int64_t j = wfirst + 32 * i + lane;
    // the pair before j: lane - 1 of this round, lane 31 of the last
    uint32_t uk = __shfl_up_sync(0xffffffffu, kv[i], 1);
    int32_t un = __shfl_up_sync(0xffffffffu, nxt[i], 1);
    if (lane == 0) {
      uk = pk;
      un = pn;
    }
    pk = __shfl_sync(0xffffffffu, kv[i], 31);
    pn = __shfl_sync(0xffffffffu, nxt[i], 31);
    const bool changed =
        j < a.n && (j == 0 || kv[i] != uk || nxt[i] != un);
    const unsigned b = __ballot_sync(0xffffffffu, changed);
    incl[i] = run + __popc(b & ((2u << lane) - 1u));
    run += __popc(b);
  }
  if (lane == 0) s_warp[warp] = run;
  __syncthreads();
  if (t == 0) {
    uint64_t total = 0;
    for (int w = 0; w < kSortWarps; ++w) total += s_warp[w];
    unsigned long long* mine = a.status + tile;
    lb_store(mine, lb_word(a.epoch, tile == 0 ? kPrefix : kAggregate, total));
    uint64_t before = 0;
    if (tile > 0) {
      before = look_back(a.status, tile, 1, a.epoch);
      lb_store(mine, lb_word(a.epoch, kPrefix, before + total));
    }
    s_prefix = before;
  }
  __syncthreads();
  uint64_t base = s_prefix;
  for (int w = 0; w < warp; ++w) base += s_warp[w];
#pragma unroll
  for (int i = 0; i < kSortItems; ++i) {
    const int64_t j = wfirst + 32 * i + lane;
    if (j >= a.n) continue;
    const int32_t r = static_cast<int32_t>(base + incl[i]) - 1;
    a.new_rank[ord[i]] = r;
    if (j == a.n - 1) *a.max_rank = r;
  }
}

int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }

// One stable sort of `passes` digits: the first pass's input as `first`
// describes it, the later passes' through keys[p % 2] / vals[p % 2]; the
// last pass writes `out_vals` (and keys[(passes - 1) % 2], unless
// `keep_keys` is false).
cudaError_t radix_sort(PassArgs first, int passes, bool keep_keys,
                       uint32_t* const keys[2], int32_t* const vals[2],
                       int32_t* out_vals, uint32_t* hist,
                       uint32_t* counters, unsigned long long* status,
                       uint32_t epoch, cudaStream_t s) {
  const int64_t n = first.n;
  for (int p = 0; p < passes; ++p) {
    PassArgs a = first;
    if (p > 0) {
      a.keys_in = keys[(p - 1) % 2];
      a.vals_in = vals[(p - 1) % 2];
      a.order = nullptr;
      a.len = n;
    }
    a.shift = kDigitBits * p;
    a.hist = hist + p * kBins;
    a.tile_counter = counters + p;
    a.status = status;
    a.epoch = epoch + static_cast<uint32_t>(p);
    const bool last = p == passes - 1;
    a.keys_out = last && !keep_keys ? nullptr : keys[p % 2];
    a.vals_out = last ? out_vals : vals[p % 2];
    onesweep_kernel<<<ceil_div(a.len, kSortTile), kSortThreads, 0, s>>>(a);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// ---------------------------------------------------------------------------
// K11b, K12
// ---------------------------------------------------------------------------

// level l of the lift (width 2^l): ranks0 at l = 0, pyramid[l - 1] above
struct Levels {
  const int32_t* p[kMaxLevels + 1];
};

// K11b's walk: a thread takes kLcpSpan positions of the text, kLcpGroup
// apart: a group of kLcpGroup lanes walks kLcpGroup * kLcpSpan positions
// side by side (1: each lane a run of consecutive positions; 32: a warp's
// lanes side by side).  A warp's isa reads, text-side probes and stores
// then touch 4 sectors from kLcpGroup = 8 on, where lanes a run apart
// touch 32; the bound a position leaves its successor falls by kLcpGroup.
constexpr int kLcpThreads = 256;
constexpr int kLcpSpan = 32;
constexpr int kLcpGroup = 32;

// whether the top level `top` (null when there is none) is the inverse of
// sa: its rank of sa's last suffix, the largest, is n - 1
__device__ __forceinline__ bool top_is_inverse(const int32_t* top,
                                               const int32_t* sa, int64_t n) {
  if (top == nullptr) return false;
  const int32_t p = __ldg(sa + n - 1);
  return p >= 0 && p < n && __ldg(top + p) == n - 1;
}

__device__ __forceinline__ bool same_rank(const int32_t* level, int64_t pa,
                                          int64_t pb, int64_t n) {
  const int32_t ra = pa < n ? level[pa] : -1;
  const int32_t rb = pb < n ? level[pb] : -2;
  return ra == rb;
}

// the lift of h, a known common prefix of the suffixes at a and b, to
// min(LCE(a, b), cap), cap = 2^(R+1) - 1: a gallop through widths 1, 2,
// 4, ... while the probes match, then a descent through the halved widths
// (the gallop stops at a width w with LCE - h < w, or at the cap)
__device__ __forceinline__ int64_t extend(const Levels& lv, int R, int64_t n,
                                          int64_t cap, int64_t a, int64_t b,
                                          int64_t h) {
  int l = 0;
  while (l <= R && h + (int64_t{1} << l) <= cap &&
         same_rank(lv.p[l], a + h, b + h, n)) {
    h += int64_t{1} << l;
    ++l;
  }
  while (l > 0) {
    --l;
    if (h + (int64_t{1} << l) <= cap &&
        same_rank(lv.p[l], a + h, b + h, n)) {
      h += int64_t{1} << l;
    }
  }
  return h;
}

// the parent's descending lift, widths 2^R ... 1: min(LCE(a, b), cap)
__device__ __forceinline__ int64_t lift(const Levels& lv, int R, int64_t n,
                                        int64_t a, int64_t b) {
  int64_t h = 0;
  for (int l = R; l >= 0; --l) {
    if (same_rank(lv.p[l], a + h, b + h, n)) h += int64_t{1} << l;
  }
  return h;
}

// Kasai's order: for text position p with j = isa[p] > 0 and partner
// q = sa[j - 1], the value min(LCE(p, q), cap) goes to plcp[p], and it
// bounds the one at p + d from below by value - d.  A thread's first
// position takes the full lift; each later one starts from its
// predecessor's value less the stride and extends it.  isa is `top` when
// that is the inverse, else `scratch`.
__global__ void __launch_bounds__(kLcpThreads)
    lcp_walk_kernel(Levels lv, int R, const int32_t* top,
                    const int32_t* scratch, const int32_t* __restrict__ sa,
                    int64_t n, int32_t* __restrict__ plcp) {
  const int32_t* __restrict__ isa =
      top_is_inverse(top, sa, n) ? top : scratch;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kLcpThreads +
                    threadIdx.x;
  const int64_t first =
      t / kLcpGroup * (kLcpGroup * kLcpSpan) + t % kLcpGroup;
  const int64_t cap = (int64_t{2} << R) - 1;
  int64_t h = -1;  // the previous position's value (none yet)
  int64_t j_next = first < n ? __ldg(isa + first) : -1;
  for (int i = 0; i < kLcpSpan; ++i) {
    const int64_t p = first + static_cast<int64_t>(i) * kLcpGroup;
    if (p >= n) break;
    const int64_t j = j_next;
    const int64_t p_next = p + kLcpGroup;
    j_next = i + 1 < kLcpSpan && p_next < n ? __ldg(isa + p_next) : -1;
    if (j <= 0 || j >= n) {  // p = sa[0]: no partner, value 0
      if (j == 0) plcp[p] = 0;
      h = 0;
      continue;
    }
    const int64_t q = __ldg(sa + j - 1);
    h = h < 0 ? lift(lv, R, n, q, p)
              : extend(lv, R, n, cap, q, p,
                       h > kLcpGroup ? h - kLcpGroup : 0);
    plcp[p] = static_cast<int32_t>(h);
  }
}

// lcp[j] = plcp[sa[j]], lcp[0] = 0: the text-order values into SA order
__global__ void lcp_gather_kernel(const int32_t* __restrict__ sa,
                                  const int32_t* __restrict__ plcp,
                                  int64_t n, int32_t* __restrict__ lcp) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (j >= n) return;
  const int32_t p = __ldg(sa + j);
  lcp[j] = j > 0 && p >= 0 && p < n ? __ldg(plcp + p) : 0;
}

// isa[sa[j]] = j, unless the top level is the inverse already
__global__ void isa_scatter_kernel(const int32_t* __restrict__ sa, int64_t n,
                                   const int32_t* top,
                                   int32_t* __restrict__ isa) {
  if (top_is_inverse(top, sa, n)) return;
  for (int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       j < n; j += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int32_t p = sa[j];
    if (p >= 0 && p < n) isa[p] = static_cast<int32_t>(j);
  }
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

// The state buffer a round of n positions needs: the histogram, the tile
// counters and a look-back word for each (tile, digit) of the longest pass
// (the first pass reads up to 2n positions).
int64_t doubling_state_bytes(int64_t n) {
  return kStatusOffset + ceil_div(2 * n, kSortTile) * kBins * 8;
}

}  // namespace

extern "C" {

// One round: `order`, `new_rank` (int32, n) and `max_rank` (one int32).
// `order_in` is the stable argsort of `rank` (the previous round's order),
// or null: the round sorts 0 .. n-1 by rank first.  `passes` 8-bit digits
// cover bit_length of the largest rank; keys_a/keys_b hold n uint32,
// vals_a/vals_b n int32, `state` doubling_state_bytes(n) bytes, zeroed
// once before its first round; `epoch` starts at 1 and grows by the round's
// sort passes + 1 every round.
int colbwt_doubling_round(const void* rank, int64_t n, int64_t k,
                          int64_t passes, const void* order_in, void* keys_a,
                          void* keys_b, void* vals_a, void* vals_b,
                          void* state, int64_t state_bytes, int64_t epoch,
                          void* order, void* new_rank, void* max_rank,
                          void* stream) {
  if (n < 1 || n >= (int64_t{1} << 31) || k < 0 || passes < 1 ||
      passes > kMaxPasses || state_bytes < doubling_state_bytes(n) ||
      epoch < 1 || epoch + 2 * kMaxPasses + 1 >= (int64_t{1} << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  char* st = static_cast<char*>(state);
  uint32_t* hist = reinterpret_cast<uint32_t*>(st);
  uint32_t* counters = reinterpret_cast<uint32_t*>(st + kHistBytes);
  unsigned long long* status =
      reinterpret_cast<unsigned long long*>(st + kStatusOffset);
  uint32_t* const keys[2] = {static_cast<uint32_t*>(keys_a),
                             static_cast<uint32_t*>(keys_b)};
  int32_t* const vals[2] = {static_cast<int32_t*>(vals_a),
                            static_cast<int32_t*>(vals_b)};
  const int32_t* rk = static_cast<const int32_t*>(rank);
  int32_t* out = static_cast<int32_t*>(order);
  const int np = static_cast<int>(passes);
  uint32_t ep = static_cast<uint32_t>(epoch);
  cudaError_t err = cudaMemsetAsync(st, 0, kStatusOffset, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t hist_blocks = ceil_div(n, 256) < 1056 ? ceil_div(n, 256)
                                                      : 1056;
  rank_hist_kernel<<<hist_blocks, 256, 0, s>>>(rk, n, np, hist);
  if ((err = cudaGetLastError())) return static_cast<int>(err);
  PassArgs a = {};
  a.rank = rk;
  a.n = n;
  int slot = 0;
  const int32_t* shifted = static_cast<const int32_t*>(order_in);
  if (shifted == nullptr) {
    // the stable argsort of rank: into `order` itself, which the doubling
    // sort's first pass reads before its last pass writes it, or with one
    // pass (read and written by the same pass) into vals_b
    int32_t* dst = np == 1 ? vals[1] : out;
    a.len = n;
    err = radix_sort(a, np, false, keys, vals, dst, hist, counters, status,
                     ep, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    shifted = dst;
    slot = np;
  }
  a.order = shifted;
  a.k = k;
  a.head = k < n ? k : n;
  a.len = n + a.head;
  err = radix_sort(a, np, true, keys, vals, out, hist, counters + slot,
                   status, ep + slot, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  slot += np;
  RerankArgs r;
  r.keys = keys[(np - 1) % 2];
  r.order = out;
  r.rank = rk;
  r.n = n;
  r.k = k;
  r.tile_counter = counters + slot;
  r.status = status;
  r.epoch = ep + slot;
  r.new_rank = static_cast<int32_t*>(new_rank);
  r.max_rank = static_cast<int32_t*>(max_rank);
  rerank_kernel<<<ceil_div(n, kSortTile), kSortThreads, 0, s>>>(r);
  return static_cast<int>(cudaGetLastError());
}

// `levels` is a host array of `num_levels` device pointers (pyramid[0 ..
// R-1], n int32 each); lcp gets n int32, and holds the inverse of sa until
// the last launch when the top level is not that inverse.  `plcp` is
// scratch of n int32 for the values in text order.  Three launches: the
// scatter (which returns at once when the top level is the inverse), the
// walk, the gather.
int colbwt_lcp_lift(const void* ranks0, const void* sa,
                    const void* const* levels, int64_t num_levels, int64_t n,
                    void* plcp, void* lcp, void* stream) {
  if (num_levels < 0 || num_levels > kMaxLevels || n < 1 ||
      n >= (int64_t{1} << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Levels lv = {};
  lv.p[0] = static_cast<const int32_t*>(ranks0);
  for (int64_t j = 0; j < num_levels; ++j) {
    lv.p[j + 1] = static_cast<const int32_t*>(levels[j]);
  }
  const int32_t* s_a = static_cast<const int32_t*>(sa);
  const int32_t* top = num_levels ? lv.p[num_levels] : nullptr;
  int32_t* inv = static_cast<int32_t*>(lcp);
  int32_t* text_order = static_cast<int32_t*>(plcp);
  cudaError_t err;
  const int64_t scatter_blocks = ceil_div(n, 256);
  isa_scatter_kernel<<<scatter_blocks < 4096 ? scatter_blocks : 4096, 256, 0,
                       s>>>(s_a, n, top, inv);
  if ((err = cudaGetLastError())) return static_cast<int>(err);
  const int64_t threads = ceil_div(n, kLcpSpan * 32) * 32;
  lcp_walk_kernel<<<ceil_div(threads, kLcpThreads), kLcpThreads, 0, s>>>(
      lv, static_cast<int>(num_levels), top, inv, s_a, n, text_order);
  if ((err = cudaGetLastError())) return static_cast<int>(err);
  lcp_gather_kernel<<<ceil_div(n, 256), 256, 0, s>>>(
      s_a, text_order, n, static_cast<int32_t*>(lcp));
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
