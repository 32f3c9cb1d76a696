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
// - K12 `colbwt_segmented_argmin` (:494 _segmented_argmin): the first
//   position of the minimum lcp in each of m disjoint ascending segments
//   [lo, hi], the minimum of one packed 64-bit key a position,
//   (lcp ^ 2^31) << 32 | position (the flipped sign bit keeps int32 order;
//   the wrappers keep n < 2^31), so the first position of the minimum
//   wins, as np.argmin's does; JAX's two segment_min passes over a
//   per-position segment id are not needed.  The work is split by
//   positions, not by segments: the span [lo[0], hi[m-1]] is cut into
//   tiles of kArgTile positions (from lo[0] rounded down to a multiple of
//   32), and a warp (as many as stay resident on the card) takes a run of
//   consecutive tiles, in shared memory of its own and synced with itself
//   alone.  It finds its first tile's first segment once (a 32-way search
//   over hi) and walks on from there; for each tile it marks its
//   segments' starts and finds a segment's positions by a prefix count of
//   the marks, while the next tile's lcp values and first segment bounds
//   are in flight.  A lane reduces kArgPer consecutive positions (16-byte
//   loads) in registers: it stores the minimum of a segment that lies
//   inside its positions, and takes a shared atomicMin for its first and
//   last segments, which other lanes may share.  A segment inside the
//   tile is stored at once; a segment that crosses tiles takes a global
//   atomicMin into the key of the tile where it starts, which also keeps
//   its id, and a second short kernel unpacks those keys and puts the
//   all-ones keys back (the workspace stays ready for the next call).  Two
//   launches a call.
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
// K12 reads each position of its segments once, coalesced, and each
// segment's bounds about once; a warp a segment (the first port's design)
// left a segment as long as the terminator's (750,895 positions in
// bench's collection) to one warp.  Measured, the tile kernel is held by
// instruction issue more than by bytes: a tile's fixed work (its
// segments' marks, their prefix, the stores) is why a warp takes 512
// positions at a time.
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

constexpr int kArgTile = 512;  // positions a warp's tile
constexpr int kArgWarps = 8;   // warps a block
constexpr int kArgThreads = 32 * kArgWarps;
constexpr int kArgPer = kArgTile / 32;  // positions a lane
constexpr int kArgWords = kArgTile / 32;  // mark words a tile
// a warp's shared memory: keys and ends of up to kArgTile + 1 segments, the
// marks and their prefix; 16-byte aligned
constexpr int kArgWarpBytes =
    ((kArgTile + 1) * 12 + kArgWords * 8 + 15) / 16 * 16;
constexpr int kArgSmemBytes = kArgWarps * kArgWarpBytes;

static_assert(kArgPer % 4 == 0 && 32 % kArgPer == 0 && kArgWords <= 32,
              "a lane's positions are whole 16-byte loads inside one mark "
              "word; a lane takes at most one mark word");

// (lcp, position) as one key whose unsigned order is (lcp, position)'s
__device__ __forceinline__ unsigned long long arg_key(int32_t v, int64_t p) {
  return static_cast<unsigned long long>(static_cast<uint32_t>(v) ^
                                         0x80000000u) << 32 |
         static_cast<uint32_t>(p);
}

// a lane's kArgPer consecutive lcp values of the tile at a (a multiple of
// 32), len positions: 16-byte loads where lcp is 16-byte aligned
__device__ __forceinline__ void load_tile(const int32_t* __restrict__ lcp,
                                          int64_t a, int len, bool vec,
                                          int32_t (&v)[kArgPer]) {
  const int q0 = (threadIdx.x & 31) * kArgPer;
  if (vec && q0 + kArgPer <= len) {
    const int4* p = reinterpret_cast<const int4*>(lcp + a + q0);
#pragma unroll
    for (int j = 0; j < kArgPer / 4; ++j) {
      const int4 x = __ldg(p + j);
      v[4 * j] = x.x;
      v[4 * j + 1] = x.y;
      v[4 * j + 2] = x.z;
      v[4 * j + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kArgPer; ++j) {
      v[j] = q0 + j < len ? __ldg(lcp + a + q0 + j) : 0;
    }
  }
}

// Tile t covers positions [a, e) of the span, a = base + t * kArgTile
// (base: lo[0] rounded down to a multiple of 32); a warp takes
// tiles_per_warp consecutive tiles, a lane kArgPer consecutive positions
// of each, and syncs only with itself.  A tile's segments are g0 .. g0 +
// nseg - 1, g0 the first with hi >= a: found by the warp's search for its
// first tile, then by the walk (the next tile starts at the last segment
// if it crosses, else after it).  A segment wholly inside a tile gets
// out[g] there, one that crosses tiles a min into part[tile of lo[g]]
// (owner[that tile] = g).  While a tile is reduced, the next one's lcp
// values and first bounds are in flight.
__global__ void __launch_bounds__(kArgThreads)
    argmin_tile_kernel(const int32_t* __restrict__ lcp,
                       const int64_t* __restrict__ lo,
                       const int64_t* __restrict__ hi, int64_t m,
                       int64_t tiles_per_warp, int64_t* __restrict__ out,
                       unsigned long long* __restrict__ part,
                       int32_t* __restrict__ owner) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  unsigned char* mine = smem + (threadIdx.x >> 5) * kArgWarpBytes;
  unsigned long long* s_key = reinterpret_cast<unsigned long long*>(mine);
  int32_t* s_end = reinterpret_cast<int32_t*>(s_key + kArgTile + 1);
  uint32_t* s_marks = reinterpret_cast<uint32_t*>(s_end + kArgTile + 1);
  uint32_t* s_wp = s_marks + kArgWords;
  const int64_t span0 = __ldg(lo) & ~int64_t{31};
  const int64_t span_end = __ldg(hi + m - 1) + 1;
  const bool vec = (reinterpret_cast<uintptr_t>(lcp) & 15) == 0;
  const int64_t t0 =
      (static_cast<int64_t>(blockIdx.x) * kArgWarps + (threadIdx.x >> 5)) *
      tiles_per_warp;
  const int64_t t1 = t0 + tiles_per_warp;
  if (span0 + t0 * kArgTile >= span_end) return;  // the whole warp
  auto tile_len = [&](int64_t t) {
    const int64_t a = span0 + t * kArgTile;
    return static_cast<int>(a >= span_end ? 0
                            : min(int64_t{kArgTile}, span_end - a));
  };
  int32_t v[kArgPer];
  load_tile(lcp, span0 + t0 * kArgTile, tile_len(t0), vec, v);
  // the first g with hi[g] >= a lies in [l, h] (hi[m-1] >= a): 32 probes
  // a round shrink the range 32-fold (every lane holds the same l, h)
  int64_t g0;
  {
    const int64_t a = span0 + t0 * kArgTile;
    int64_t l = 0, h = m - 1;
    while (l < h) {
      const int64_t step = (h - l + 31) / 32;
      const int64_t q = min(l + lane * step, h);
      const unsigned ok = __ballot_sync(0xffffffffu, __ldg(hi + q) >= a);
      if (ok == 0) {
        l = l + 31 * step + 1;
      } else {
        const int f = __ffs(ok) - 1;
        h = min(l + f * step, h);
        l = f == 0 ? h : l + (f - 1) * step + 1;
      }
    }
    g0 = l;
  }
  // the bounds of the tile's first 32 segments, read ahead
  int64_t nl = g0 + lane < m ? __ldg(lo + g0 + lane) : INT64_MAX;
  int64_t nh = g0 + lane < m ? __ldg(hi + g0 + lane) : 0;
  // one tile: its lcp values in v, the next tile's read into w; false past
  // the span (the same for every lane)
  auto step = [&](int64_t t, const int32_t (&v)[kArgPer],
                  int32_t (&w)[kArgPer]) {
    const int len = tile_len(t);
    if (len == 0) return false;
    const int64_t a = span0 + t * kArgTile;
    const int64_t e = a + len;
    if (lane < kArgWords) s_marks[lane] = 0;
    __syncwarp();  // the zeroed marks; the last tile's reads done
    // the tile's segments: start marks, ends clipped to the tile; lo0 the
    // first one's lo
    int nseg = 0;
    int64_t lo0 = 0;
    for (int64_t base = g0;; base += 32) {
      const int64_t g = base + lane;
      int64_t gl = nl, gh = nh;
      if (base != g0) {
        gl = g < m ? __ldg(lo + g) : INT64_MAX;
        gh = g < m ? __ldg(hi + g) : 0;
      } else {
        lo0 = __shfl_sync(0xffffffffu, gl, 0);
      }
      const bool in = gl < e;
      if (in) {
        const int u = static_cast<int>(g - g0);
        const int start = gl > a ? static_cast<int>(gl - a) : 0;
        atomicOr(&s_marks[start >> 5], 1u << (start & 31));
        s_end[u] = gh < e ? static_cast<int>(gh - a) : len;
        s_key[u] = ~0ull;
      }
      const int count = __popc(__ballot_sync(0xffffffffu, in));
      nseg += count;
      if (count < 32) break;
    }
    __syncwarp();
    // the next tile: its first segment (this tile's last if it crosses),
    // its lcp values and first bounds read ahead
    const int64_t next_g0 =
        g0 + nseg - (nseg > 0 && s_end[nseg - 1] == len ? 1 : 0);
    load_tile(lcp, a + kArgTile, t + 1 < t1 ? tile_len(t + 1) : 0, vec, w);
    if (t + 1 < t1) {
      nl = next_g0 + lane < m ? __ldg(lo + next_g0 + lane) : INT64_MAX;
      nh = next_g0 + lane < m ? __ldg(hi + next_g0 + lane) : 0;
    }
    // marks below each word: an exclusive scan over the first kArgWords
    // lanes
    {
      const int c = lane < kArgWords ? __popc(s_marks[lane]) : 0;
      int incl = c;
      for (int o = 1; o < kArgWords; o <<= 1) {
        const int x = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += x;
      }
      if (lane < kArgWords) s_wp[lane] = incl - c;
    }
    __syncwarp();
    {
      // the lane's positions lie in one mark word: a segment starts at
      // each mark.  A run of one segment's positions between the lane's
      // first and last run lies inside the lane, which stores its minimum
      // key; the first and last runs may share their segment with other
      // lanes and end in a shared atomicMin each, taken by the whole warp
      // at two places (the 64-bit min is a compare-and-swap loop)
      const int q0 = lane * kArgPer;
      const uint32_t word = s_marks[q0 >> 5];
      int u = s_wp[q0 >> 5] + __popc(word & ((1u << (q0 & 31)) - 1)) - 1;
      int end = u >= 0 ? s_end[u] : -1;
      int run = -1, first = -1;
      unsigned long long key = ~0ull, first_key = ~0ull;
#pragma unroll
      for (int j = 0; j < kArgPer; ++j) {
        const int q = q0 + j;
        if ((word >> (q & 31)) & 1) {
          end = s_end[++u];
        }
        if (q < len && u >= 0 && q <= end) {
          const unsigned long long k = arg_key(v[j], a + q);
          if (u != run) {
            if (run == first) {
              first_key = key;
            } else {
              s_key[run] = key;
            }
            if (first < 0) first = u;
            run = u;
            key = k;
          } else {
            key = min(key, k);
          }
        }
      }
      if (run == first) first_key = min(first_key, key);
      if (first >= 0) atomicMin(&s_key[first], first_key);
      if (run != first) atomicMin(&s_key[run], key);
    }
    __syncwarp();
    for (int u = lane; u < nseg; u += 32) {
      const unsigned long long key = s_key[u];
      const bool left = u == 0 && lo0 < a;  // began in an earlier tile
      if (!left && s_end[u] < len) {
        out[g0 + u] = static_cast<int64_t>(key & 0xffffffffull);
      } else {
        if (!left) owner[t] = static_cast<int32_t>(g0 + u);
        atomicMin(part + (left ? (lo0 - span0) / kArgTile : t), key);
      }
    }
    __syncwarp();
    g0 = next_g0;
    return true;
  };
  // the two buffers take turns, so no copy waits on a load in flight
  int32_t w[kArgPer];
  for (int64_t t = t0; t < t1; t += 2) {
    if (!step(t, v, w) || t + 1 == t1 || !step(t + 1, w, v)) break;
  }
}

// out[owner[b]] from the key of every tile b where a crossing segment
// starts; the key goes back to all ones
__global__ void argmin_finish_kernel(unsigned long long* __restrict__ part,
                                     const int32_t* __restrict__ owner,
                                     int64_t tiles, int64_t* __restrict__ out) {
  const int64_t b = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (b >= tiles) return;
  const unsigned long long key = part[b];
  if (key == ~0ull) return;
  out[owner[b]] = static_cast<int64_t>(key & 0xffffffffull);
  part[b] = ~0ull;
}

// The tile kernel's warps that stay resident on the current card (its
// shared memory past 48 KB allowed first), once a device.
cudaError_t argmin_slots(int64_t* slots) {
  constexpr int kMaxDevices = 64;
  static int64_t known[kMaxDevices] = {};
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && known[dev]) {
    *slots = known[dev];
    return cudaSuccess;
  }
  if ((err = cudaFuncSetAttribute(argmin_tile_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  kArgSmemBytes)) ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, argmin_tile_kernel, kArgThreads, kArgSmemBytes))) {
    return err;
  }
  *slots = int64_t{sms} * (per_sm > 0 ? per_sm : 1) * kArgWarps;
  if (dev < kMaxDevices) known[dev] = *slots;
  return cudaSuccess;
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
// m >= 1 disjoint ascending nonempty segments of lcp's n positions (n <
// 2^31).  `part` holds ceil(n / kArgTile) keys, all ones (and left so),
// `owner` as many int32.  Two launches: the tiles, then the keys of the
// segments that cross tiles.
int colbwt_segmented_argmin(const void* lcp, int64_t n, const void* lo,
                            const void* hi, int64_t m, void* part,
                            void* owner, void* out, void* stream) {
  if (n < 1 || n >= (int64_t{1} << 31) || m < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int64_t slots = 0;
  cudaError_t err = argmin_slots(&slots);
  if (err != cudaSuccess) return static_cast<int>(err);
  // a resident warp a slot, each a run of consecutive tiles; the tiles of
  // n positions bound the span's
  const int64_t tiles = ceil_div(n, kArgTile);
  const int64_t per_warp = ceil_div(tiles, tiles < slots ? tiles : slots);
  argmin_tile_kernel<<<ceil_div(ceil_div(tiles, per_warp), kArgWarps),
                       kArgThreads, kArgSmemBytes, s>>>(
      static_cast<const int32_t*>(lcp), static_cast<const int64_t*>(lo),
      static_cast<const int64_t*>(hi), m, per_warp,
      static_cast<int64_t*>(out), static_cast<unsigned long long*>(part),
      static_cast<int32_t*>(owner));
  if ((err = cudaGetLastError())) return static_cast<int>(err);
  argmin_finish_kernel<<<ceil_div(tiles, 256), 256, 0, s>>>(
      static_cast<unsigned long long*>(part),
      static_cast<const int32_t*>(owner), tiles, static_cast<int64_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
