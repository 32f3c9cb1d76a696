// Sharded query engines for Hopper (sm_90a): K13a-K13e.
//
// Replaces the shard_map programs of colbwt_tpu/parallel/:
//   colbwt_sharded_fetch        <- the masked gathers that every program does
//       (query_sharded.py:33 _local_gathers, query_sharded_mega.py:62,
//       query_sharded_mega_wide.py:117, query_sharded_pos.py:169 fetch)
//   K13a colbwt_sharded_scan_compact <- query_sharded.py:56 _sharded_query
//       (the lax.scan of colbwt_tpu/ops/query_xla.py:89 query_step), one
//       launch a batch where every shard of the dp row sits on this card;
//       colbwt_sharded_step_compact, one gather round of a step, elsewhere
//   K13b/K13c colbwt_sharded_step_mega <- query_sharded_mega.py:53
//       _sharded_mega_query (narrow) and query_sharded_mega_wide.py:101
//       _sharded_mega_wide_chunk (wide: two limbs in base 2**30), one step;
//       the chunk scan of the same programs, one launch a chunk, is
//       colbwt_sharded_scan_mega in query_mega.cu
//   K13d colbwt_compose_sharded_tk <- query_sharded_pos.py:67
//       _build_sharded_tk
//   K13e colbwt_sharded_scan_pos <- query_sharded_pos.py:163
//       _sharded_pos_query (the lax.scan of a fetch summed over "ip" and a
//       k-character step), one launch a batch where every shard of the dp
//       row sits on this card; colbwt_sharded_step_pos, one step, elsewhere
//
// The table shards over "ip" in contiguous blocks.  A table access is a
// gather masked to the shard that owns the row (0 elsewhere), then a sum over
// the ip shards.  The masks partition the rows, so the sum over the shards
// one card holds is a selection: one fetch launch serves them all, each lane
// reading one row of its owning shard (shards.cuh).  Across cards the
// wrapper adds the cards' outputs, across processes torch.distributed
// all-reduces them over the ip group (the counterpart of XLA's psum over
// ICI).  Each recurrence is a step kernel that consumes the summed rows,
// applies one step (or one dependent gather round of a step), writes the
// step's outputs and emits the next fetch's global indices.
//
// What bounds them on an H100: per read and step, one row (64 B mega, 8 B
// pos, 32 B and 8 B compact) whose address depends on the step before:
// memory latency, as in K3-K6a, plus a launch per fetch and step (a few
// microseconds each) that the single-card scans do not pay; where every
// shard of a row sits on one card, the chunk scans (K13a and K13e here,
// K13b/K13c in query_mega.cu) remove both launches.  A compact step is a chain of four
// dependent row reads (ff_bound 2), so its chunk scan keeps the state in
// registers and issues each round's independent reads together (the run
// and jump rows of round 1, the succ and pred rows of round 2), a 32-byte
// run row as two 16-byte loads, and writes its outputs column-major, so a
// warp's stores of a step are coalesced.  The fetch: a lane's owner by one
// 32-bit division, W a template parameter (2, 8, 16), 8- or 16-byte vector
// loads through the read-only path, 32-bit lane indices.  The steps and
// rounds (K13a-K13c, K13e): one thread per read, state in (B,) int32 arrays
// between launches, the chunk's patterns and the pml and cid planes
// column-major ((C, B): a step's character column and its outputs are
// contiguous, so a warp's loads and stores of a step fill whole sectors,
// where (B, C) rows put each lane's byte or word in a sector of its own).
// Their entry points take a parameter block that the caller prepares once
// a chunk, and the step (and round): a launch passes two or four values
// through ctypes, not twenty.  K13d streams its rows out, its T1 loads
// fanned out over the key's last digit (below).
//
// Arithmetic is the JAX programs' int32 arithmetic (sums wrap as there, shifts
// on uint32 where JAX shifts into bit 31); every gather index is int64 and
// clamped as jnp.take(..., mode="clip") does.
//
// Plain C interface (ctypes); each entry point launches on the caller's
// stream, allocates nothing and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "shards.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int32_t kLimb = int32_t(1) << 30;

__device__ __forceinline__ int64_t clip(int64_t i, int64_t size) {
  return i < 0 ? 0 : (i >= size ? size - 1 : i);
}

// int32 addition with the two's-complement wrap of the JAX programs
__device__ __forceinline__ int32_t add32(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) +
                              static_cast<uint32_t>(b));
}

__device__ __forceinline__ int32_t mul32(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) *
                              static_cast<uint32_t>(b));
}

// (a_hi, a_lo) < (b_hi, b_lo): value order for limbs
__device__ __forceinline__ bool lt(int32_t a_hi, int32_t a_lo, int32_t b_hi,
                                   int32_t b_lo) {
  return a_hi < b_hi || (a_hi == b_hi && a_lo < b_lo);
}

// ---------------------------------------------------------------------------
// the masked gather of the shards one card holds: lane b reads row
// s[b] * stride + g[b] - i*L (clamped to the shard) of the shard i that owns
// g[b] (shards.cuh), or 0 when no shard of this card owns it.  T threads a
// lane, each moving one V (8 bytes at W = 2, else 16) of the row, so
// neighbouring threads read neighbouring addresses; Idx is int32 where
// B*W < 2**31.

template <int W, typename Idx>
__global__ void sharded_fetch_kernel(const long long* __restrict__ tab,
                                     int ip, int64_t L,
                                     const int32_t* __restrict__ g,
                                     const int32_t* __restrict__ s,
                                     int64_t stride, Idx B,
                                     int32_t* __restrict__ out) {
  using V = typename std::conditional<W == 2, int2, int4>::type;
  constexpr int T = W * 4 / static_cast<int>(sizeof(V));
  const Idx e = static_cast<Idx>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= B * T) return;
  const Idx b = e / T;
  const int part = static_cast<int>(e % T);
  V v{};
  const colbwt::ShardRow o = colbwt::shard_row(tab, ip, L, __ldg(g + b));
  if (o.base != nullptr) {
    int64_t row = o.local;
    if (s != nullptr) row += static_cast<int64_t>(__ldg(s + b)) * stride;
    v = __ldg(static_cast<const V*>(o.base) + clip(row, o.rows) * T + part);
  }
  reinterpret_cast<V*>(out)[e] = v;
}

template <int W>
cudaError_t launch_fetch(const long long* tab, int ip, int64_t L,
                         const int32_t* g, const int32_t* s, int64_t stride,
                         int64_t B, int32_t* out, cudaStream_t stream) {
  constexpr int T = W == 2 ? 1 : W / 4;
  const int64_t blocks = (B * T + kThreads - 1) / kThreads;
  if (B * W < (int64_t(1) << 31)) {
    sharded_fetch_kernel<W, int32_t><<<static_cast<unsigned>(blocks),
                                       kThreads, 0, stream>>>(
        tab, ip, L, g, s, stride, static_cast<int32_t>(B), out);
  } else {
    sharded_fetch_kernel<W, int64_t><<<static_cast<unsigned>(blocks),
                                       kThreads, 0, stream>>>(
        tab, ip, L, g, s, stride, B, out);
  }
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K13d: rows [key * n_local, (key + 1) * n_local) of one shard's T_k block,
// positions [lo, lo + n_local), from the replicated T1 ((A * n, 2), match flag
// at bit 31).  The first processed char is the key's high digit; its match
// bit goes to pos_bits(k) and its col id to byte 0.
//
// K2's structure (query_pos.cu), fanned out over the last digit: one block a
// (prefix: the key's first k - 1 digits, tile of kTkTile positions),
// tile-major (the blocks of one tile's prefixes run together and share its
// T1 rows in the L2), its digits decoded once with 32-bit divisions and
// 32-bit offsets inside the tile.  A thread follows the prefix's chain for
// kTkUnroll positions a block's width apart (the first row a coalesced load,
// the rest gathers), then issues the last digit's A gathers T1[d * n + pos],
// kTkFan in flight at once, and stores the A rows n_local apart, each
// coalesced across the warp: (k - 1) / A + 1 loads a row where a thread a
// row made k dependent ones.  At k = 1 the prefix is empty and the fan's
// loads are the coalesced first rows.
constexpr int kTkThreads = 256;
constexpr int kTkUnroll = 2;
constexpr int kTkFan = 2;
constexpr int kTkTile = kTkThreads * kTkUnroll;
constexpr int kTkMaxK = 4;

__global__ void __launch_bounds__(kTkThreads) compose_sharded_tk_kernel(
    const int2* __restrict__ t1, int64_t t1_rows, int64_t n, int64_t n_local,
    int64_t lo, int A, int k, uint32_t prefixes, uint32_t tiles,
    int2* __restrict__ out) {
  const int pb = 32 - k;
  const uint32_t tile = blockIdx.x / prefixes;
  const uint32_t prefix = blockIdx.x - tile * prefixes;
  // T1's block of each prefix digit (loops unrolled to kTkMaxK - 1, so the
  // array stays in registers)
  int64_t chain[kTkMaxK - 1] = {};
  uint32_t rem = prefix;
#pragma unroll
  for (int j = kTkMaxK - 2; j >= 0; --j) {
    if (j <= k - 2) {
      const uint32_t rest = rem / static_cast<uint32_t>(A);
      chain[j] = static_cast<int64_t>(rem - rest * A) * n;
      rem = rest;
    }
  }
  const int64_t p0 = static_cast<int64_t>(tile) * kTkTile;
  const int32_t rows =
      static_cast<int32_t>(n_local - p0 < kTkTile ? n_local - p0 : kTkTile);

  uint32_t pos[kTkUnroll], w0[kTkUnroll], w1[kTkUnroll];
  bool pad[kTkUnroll];
#pragma unroll
  for (int u = 0; u < kTkUnroll; ++u) {
    const int64_t gpos = lo + p0 + threadIdx.x + u * kTkThreads;
    pad[u] = gpos >= n;  // ip padding: an inert self-loop, never reached
    pos[u] = static_cast<uint32_t>(gpos < n - 1 ? gpos : n - 1);
    w0[u] = 0;
    w1[u] = 0;
  }
#pragma unroll
  for (int j = 0; j < kTkMaxK - 1; ++j) {
    if (j >= k - 1) break;
    int2 r[kTkUnroll];
#pragma unroll
    for (int u = 0; u < kTkUnroll; ++u) {
      const int32_t o = threadIdx.x + u * kTkThreads;
      r[u] = o < rows ? __ldg(t1 + clip(chain[j] + pos[u], t1_rows))
                      : make_int2(0, 0);
    }
#pragma unroll
    for (int u = 0; u < kTkUnroll; ++u) {
      const uint32_t x = static_cast<uint32_t>(r[u].x);
      const uint32_t y = static_cast<uint32_t>(r[u].y);
      pos[u] = x & 0x7FFFFFFFu;
      w0[u] |= ((x >> 31) & 1u) << (pb + j);
      w1[u] |= j == 0 ? y : (y & 0xFFu) << (8 * j);
    }
  }
  const int last = k - 1;
  int2* dst = out + static_cast<int64_t>(prefix) * A * n_local + p0;
  for (int d0 = 0; d0 < A; d0 += kTkFan) {
    int2 r[kTkUnroll][kTkFan];
#pragma unroll
    for (int u = 0; u < kTkUnroll; ++u) {
      const int32_t o = threadIdx.x + u * kTkThreads;
#pragma unroll
      for (int f = 0; f < kTkFan; ++f) {
        const int64_t d = d0 + f;
        r[u][f] = d < A && o < rows
                      ? __ldg(t1 + clip(d * n + pos[u], t1_rows))
                      : make_int2(0, 0);
      }
    }
#pragma unroll
    for (int u = 0; u < kTkUnroll; ++u) {
      const int32_t o = threadIdx.x + u * kTkThreads;
      if (o >= rows) continue;
#pragma unroll
      for (int f = 0; f < kTkFan; ++f) {
        const int d = d0 + f;
        if (d >= A) break;
        const uint32_t x = static_cast<uint32_t>(r[u][f].x);
        const uint32_t y = static_cast<uint32_t>(r[u][f].y);
        uint32_t v0 = w0[u] | (((x >> 31) & 1u) << (pb + last)) |
                      (x & 0x7FFFFFFFu);
        uint32_t v1 = last == 0 ? y : w1[u] | ((y & 0xFFu) << (8 * last));
        if (pad[u]) {
          v0 = static_cast<uint32_t>(n - 1);
          v1 = 0;
        }
        dst[static_cast<int64_t>(d) * n_local + o] =
            make_int2(static_cast<int32_t>(v0), static_cast<int32_t>(v1));
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The per-step kernels' layouts.  kStepColMajor: the chunk's patterns and
// the pml and cid planes are (C, B), step s at row C-1-s (else (B, C) rows,
// the layout before the redesign, which scan_designs.py times beside it).
// kStepInterleave (K13b/K13c): a step's pml and cid as one 8-byte store
// into an interleaved (C, B, 2) plane at pml (cid unused).
constexpr bool kStepColMajor = true;
constexpr bool kStepInterleave = false;

// the element (column col, lane b) of a (C, B) or (B, C) plane
__device__ __forceinline__ int64_t step_at(int64_t col, int64_t b, int64_t B,
                                           int64_t C) {
  return kStepColMajor ? col * B + b : b * C + col;
}

// ---------------------------------------------------------------------------
// K13e: step t of the positional scan, k characters from one summed (B, 2)
// row at (key, pos).  Writes the packed outputs ln << 8 | cid of processed
// chars t*k .. t*k+k-1 (rows M-1-q of the (M, B) plane, each store a
// warp's 32 neighbouring words); the state runs on past a read's end, as
// in JAX; emits the next step's position and key, its k characters loaded
// from the (M, B) columns before the row.  The row is 8 bytes a lane and
// the step does no dependent load: what bounds it is the ~47 bytes a lane
// it moves (12.4 MB at G-pos's 263,168 lanes, k = 3) and the launch.

__global__ void __launch_bounds__(kThreads) sharded_step_pos_kernel(
    const int2* __restrict__ rows, int32_t* __restrict__ pos,
    int32_t* __restrict__ mlen, const uint8_t* __restrict__ patterns,
    int64_t B, int64_t M, int64_t t, int k, int32_t A,
    int32_t* __restrict__ packed, int32_t* __restrict__ g_next,
    int32_t* __restrict__ s_next) {
  const int64_t b = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (b >= B) return;
  const int pb = 32 - k;
  const bool more = (t + 1) * k < M;
  int32_t key = 0;
  if (more) {
    for (int j = 0; j < k; ++j) {
      const int64_t col = M - 1 - ((t + 1) * k + j);
      key = add32(mul32(key, A), __ldg(patterns + step_at(col, b, B, M)));
    }
  }
  const int2 w = __ldg(rows + b);
  const uint32_t w0 = static_cast<uint32_t>(w.x);
  const uint32_t w1 = static_cast<uint32_t>(w.y);
  uint32_t ln = static_cast<uint32_t>(mlen[b]);
  for (int j = 0; j < k; ++j) {
    const uint32_t m = (w0 >> (pb + j)) & 1u;
    ln = (ln + 1u) * m;
    const int64_t col = M - 1 - (t * k + j);
    packed[step_at(col, b, B, M)] =
        static_cast<int32_t>((ln << 8) | ((w1 >> (8 * j)) & 0xFFu));
  }
  const int32_t npos = static_cast<int32_t>(w0 & ((1u << pb) - 1u));
  pos[b] = npos;
  mlen[b] = static_cast<int32_t>(ln);
  if (more) {
    g_next[b] = npos;
    s_next[b] = key;
  }
}

// ---------------------------------------------------------------------------
// K13b (narrow) and K13c (wide): one step of the mega recurrence from the
// summed (B, 16) row at c * r + interval.  Lanes past their read's end
// (step_offset + s >= lengths) keep their state and write zeros.  Emits the
// next step's row index; its character is loaded first, beside the row.

struct MegaState {
  int32_t *interval, *offset, *pos_lo, *pos_hi, *mlen;
};

template <bool kWide>
__global__ void __launch_bounds__(kThreads) sharded_step_mega_kernel(
    const int4* __restrict__ rows, const int32_t* __restrict__ length,
    int64_t r, int32_t n_lo, int32_t n_hi, MegaState st,
    const uint8_t* __restrict__ patterns, const int32_t* __restrict__ lengths,
    int64_t B, int64_t C, int64_t s, int64_t step_offset, int ff_bound,
    int32_t* __restrict__ pml, int32_t* __restrict__ cid,
    int32_t* __restrict__ g_next) {
  const int64_t b = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (b >= B) return;
  const int64_t col = C - 1 - s;
  const bool more = s + 1 < C;
  const int32_t next_c = more ? __ldg(patterns + step_at(col - 1, b, B, C)) : 0;
  const int4* p = rows + 4 * b;
  const int4 q0 = __ldg(p), q1 = __ldg(p + 1), q2 = __ldg(p + 2),
             q3 = __ldg(p + 3);
  const int32_t w[16] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w,
                         q2.x, q2.y, q2.z, q2.w, q3.x, q3.y, q3.z, q3.w};
  const int32_t interval = st.interval[b];
  const int32_t offset = st.offset[b];
  const int32_t pos_lo = st.pos_lo[b];
  const int32_t pos_hi = kWide ? st.pos_hi[b] : 0;
  const int32_t mlen = st.mlen[b];
  const bool valid = s + step_offset < __ldg(lengths + b);

  bool match;
  int32_t cid_out, di, doff, lf_lo, lf_hi = 0, dlen0;
  bool take_pred, take_succ;
  if (kWide) {  // query_mega_wide.py:65-69 columns
    match = (w[0] >> 8) == 1;
    cid_out = w[0] & 0xFF;
    di = w[1];
    doff = add32(w[2], offset);
    lf_lo = add32(w[3], offset);
    const int32_t carry = lf_lo >= kLimb;
    lf_lo -= carry * kLimb;
    lf_hi = add32(w[4], carry);
    dlen0 = w[5];
    take_pred = !match && lt(pos_hi, pos_lo, w[7], w[6]) && w[12] >= 0;
    take_succ = !match && !take_pred && lt(w[7], w[6], n_hi, n_lo);
  } else {  // query_mega.py:8-17 columns
    match = w[0] == 1;
    cid_out = w[1];
    di = w[2];
    doff = add32(w[3], offset);
    lf_lo = add32(w[4], offset);
    dlen0 = w[5];
    take_pred = !match && pos_lo < w[6] && w[10] >= 0;
    take_succ = !match && !take_pred && w[6] < n_lo;
  }
  bool over = doff >= dlen0;
  di = add32(di, over);
  doff = add32(doff, over ? -dlen0 : 0);
  for (int t = 2; t < ff_bound; ++t) {
    const int32_t ln = __ldg(length + clip(di, r));
    over = doff >= ln;
    di = add32(di, over);
    doff = add32(doff, over ? -ln : 0);
  }
  // threshold_step (include/col_bwt.hpp:531-574): pred, else succ, else LF
  const int P = kWide ? 12 : 10, S = kWide ? 8 : 7;
  const int32_t ni = take_pred ? w[P] : (take_succ ? w[S] : di);
  const int32_t no = take_pred ? w[P + 1] : (take_succ ? w[S + 1] : doff);
  const int32_t nlo = take_pred ? w[P + 2] : (take_succ ? w[S + 2] : lf_lo);
  const int32_t nhi = kWide ? (take_pred ? w[15] : (take_succ ? w[11] : lf_hi))
                            : 0;
  const int32_t nlen = match ? add32(mlen, 1) : 0;
  if (valid) {
    st.interval[b] = ni;
    st.offset[b] = no;
    st.pos_lo[b] = nlo;
    if (kWide) st.pos_hi[b] = nhi;
    st.mlen[b] = nlen;
  }
  const int64_t at = step_at(col, b, B, C);
  const int32_t out_len = valid ? nlen : 0, out_cid = valid ? cid_out : 0;
  if (kStepInterleave) {
    reinterpret_cast<int2*>(pml)[at] = make_int2(out_len, out_cid);
  } else {
    pml[at] = out_len;
    cid[at] = out_cid;
  }
  if (more) {
    g_next[b] = add32(mul32(next_c, static_cast<int32_t>(r)),
                      valid ? ni : interval);
  }
}

// ---------------------------------------------------------------------------
// K13a: the recurrence of query_step.  The packed SoA row is [char, idx,
// length, dest_interval, dest_offset, col_id, threshold, 0]; the jump row at
// (c, interval) is [succ, pred].  A character step is a chain of dependent
// gather rounds:
//   1 rows soa[interval], jump[c, interval]: cid, match, si, pi
//   2 rows soa[si], soa[pi]: threshold reposition -> new interval/offset/len
//   3 row soa[new interval]: di, doff
//   4 row soa[di]: pos = idx + doff, then the first fast-forward round
//   5 row soa[di]: one more fast-forward round (ff_bound - 2 of them)
// Lanes past their read's end keep their state and write zeros.  The
// arithmetic of each round is one __device__ function below, called by both
// routes: the per-round kernel (a launch a round, values carried in a (9, B)
// scratch between launches) and the chunk scan (every step in one launch,
// state in registers, rows read from the shards on this card).

enum { kChar = 0, kIdx, kLen, kDi, kDoff, kCid, kThr, kSoaWidth = 8 };
enum { sCid = 0, sMatch, sSi, sPi, sNoff, sNlen, sDi, sDoff, sNpos };

// round 2: where a mismatch repositions (pred if pos < thr and one exists,
// else succ if one exists, else stay), and the new offset and length
struct Reposition {
  int32_t interval, offset, length;
};

__device__ __forceinline__ Reposition compact_reposition(
    bool match, int32_t si, int32_t pi, int32_t succ_thr, int32_t pred_len,
    int32_t interval, int32_t offset, int32_t pos, int32_t length, int32_t r,
    int32_t n) {
  const bool has_succ = si < r, has_pred = pi >= 0;
  const int32_t thr = has_succ ? succ_thr : n;
  const bool use_pred = pos < thr && has_pred;
  const int32_t ti = use_pred ? pi : (has_succ ? si : interval);
  const int32_t toff = use_pred ? add32(pred_len, -1) : (has_succ ? 0 : offset);
  return {match ? interval : ti, match ? offset : toff,
          match ? add32(length, 1) : 0};
}

// rounds 4 and 5: one fast-forward round against the length of run di
__device__ __forceinline__ void compact_fast_forward(int32_t ln, int32_t& di,
                                                     int32_t& doff) {
  const bool over = doff >= ln;
  di = add32(di, over);
  doff = add32(doff, over ? -ln : 0);
}

// kScratchTrim: the round kernel keeps in its (9, B) scratch only what a
// later round reads and no other array holds: si and pi are g_a and g_b
// after round 1, di is g_a after rounds 3-5, and the last round keeps its
// values in registers (rows sSi, sPi, sDi stay unwritten).  Storing every
// value, as the kernel did before the redesign, took 1.4x as long on the
// card at G-round's 263,168 lanes (PERF.md §6).
constexpr bool kScratchTrim = true;

__global__ void __launch_bounds__(kThreads) sharded_step_compact_kernel(
    int rnd, bool last, const int32_t* __restrict__ row_a,
    const int32_t* __restrict__ row_b, int32_t* __restrict__ scratch,
    int32_t* __restrict__ interval, int32_t* __restrict__ offset,
    int32_t* __restrict__ pos, int32_t* __restrict__ length,
    const uint8_t* __restrict__ patterns, const int32_t* __restrict__ lengths,
    int64_t B, int64_t M, int64_t i, int32_t r, int32_t n, int ff_bound,
    int32_t* __restrict__ pml, int32_t* __restrict__ cid,
    int32_t* __restrict__ g_a, int32_t* __restrict__ g_b,
    int32_t* __restrict__ s_b) {
  const int64_t b = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (b >= B) return;
  int32_t* sc = scratch + b;  // column-major (9, B)
  const int32_t* a = row_a + kSoaWidth * b;
  if (rnd == 1) {
    const int32_t c = __ldg(patterns + step_at(M - 1 - i, b, B, M));
    const int2 sp = __ldg(reinterpret_cast<const int2*>(row_b) + b);
    sc[sCid * B] = __ldg(a + kCid);
    sc[sMatch * B] = __ldg(a + kChar) == c;
    if (!kScratchTrim) {
      sc[sSi * B] = sp.x;
      sc[sPi * B] = sp.y;
    }
    g_a[b] = sp.x;
    g_b[b] = sp.y;
    return;
  }
  if (rnd == 2) {
    const int32_t si = kScratchTrim ? g_a[b] : sc[sSi * B];
    const int32_t pi = kScratchTrim ? g_b[b] : sc[sPi * B];
    const Reposition t = compact_reposition(
        sc[sMatch * B] != 0, si, pi, __ldg(a + kThr),
        __ldg(row_b + kSoaWidth * b + kLen), interval[b], offset[b], pos[b],
        length[b], r, n);
    sc[sNoff * B] = t.offset;
    sc[sNlen * B] = t.length;
    g_a[b] = t.interval;
    return;
  }
  int32_t di, doff, npos = 0;
  if (rnd == 3) {
    di = __ldg(a + kDi);
    doff = add32(__ldg(a + kDoff), sc[sNoff * B]);
  } else {
    di = kScratchTrim ? g_a[b] : sc[sDi * B];
    doff = sc[sDoff * B];
    if (rnd == 4) npos = add32(__ldg(a + kIdx), doff);
    if (rnd == 5 || ff_bound >= 2) {
      compact_fast_forward(__ldg(a + kLen), di, doff);
    }
  }
  g_a[b] = di;
  if (!(kScratchTrim && last)) {
    if (!kScratchTrim) sc[sDi * B] = di;
    sc[sDoff * B] = doff;
    if (rnd == 4) sc[sNpos * B] = npos;
  }
  if (!last) return;
  const int64_t col = M - 1 - i;
  const bool more = i + 1 < M;
  const int32_t next_c =
      more ? __ldg(patterns + step_at(col - 1, b, B, M)) : 0;
  const bool valid = i < __ldg(lengths + b);
  const int32_t nlen = sc[sNlen * B];
  if (rnd != 4) npos = sc[sNpos * B];
  int32_t now = interval[b];
  if (valid) {
    now = di;
    interval[b] = di;
    offset[b] = doff;
    pos[b] = npos;
    length[b] = nlen;
  }
  const int64_t at = step_at(col, b, B, M);
  pml[at] = valid ? nlen : 0;
  cid[at] = valid ? sc[sCid * B] : 0;
  if (more) {
    g_a[b] = now;
    g_b[b] = now;
    s_b[b] = next_c;
  }
}

// The run row at global index g (two 16-byte loads: fields 0-3, 4-7) from
// the shard of this card that owns it, zeros where none does.
struct RunRow {
  int4 lo, hi;
};

__device__ __forceinline__ RunRow run_row(const long long* __restrict__ tab,
                                          int ip, int64_t L, int32_t g) {
  RunRow w{};
  const colbwt::ShardRow o = colbwt::shard_row(tab, ip, L, g);
  if (o.base != nullptr) {
    const int4* p = static_cast<const int4*>(o.base) + 2 * clip(o.local,
                                                                o.rows);
    w.lo = __ldg(p);
    w.hi = __ldg(p + 1);
  }
  return w;
}

// The jump row [succ, pred] at (c, g): row c * L + local of the owner.
__device__ __forceinline__ int2 jump_row(const long long* __restrict__ tab,
                                         int ip, int64_t L, int32_t c,
                                         int32_t g) {
  const colbwt::ShardRow o = colbwt::shard_row(tab, ip, L, g);
  if (o.base == nullptr) return make_int2(0, 0);
  return __ldg(static_cast<const int2*>(o.base) +
               clip(static_cast<int64_t>(c) * L + o.local, o.rows));
}

// K13a chunk scan: one thread a read, all M steps in one launch, every
// shard of the dp row on this card.  A read's steps end at its length: the
// state stays and the remaining columns are zeros, as the masked steps
// give them.  The outputs are written column-major, (M, B) planes as the
// JAX scan stacks its steps before it transposes them: a warp's stores of
// one step then fill whole sectors, where row-major (B, M) stores write 4
// bytes into each of 32 sectors, and those partial writes bounded the
// kernel (on an H100 at G-compact's shape 9.41 ms, against 4.73 ms for the
// column-major kernel and the wrapper's transposes: PERF.md §6).

// the chunk scan's block: small blocks spread the reads over every SM
constexpr int kScanThreads = 128;

__global__ void sharded_scan_compact_kernel(
    const long long* __restrict__ soa, const long long* __restrict__ jump,
    int ip, int64_t L, const uint8_t* __restrict__ patterns,
    const int32_t* __restrict__ lengths, int32_t* __restrict__ interval_io,
    int32_t* __restrict__ offset_io, int32_t* __restrict__ pos_io,
    int32_t* __restrict__ length_io, int64_t B, int64_t M, int32_t r,
    int32_t n, int ff_bound, int32_t* __restrict__ pml,
    int32_t* __restrict__ cid) {
  const int64_t b = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (b >= B) return;
  int32_t interval = interval_io[b], offset = offset_io[b];
  int32_t pos = pos_io[b], length = length_io[b];
  const int64_t len = lengths[b];
  const int64_t steps = len < M ? (len < 0 ? 0 : len) : M;
  const uint8_t* pat = patterns + b * M;
  for (int64_t i = 0; i < steps; ++i) {
    const int64_t col = M - 1 - i;
    const int32_t c = pat[col];
    // round 1, then round 2: two independent reads each
    const RunRow cur = run_row(soa, ip, L, interval);
    const int2 sp = jump_row(jump, ip, L, c, interval);
    const RunRow succ = run_row(soa, ip, L, sp.x);
    const RunRow pred = run_row(soa, ip, L, sp.y);
    const Reposition t = compact_reposition(
        cur.lo.x == c, sp.x, sp.y, succ.hi.z, pred.lo.z, interval, offset,
        pos, length, r, n);
    // round 3
    const RunRow dst = run_row(soa, ip, L, t.interval);
    int32_t di = dst.lo.w;
    int32_t doff = add32(dst.hi.x, t.offset);
    // round 4, then ff_bound - 2 rounds of round 5
    const RunRow at = run_row(soa, ip, L, di);
    pos = add32(at.lo.y, doff);
    if (ff_bound >= 2) compact_fast_forward(at.lo.z, di, doff);
    for (int f = 2; f < ff_bound; ++f) {
      compact_fast_forward(run_row(soa, ip, L, di).lo.z, di, doff);
    }
    interval = di;
    offset = doff;
    length = t.length;
    pml[col * B + b] = t.length;
    cid[col * B + b] = cur.hi.y;
  }
  for (int64_t col = M - 1 - steps; col >= 0; --col) {
    pml[col * B + b] = 0;
    cid[col * B + b] = 0;
  }
  interval_io[b] = interval;
  offset_io[b] = offset;
  pos_io[b] = pos;
  length_io[b] = length;
}

// K13e chunk scan: one thread a read, every step of the (B, M) batch in
// one launch, every shard of the dp row on this card.  pos (n - 1 at the
// start) and the match length live in registers.  A step folds the lane's
// next k characters into its key (high digit first, the int32 wrap of
// add32/mul32) while the row is in flight, as K3 does, then reads the
// 8-byte row key * L + clip(pos - i * L, 0, L - 1) of the shard i that owns
// pos (shards.cuh; zeros where no shard of the card owns it, as JAX's
// masked take summed over "ip"), and writes its k outputs ln << 8 | cid.
// The outputs go to an (M, B) plane, which the wrapper transposes, so a
// warp's k stores of a step are each 32 neighbouring words ((B, M) rows
// would put 4 bytes into each of 32 sectors; at k = 3 a step's outputs
// are no vector store).  What bounds it: the chain of 51 dependent row
// reads a lane at G-pos's shape, each a cold 32-byte sector of a 7 GB
// table, and the 160 MB of outputs.
__global__ void __launch_bounds__(kScanThreads) sharded_scan_pos_kernel(
    const long long* __restrict__ tab, int ip, int64_t L,
    const uint8_t* __restrict__ patterns, int64_t B, int64_t M, int k,
    int32_t A, int64_t n, int32_t* __restrict__ packed) {
  const int64_t b = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (b >= B) return;
  const int pb = 32 - k;
  const uint32_t mask = (1u << pb) - 1u;
  const uint8_t* pat = patterns + b * M;
  const int64_t steps = M / k;
  int32_t key = 0;
  for (int j = 0; j < k; ++j) key = add32(mul32(key, A), __ldg(pat + M - 1 - j));
  int32_t pos = static_cast<int32_t>(n - 1);
  uint32_t ln = 0;
  for (int64_t t = 0; t < steps; ++t) {
    int2 w = make_int2(0, 0);
    const colbwt::ShardRow o = colbwt::shard_row(tab, ip, L, pos);
    if (o.base != nullptr) {
      const int64_t row = static_cast<int64_t>(key) * L + o.local;
      w = __ldg(static_cast<const int2*>(o.base) + clip(row, o.rows));
    }
    // the next step's key, loaded while the row is in flight
    int32_t next = 0;
    if (t + 1 < steps) {
      for (int j = 0; j < k; ++j) {
        next = add32(mul32(next, A), __ldg(pat + M - 1 - ((t + 1) * k + j)));
      }
    }
    const uint32_t w0 = static_cast<uint32_t>(w.x);
    const uint32_t w1 = static_cast<uint32_t>(w.y);
    for (int j = 0; j < k; ++j) {
      ln = (ln + 1u) * ((w0 >> (pb + j)) & 1u);
      const int64_t col = M - 1 - (t * k + j);
      packed[col * B + b] =
          static_cast<int32_t>((ln << 8) | ((w1 >> (8 * j)) & 0xFFu));
    }
    pos = static_cast<int32_t>(w0 & mask);
    key = next;
  }
}

int blocks_for(int64_t B, int threads = kThreads) {
  const int64_t blocks = (B + threads - 1) / threads;
  return static_cast<int>(blocks < 1 ? 1 : blocks);
}

}  // namespace

extern "C" {

// tab (2 * ip,) int64: the card's shard bases (0 where another card holds
// the shard) and row counts; each shard (rows, W) int32 with W in {2, 8,
// 16}, 8- or 16-byte aligned; g, s (B,) int32 (s may be null: selector 0);
// out (B, W) int32.  One launch for all the card's shards.
int colbwt_sharded_fetch(const void* tab, int64_t ip, int64_t L, int64_t W,
                         const void* g, const void* s, int64_t B,
                         int64_t stride, void* out, void* stream) {
  auto* t = static_cast<const long long*>(tab);
  auto* gi = static_cast<const int32_t*>(g);
  auto* si = static_cast<const int32_t*>(s);
  auto* o = static_cast<int32_t*>(out);
  auto strm = static_cast<cudaStream_t>(stream);
  const int n = static_cast<int>(ip);
  switch (W) {
    case 2: return launch_fetch<2>(t, n, L, gi, si, stride, B, o, strm);
    case 8: return launch_fetch<8>(t, n, L, gi, si, stride, B, o, strm);
    case 16: return launch_fetch<16>(t, n, L, gi, si, stride, B, o, strm);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// t1 (t1_rows, 2) int32; out (A**k * n_local, 2) int32.
int colbwt_compose_sharded_tk(const void* t1, int64_t t1_rows, int64_t n,
                              int64_t n_local, int64_t lo, int64_t A,
                              int64_t k, void* out, void* stream) {
  if (k < 1 || k > kTkMaxK || A < 1 || A > 256 || n < 1 || n_local < 1 ||
      t1_rows < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int64_t prefixes = 1;
  for (int64_t j = 1; j < k; ++j) prefixes *= A;
  const int64_t tiles = (n_local + kTkTile - 1) / kTkTile;
  if (prefixes * tiles > INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  compose_sharded_tk_kernel<<<static_cast<unsigned>(prefixes * tiles),
                              kTkThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int2*>(t1), t1_rows, n, n_local, lo,
      static_cast<int>(A), static_cast<int>(k),
      static_cast<uint32_t>(prefixes), static_cast<uint32_t>(tiles),
      static_cast<int2*>(out));
  return static_cast<int>(cudaGetLastError());
}

// K13e's parameter block, prepared once a batch (field for field
// parallel/query_sharded_pos.py _StepPosArgs): rows (B, 2) int32, 8-byte
// aligned; pos, mlen (B,) int32, updated in place; patterns (M, B) uint8;
// packed (M, B) int32; g_next, s_next (B,) int32.
struct StepPosArgs {
  const void* rows;
  void *pos, *mlen;
  const void* patterns;
  int64_t B, M, k, A;
  void *packed, *g_next, *s_next;
  void* stream;
};

// step t of the batch (0 <= t < M / k).
int colbwt_sharded_step_pos(const void* args, int64_t t) {
  const auto& a = *static_cast<const StepPosArgs*>(args);
  if (a.k < 1 || a.k > 4 || a.M % a.k || t < 0 || t >= a.M / a.k) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  sharded_step_pos_kernel<<<blocks_for(a.B), kThreads, 0,
                            static_cast<cudaStream_t>(a.stream)>>>(
      static_cast<const int2*>(a.rows), static_cast<int32_t*>(a.pos),
      static_cast<int32_t*>(a.mlen), static_cast<const uint8_t*>(a.patterns),
      a.B, a.M, t, static_cast<int>(a.k), static_cast<int32_t>(a.A),
      static_cast<int32_t*>(a.packed), static_cast<int32_t*>(a.g_next),
      static_cast<int32_t*>(a.s_next));
  return static_cast<int>(cudaGetLastError());
}

// tab (2 * ip,) int64: the card's shards of the T_k table ((A**k * L, 2)
// int32 each, 8-byte aligned); patterns (B, M) uint8, M a multiple of k;
// packed (M, B) int32 (column-major), every entry written.
int colbwt_sharded_scan_pos(const void* tab, int64_t ip, int64_t L,
                            const void* patterns, int64_t B, int64_t M,
                            int64_t k, int64_t A, int64_t n, void* packed,
                            void* stream) {
  if (k < 1 || k > 4 || M % k || n < 1 || L < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  sharded_scan_pos_kernel<<<blocks_for(B, kScanThreads), kScanThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(tab), static_cast<int>(ip), L,
      static_cast<const uint8_t*>(patterns), B, M, static_cast<int>(k),
      static_cast<int32_t>(A), n, static_cast<int32_t*>(packed));
  return static_cast<int>(cudaGetLastError());
}

// K13b/K13c's parameter block, prepared once a chunk (field for field
// parallel/query_sharded_mega.py _StepMegaArgs): rows (B, 16) int32;
// length (r,) int32; the state arrays (B,) int32, updated in place (pos_hi
// null when narrow); narrow n in n_lo; patterns (C, B) uint8; lengths (B,)
// int32; pml, cid (C, B) int32; g_next (B,) int32.
struct StepMegaArgs {
  const void* rows;
  const void* length;
  int64_t r, n_lo, n_hi;
  void *interval, *offset, *pos_lo, *pos_hi, *mlen;
  const void* patterns;
  const void* lengths;
  int64_t B, C, step_offset, ff_bound, wide;
  void *pml, *cid, *g_next;
  void* stream;
};

// step s of the chunk (0 <= s < C).
int colbwt_sharded_step_mega(const void* args, int64_t s) {
  const auto& a = *static_cast<const StepMegaArgs*>(args);
  if (s < 0 || s >= a.C) return static_cast<int>(cudaErrorInvalidValue);
  const MegaState st{static_cast<int32_t*>(a.interval),
                     static_cast<int32_t*>(a.offset),
                     static_cast<int32_t*>(a.pos_lo),
                     static_cast<int32_t*>(a.pos_hi),
                     static_cast<int32_t*>(a.mlen)};
  auto* rw = static_cast<const int4*>(a.rows);
  auto* ln = static_cast<const int32_t*>(a.length);
  auto* pat = static_cast<const uint8_t*>(a.patterns);
  auto* lens = static_cast<const int32_t*>(a.lengths);
  auto* pm = static_cast<int32_t*>(a.pml);
  auto* ci = static_cast<int32_t*>(a.cid);
  auto* gn = static_cast<int32_t*>(a.g_next);
  auto strm = static_cast<cudaStream_t>(a.stream);
  const int ff = static_cast<int>(a.ff_bound);
  if (a.wide) {
    sharded_step_mega_kernel<true><<<blocks_for(a.B), kThreads, 0, strm>>>(
        rw, ln, a.r, static_cast<int32_t>(a.n_lo),
        static_cast<int32_t>(a.n_hi), st, pat, lens, a.B, a.C, s,
        a.step_offset, ff, pm, ci, gn);
  } else {
    sharded_step_mega_kernel<false><<<blocks_for(a.B), kThreads, 0, strm>>>(
        rw, ln, a.r, static_cast<int32_t>(a.n_lo), 0, st, pat, lens, a.B,
        a.C, s, a.step_offset, ff, pm, ci, gn);
  }
  return static_cast<int>(cudaGetLastError());
}

// K13a's parameter block, prepared once a batch (field for field
// parallel/query_sharded.py _RoundCompactArgs): row_a (B, 8); row_jump
// (B, 2), read in round 1, and row_run (B, 8), read in round 2 (null where
// the caller makes neither round); scratch (9, B); the state arrays (B,)
// updated in place; patterns (M, B) uint8; lengths (B,); pml, cid (M, B);
// g_a, g_b, s_b (B,) written.
struct RoundCompactArgs {
  const void* row_a;
  const void* row_jump;
  const void* row_run;
  void* scratch;
  void *interval, *offset, *pos, *length;
  const void* patterns;
  const void* lengths;
  int64_t B, M, r, n, ff_bound;
  void *pml, *cid, *g_a, *g_b, *s_b;
  void* stream;
};

// round rnd (1-5) of character step i (0 <= i < M); last: the step's last
// round, which writes the step's outputs and state.
int colbwt_sharded_step_compact(const void* args, int64_t rnd, int64_t last,
                                int64_t i) {
  const auto& a = *static_cast<const RoundCompactArgs*>(args);
  const void* row_b = rnd == 1 ? a.row_jump : a.row_run;
  if (rnd < 1 || rnd > 5 || i < 0 || i >= a.M ||
      (rnd <= 2 && row_b == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  sharded_step_compact_kernel<<<blocks_for(a.B), kThreads, 0,
                                static_cast<cudaStream_t>(a.stream)>>>(
      static_cast<int>(rnd), last != 0, static_cast<const int32_t*>(a.row_a),
      static_cast<const int32_t*>(row_b), static_cast<int32_t*>(a.scratch),
      static_cast<int32_t*>(a.interval), static_cast<int32_t*>(a.offset),
      static_cast<int32_t*>(a.pos), static_cast<int32_t*>(a.length),
      static_cast<const uint8_t*>(a.patterns),
      static_cast<const int32_t*>(a.lengths), a.B, a.M, i,
      static_cast<int32_t>(a.r), static_cast<int32_t>(a.n),
      static_cast<int>(a.ff_bound), static_cast<int32_t*>(a.pml),
      static_cast<int32_t*>(a.cid), static_cast<int32_t*>(a.g_a),
      static_cast<int32_t*>(a.g_b), static_cast<int32_t*>(a.s_b));
  return static_cast<int>(cudaGetLastError());
}

// soa, jump (2 * ip,) int64: the card's shard arrays of the run rows ((L,
// 8) int32 shards) and of the jump rows ((sigma' * L, 2) int32 shards);
// patterns (B, M) uint8; lengths (B,) int32; the state arrays (B,) updated
// in place; pml, cid (M, B) int32 (column-major), every entry written.
int colbwt_sharded_scan_compact(const void* soa, const void* jump, int64_t ip,
                                int64_t L, const void* patterns,
                                const void* lengths, void* interval,
                                void* offset, void* pos, void* length,
                                int64_t B, int64_t M, int64_t r, int64_t n,
                                int64_t ff_bound, void* pml, void* cid,
                                void* stream) {
  sharded_scan_compact_kernel<<<blocks_for(B, kScanThreads), kScanThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(soa), static_cast<const long long*>(jump),
      static_cast<int>(ip), L, static_cast<const uint8_t*>(patterns),
      static_cast<const int32_t*>(lengths), static_cast<int32_t*>(interval),
      static_cast<int32_t*>(offset), static_cast<int32_t*>(pos),
      static_cast<int32_t*>(length), B, M, static_cast<int32_t>(r),
      static_cast<int32_t>(n), static_cast<int>(ff_bound),
      static_cast<int32_t*>(pml), static_cast<int32_t*>(cid));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
