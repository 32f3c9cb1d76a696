// Mega-engine scans for Hopper (sm_90a): K5, K6a and the chunk scan of
// K13b/K13c.
//
// Replaces four jitted XLA programs:
//   K5  colbwt_query_chunk_mega       <- colbwt_tpu/ops/query_mega.py:116
//       query_chunk_mega (with query_batch_mega :212, initial_state :104)
//   K6a colbwt_query_chunk_mega_wide  <- colbwt_tpu/ops/query_mega_wide.py:369
//       query_chunk_mega_wide (with query_batch_mega_wide :486,
//       initial_state_wide :352 and the limb comparison _lt :364)
//   K13b/K13c colbwt_sharded_scan_mega <- the lax.scan inside shard_map of
//       colbwt_tpu/parallel/query_sharded_mega.py:53 _sharded_mega_query
//       (fetch :62-66) and query_sharded_mega_wide.py:101
//       _sharded_mega_wide_chunk (fetch :117-122, long-read loop :233)
//
// What bounds them on an H100: per read and character, one random gather of
// a 64-byte table row at c * r + interval (in the wide compact layout a
// 32-byte shared row plus a 40-byte per-char row), and ff_bound - 2 more
// gathers into the r-sized length array.  Each row's address depends on the
// row before it.  At r = 1.37M runs and sigma + 1 = 6 the table is 525 MB,
// ten times the 50 MB L2, so nearly every row is a cold HBM read: the scan
// is bound by memory latency times the steps of a read, not by bandwidth.
//
// The simple design: one thread per read, walking its M columns right to
// left; a row is read with 16-byte (8-byte for the 40-byte row) vector
// loads.  Latency is hidden only by the number of reads in flight (8,192 in
// a dispatch batch); several reads per thread with interleaved loads is
// later work.  A 16-read chunk waits on its chains alone (0.39 us a step);
// in a dispatch batch the scattered row loads queue in the memory system
// (1.4 us a step) however the batch is spread: blocks of 32, 64 and 128
// threads, which put it on all 132, on 128 and on 64 of the SMs, run within
// 3% (scan_designs.py on an H100).
//
// The output layout is the one that measured faster for each entry point.
// K5 and K6a store row-major (B, M) planes: their dispatch batches' planes
// (4-16 MB) stay in the 50 MB L2, which merges the partial sector writes,
// and column-major planes with the device transposes they need took 0.235
// ms against 0.217 at 8,192 x 255 (one u16 plane; scan_designs.py on an
// H100).  The chunk scan stores column-major (M, B) planes, which its
// wrapper transposes: a batch of 263,168 reads writes 318 MB, where a
// warp's row-major store fills 32 partial sectors that reach device
// memory.
//
// One templated scan serves five row readers: the narrow row with int32
// positions, the wide full row whose base-2**30 position limbs are joined to
// int64 at the gather, the wide compact pair of rows, and the narrow and
// wide full rows of a table split over "ip" whose shards all sit on this
// card (K13b/K13c).  The sharded JAX programs fetch each step's rows with a
// masked take and a psum over "ip"; the port's step route pays a fetch
// launch, a sum and a step launch a step, and writes the summed rows to
// memory between them.  Where every shard of a dp row sits on one card the
// sum is a selection, so the sharded readers pick each lane's owning shard
// (one 32-bit division, shards.cuh) and the whole chunk runs in one launch,
// state in registers, bound by memory latency as K5 and K6a are.
//
// Wide positions are int64 inside the kernel and are split into limbs again
// only where the state leaves it.  Narrow sums wrap as int32, as in the JAX
// program; wide sums are exact, which equals the JAX limb arithmetic for
// every valid state (offsets < 2**29, so one carry normalises).  Every row
// index is int64 and clamped as jnp.take(..., mode="clip") does, except a
// sharded row that no shard owns, which reads as zeros.
//
// Plain C interface (ctypes); each entry point launches on the caller's
// stream, allocates nothing and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "shards.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int64_t kLimb = int64_t(1) << 30;
// the layouts of the outputs (see above): K5 and K6a row-major
constexpr bool kBatchColMajor = false;

__device__ __forceinline__ int64_t clip(int64_t i, int64_t size) {
  return i < 0 ? 0 : (i >= size ? size - 1 : i);
}

// int32 addition and product with the two's-complement wrap of the JAX
// programs
__device__ __forceinline__ int32_t add32(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) +
                              static_cast<uint32_t>(b));
}

__device__ __forceinline__ int32_t mul32(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) *
                              static_cast<uint32_t>(b));
}

__device__ __forceinline__ int64_t join(int32_t lo, int32_t hi) {
  return static_cast<int64_t>(hi) * kLimb + lo;
}

// What one step needs of the row(s) at (c, interval).
struct Row {
  bool match;
  int32_t cid, di0, doff0, dlen0, s_int, s_off, p_int, p_off;
  int64_t lf_pos0, thr, s_pos, p_pos;
};

// Narrow row (query_mega.py:8-17): [match, cid, di0, doff0, lf_pos0, dlen0,
// thr, s_int, s_off, s_pos, p_int, p_off, p_pos, 0, 0, 0]; the first 13
// words in a, b, d and p_pos.
__device__ __forceinline__ Row narrow_row(int4 a, int4 b, int4 d,
                                          int32_t p_pos) {
  Row w;
  w.match = a.x == 1;
  w.cid = a.y;
  w.di0 = a.z;
  w.doff0 = a.w;
  w.lf_pos0 = b.x;
  w.dlen0 = b.y;
  w.thr = b.z;
  w.s_int = b.w;
  w.s_off = d.x;
  w.s_pos = d.y;
  w.p_int = d.z;
  w.p_off = d.w;
  w.p_pos = p_pos;
  return w;
}

struct NarrowRows {
  static constexpr bool kWide = false;
  const int4* __restrict__ mega;
  int64_t rows, r;
  __device__ __forceinline__ Row load(int32_t c, int32_t interval) const {
    const int4* p = mega + 4 * clip(c * r + interval, rows);
    return narrow_row(__ldg(p), __ldg(p + 1), __ldg(p + 2),
                      __ldg(reinterpret_cast<const int32_t*>(p + 3)));
  }
};

// Wide full row (query_mega_wide.py:65-69): [match << 8 | cid, di0, doff0,
// lf_lo, lf_hi, dlen0, thr_lo, thr_hi, s_int, s_off, s_lo, s_hi, p_int,
// p_off, p_lo, p_hi].
__device__ __forceinline__ Row wide_full_row(int4 a, int4 b, int4 d,
                                             int4 e) {
  Row w;
  w.match = (a.x >> 8) == 1;
  w.cid = a.x & 0xFF;
  w.di0 = a.y;
  w.doff0 = a.z;
  w.lf_pos0 = join(a.w, b.x);
  w.dlen0 = b.y;
  w.thr = join(b.z, b.w);
  w.s_int = d.x;
  w.s_off = d.y;
  w.s_pos = join(d.z, d.w);
  w.p_int = e.x;
  w.p_off = e.y;
  w.p_pos = join(e.z, e.w);
  return w;
}

struct WideFullRows {
  static constexpr bool kWide = true;
  const int4* __restrict__ mega;
  int64_t rows, r;
  __device__ __forceinline__ Row load(int32_t c, int32_t interval) const {
    const int4* p = mega + 4 * clip(c * r + interval, rows);
    return wide_full_row(__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3));
  }
};

// The same rows of a mega table split over "ip" (K13b narrow, K13c wide):
// row g = c*r + interval (int32, as the JAX programs compute it) from the
// shard that owns it (shards.cuh).  A row that no shard owns reads as zeros,
// as JAX's masked take summed over "ip" gives it; it is not clamped into
// the table as NarrowRows clamps.
template <bool Wide>
struct ShardedRows {
  static constexpr bool kWide = Wide;
  const long long* __restrict__ tab;
  int ip;
  int64_t L;
  int32_t r;
  __device__ __forceinline__ Row load(int32_t c, int32_t interval) const {
    const colbwt::ShardRow o =
        colbwt::shard_row(tab, ip, L, add32(mul32(c, r), interval));
    int4 a{}, b{}, d{}, e{};
    if (o.base != nullptr) {
      const int4* p = static_cast<const int4*>(o.base) + 4 * clip(o.local,
                                                                  o.rows);
      a = __ldg(p);
      b = __ldg(p + 1);
      d = __ldg(p + 2);
      e = Wide ? __ldg(p + 3)
               : make_int4(__ldg(reinterpret_cast<const int32_t*>(p + 3)), 0,
                           0, 0);
    }
    return Wide ? wide_full_row(a, b, d, e) : narrow_row(a, b, d, e.x);
  }
};
using ShardedNarrowRows = ShardedRows<false>;
using ShardedWideFullRows = ShardedRows<true>;

// Wide compact layout (query_mega_wide.py:71-78): shared row [char, cid,
// di0, doff0, lf_lo, lf_hi, dlen0, 0] at interval, per-char row [thr_lo,
// thr_hi, s_int, s_off, s_lo, s_hi, p_int, p_off, p_lo, p_hi] at c*r+interval.
struct WideCompactRows {
  static constexpr bool kWide = true;
  const int4* __restrict__ shared;
  const int2* __restrict__ percha;
  int64_t rows, r;
  __device__ __forceinline__ Row load(int32_t c, int32_t interval) const {
    const int4* s = shared + 2 * clip(interval, r);
    const int2* q = percha + 5 * clip(c * r + interval, rows);
    const int4 a = __ldg(s), b = __ldg(s + 1);
    const int2 t = __ldg(q), su = __ldg(q + 1), sp = __ldg(q + 2),
               pu = __ldg(q + 3), pp = __ldg(q + 4);
    Row w;
    w.match = a.x == c;
    w.cid = a.y;
    w.di0 = a.z;
    w.doff0 = a.w;
    w.lf_pos0 = join(b.x, b.y);
    w.dlen0 = b.z;
    w.thr = join(t.x, t.y);
    w.s_int = su.x;
    w.s_off = su.y;
    w.s_pos = join(sp.x, sp.y);
    w.p_int = pu.x;
    w.p_off = pu.y;
    w.p_pos = join(pp.x, pp.y);
    return w;
  }
};

enum OutMode { kTwoPlanes = 0, kPackedI32 = 1, kPackedU16 = 2 };

struct ScanArgs {
  const int32_t* length;  // (r,) run lengths, for rounds past the first
  int64_t r, n;
  const uint8_t* patterns;  // (B, M) dense char ids, right-aligned
  const int32_t* lengths;   // (B,) full read lengths
  const int32_t *interval0, *offset0, *pos_lo0, *pos_hi0, *mlen0;
  int64_t step_offset, B, M;
  int ff_bound;
  bool masked;
  int out_mode;
  void* out0;
  int32_t* out1;
  int32_t *interval1, *offset1, *pos_lo1, *pos_hi1, *mlen1;
};

// One thread per read: the read's columns right to left, state in registers;
// the outputs into (M, B) planes when ColMajor, else (B, M).
template <class Rows, bool ColMajor>
__global__ void mega_scan_kernel(const Rows rows, const ScanArgs a) {
  const int64_t b = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (b >= a.B) return;
  int32_t interval = a.interval0[b];
  int32_t offset = a.offset0[b];
  int32_t mlen = a.mlen0[b];
  int64_t pos = Rows::kWide ? join(a.pos_lo0[b], a.pos_hi0[b])
                            : static_cast<int64_t>(a.pos_lo0[b]);
  const int64_t len = a.lengths[b];
  const uint8_t* pat = a.patterns + b * a.M;
  for (int64_t s = 0; s < a.M; ++s) {
    const int64_t col = a.M - 1 - s;
    const int32_t c = pat[col];
    const Row w = rows.load(c, interval);

    // match / no-reposition path: LF, the first fast-forward round against
    // the row's dlen0, then ff_bound - 2 rounds gathering the length array
    int32_t doff = add32(w.doff0, offset);
    const int64_t lf_pos =
        Rows::kWide ? w.lf_pos0 + offset
                    : add32(static_cast<int32_t>(w.lf_pos0), offset);
    bool over = doff >= w.dlen0;
    int32_t di = w.di0 + over;
    doff -= over ? w.dlen0 : 0;
    for (int t = 2; t < a.ff_bound; ++t) {
      const int32_t ln = a.length[clip(di, a.r)];
      over = doff >= ln;
      di += over;
      doff -= over ? ln : 0;
    }

    // threshold_step (include/col_bwt.hpp:531-574): pred if pos < thr and
    // one exists; else succ if one exists (thr == n means none); else LF
    const bool take_pred = !w.match && pos < w.thr && w.p_int >= 0;
    const bool take_succ = !w.match && !take_pred && w.thr < a.n;
    const int32_t new_len = w.match ? add32(mlen, 1) : 0;
    uint32_t pml = static_cast<uint32_t>(new_len);
    uint32_t cid = static_cast<uint32_t>(w.cid);
    if (!a.masked || s + a.step_offset < len) {
      interval = take_pred ? w.p_int : (take_succ ? w.s_int : di);
      offset = take_pred ? w.p_off : (take_succ ? w.s_off : doff);
      pos = take_pred ? w.p_pos : (take_succ ? w.s_pos : lf_pos);
      mlen = new_len;
    } else {  // masked lane past its end: frozen state, zero outputs
      pml = 0;
      cid = 0;
    }
    const int64_t o = ColMajor ? col * a.B + b : b * a.M + col;
    if (a.out_mode == kTwoPlanes) {
      static_cast<int32_t*>(a.out0)[o] = static_cast<int32_t>(pml);
      a.out1[o] = static_cast<int32_t>(cid);
    } else if (a.out_mode == kPackedI32) {
      static_cast<int32_t*>(a.out0)[o] = static_cast<int32_t>((pml << 8) | cid);
    } else {
      static_cast<uint16_t*>(a.out0)[o] =
          static_cast<uint16_t>((pml << 8) | cid);
    }
  }
  a.interval1[b] = interval;
  a.offset1[b] = offset;
  a.mlen1[b] = mlen;
  if (Rows::kWide) {
    a.pos_lo1[b] = static_cast<int32_t>(pos & (kLimb - 1));
    a.pos_hi1[b] = static_cast<int32_t>(pos >> 30);
  } else {
    a.pos_lo1[b] = static_cast<int32_t>(pos);
  }
}

template <bool ColMajor, class Rows>
int launch(const Rows& rows, const ScanArgs& a, void* stream) {
  const int64_t blocks = (a.B + kThreads - 1) / kThreads;
  mega_scan_kernel<Rows, ColMajor><<<blocks < 1 ? 1 : blocks, kThreads, 0,
                                     static_cast<cudaStream_t>(stream)>>>(
      rows, a);
  return static_cast<int>(cudaGetLastError());
}

ScanArgs scan_args(const void* length, int64_t r, int64_t n,
                   const void* patterns, const void* lengths,
                   const void* interval0, const void* offset0,
                   const void* pos_lo0, const void* pos_hi0,
                   const void* mlen0, int64_t step_offset, int64_t B,
                   int64_t M, int64_t ff_bound, int64_t masked,
                   int64_t out_mode, void* out0, void* out1, void* interval1,
                   void* offset1, void* pos_lo1, void* pos_hi1, void* mlen1) {
  ScanArgs a;
  a.length = static_cast<const int32_t*>(length);
  a.r = r;
  a.n = n;
  a.patterns = static_cast<const uint8_t*>(patterns);
  a.lengths = static_cast<const int32_t*>(lengths);
  a.interval0 = static_cast<const int32_t*>(interval0);
  a.offset0 = static_cast<const int32_t*>(offset0);
  a.pos_lo0 = static_cast<const int32_t*>(pos_lo0);
  a.pos_hi0 = static_cast<const int32_t*>(pos_hi0);
  a.mlen0 = static_cast<const int32_t*>(mlen0);
  a.step_offset = step_offset;
  a.B = B;
  a.M = M;
  a.ff_bound = static_cast<int>(ff_bound);
  a.masked = masked != 0;
  a.out_mode = static_cast<int>(out_mode);
  a.out0 = out0;
  a.out1 = static_cast<int32_t*>(out1);
  a.interval1 = static_cast<int32_t*>(interval1);
  a.offset1 = static_cast<int32_t*>(offset1);
  a.pos_lo1 = static_cast<int32_t*>(pos_lo1);
  a.pos_hi1 = static_cast<int32_t*>(pos_hi1);
  a.mlen1 = static_cast<int32_t*>(mlen1);
  return a;
}

}  // namespace

extern "C" {

// K5: the narrow mega table ((sigma+1)*r, 16) int32; state (interval,
// offset, pos, mlen), each (B,) int32.
int colbwt_query_chunk_mega(
    const void* mega, int64_t rows, const void* length, int64_t r, int64_t n,
    const void* patterns, const void* lengths, const void* interval0,
    const void* offset0, const void* pos0, const void* mlen0,
    int64_t step_offset, int64_t B, int64_t M, int64_t ff_bound,
    int64_t masked, int64_t out_mode, void* out0, void* out1, void* interval1,
    void* offset1, void* pos1, void* mlen1, void* stream) {
  const NarrowRows rd{static_cast<const int4*>(mega), rows, r};
  return launch<kBatchColMajor>(
      rd, scan_args(length, r, n, patterns, lengths, interval0, offset0, pos0,
                    nullptr, mlen0, step_offset, B, M, ff_bound, masked,
                    out_mode, out0, out1, interval1, offset1, pos1, nullptr,
                    mlen1),
      stream);
}

// K6a: the wide tables, full ((sigma+1)*r, 16) when compact == 0, else
// shared (r, 8) + per-char ((sigma+1)*r, 10); n is the joined int64 value;
// state (interval, offset, pos_lo, pos_hi, mlen), each (B,) int32.
int colbwt_query_chunk_mega_wide(
    int64_t compact, const void* table, int64_t rows, const void* shared,
    const void* length, int64_t r, int64_t n, const void* patterns,
    const void* lengths, const void* interval0, const void* offset0,
    const void* pos_lo0, const void* pos_hi0, const void* mlen0,
    int64_t step_offset, int64_t B, int64_t M, int64_t ff_bound,
    int64_t masked, int64_t out_mode, void* out0, void* out1, void* interval1,
    void* offset1, void* pos_lo1, void* pos_hi1, void* mlen1, void* stream) {
  const ScanArgs a = scan_args(
      length, r, n, patterns, lengths, interval0, offset0, pos_lo0, pos_hi0,
      mlen0, step_offset, B, M, ff_bound, masked, out_mode, out0, out1,
      interval1, offset1, pos_lo1, pos_hi1, mlen1);
  if (compact) {
    const WideCompactRows rd{static_cast<const int4*>(shared),
                             static_cast<const int2*>(table), rows, r};
    return launch<kBatchColMajor>(rd, a, stream);
  }
  const WideFullRows rd{static_cast<const int4*>(table), rows, r};
  return launch<kBatchColMajor>(rd, a, stream);
}

// K13b/K13c: one chunk of the sharded mega scan, every shard of the dp row
// on this card.  tab (2 * ip,) int64 as colbwt_sharded_fetch's; the
// shards' (L, 16) int32 rows, narrow or wide full; n is the joined int64
// value; the state (B,) int32 (pos_hi null when narrow) is updated in
// place; masked; pml, cid (M, B) int32, column-major.
int colbwt_sharded_scan_mega(
    int64_t wide, const void* tab, int64_t ip, int64_t L, const void* length,
    int64_t r, int64_t n, const void* patterns, const void* lengths,
    void* interval, void* offset, void* pos_lo, void* pos_hi, void* mlen,
    int64_t step_offset, int64_t B, int64_t M, int64_t ff_bound, void* pml,
    void* cid, void* stream) {
  const ScanArgs a = scan_args(
      length, r, n, patterns, lengths, interval, offset, pos_lo, pos_hi, mlen,
      step_offset, B, M, ff_bound, 1, kTwoPlanes, pml, cid, interval, offset,
      pos_lo, pos_hi, mlen);
  auto* t = static_cast<const long long*>(tab);
  if (wide) {
    const ShardedWideFullRows rd{t, static_cast<int>(ip), L,
                                 static_cast<int32_t>(r)};
    return launch<true>(rd, a, stream);
  }
  const ShardedNarrowRows rd{t, static_cast<int>(ip), L,
                             static_cast<int32_t>(r)};
  return launch<true>(rd, a, stream);
}

}  // extern "C"
