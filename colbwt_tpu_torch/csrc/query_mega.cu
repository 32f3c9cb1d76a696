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
// A 16-read chunk waits on its chains alone (0.31-0.32 us a step); in a
// dispatch batch of 8,192 reads the scattered row loads queue in the
// memory system (0.8 us a step), so there the time follows the rows
// loaded in all.
//
// The design: one thread per read, its state in registers, blocks of one
// warp (a batch of 8,192 reads over 256 blocks), walking its columns right
// to left.
// - A lane walks only its own steps.  Masked, that is clamp(len -
//   step_offset, 0, M) columns: the columns left of the read are padding
//   whose outputs are zeros and whose steps leave the state frozen, so
//   they are stored as zeros after the walk and never load a row.  The
//   engine pads ~150-character reads to M = 255 (the u16 plane), and its
//   dispatch batches are scanned masked, so this takes ~40% of the rows
//   out of a batch; a long read's last chunk walks only its real columns.
//   Unmasked, the walk stays whole (pad columns hold computed values, the
//   chunk API's contract).
// - The walk is a latency chain, so what does not depend on it overlaps
//   it: the next step's row load starts as soon as the new interval is
//   known, ahead of the step's stores, and the step after next's
//   character is read while that row is in flight.
// - A matched step needs only the first 32 bytes of the 64-byte row
//   (match, cid, di0, doff0, lf_pos0, dlen0), and in the compact layout
//   the 32-byte shared row alone decides a match.  But a warp's step waits
//   on its slowest lane, and in a batch some lane nearly always
//   mismatches, so a second dependent load costs the whole warp: the
//   narrow and wide full readers load the whole row a step (the second
//   half on a mismatch measured 15-23% slower at the dispatch batch).  The
//   compact reader loads its 40-byte per-char row on a mismatch only: its
//   shared rows (43.8 MB at r = 1.37M) stay in the L2, so a matched step
//   is an L2 hit and a mismatch one more load (9% faster at the dispatch,
//   13% on 16 lanes).
// - The padding of row-major planes is stored through the 16-byte chunks
//   wholly inside a lane's row, scalar at its ends (11% faster than
//   scalar at the dispatch); the walk's outputs are stored one at a time
//   (through the chunks too measured 0-5% slower).  The table layouts do
//   not change.
//
// The output layout is the one that measured faster for each entry point.
// K5 and K6a store row-major (B, M) planes: their dispatch batches' planes
// (4-16 MB) stay in the 50 MB L2, which merges the partial sector writes,
// and column-major planes with the device transposes they need took 0.143
// ms against 0.126 at the masked 8,192 x 255 u16 batch (scan_designs.py
// on an H100).  The chunk scan stores column-major (M, B) planes, which its
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
// Semantics kept from the JAX programs: the CID is the current row's,
// sampled before the step; a mismatch repositions to the predecessor when
// pos < thr (strictly) and one exists, else to the successor when thr < n
// (thr == n: none), else LF-steps from the current state.  Wide positions
// are int64 inside the kernel and are split into limbs again only where
// the state leaves it.  Narrow sums wrap as int32, as in the JAX program;
// wide sums are exact, which equals the JAX limb arithmetic for every
// valid state (offsets < 2**29, so one carry normalises).  Every row index
// is int64 and clamped as jnp.take(..., mode="clip") does, except a sharded
// row that no shard owns, which reads as zeros.
//
// Plain C interface (ctypes); each entry point launches on the caller's
// stream, allocates nothing and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "shards.cuh"

namespace {

enum OutMode { kTwoPlanes = 0, kPackedI32 = 1, kPackedU16 = 2 };
// A lane's part of the output planes: its row of (B, M) row-major planes,
// the padding stored through 16-byte chunks; or its column of (M, B)
// column-major planes.
enum Layout { kRowPadVector, kColMajor };

constexpr int kThreads = 32;
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

// The words of a step's rows: the first half (a, b), and the second (d, e;
// f in the compact layout), which the compact reader loads on a mismatch
// only.
struct Raw {
  int4 a, b, d, e;
  int2 f;
};

// What every step needs of its row: the match and LF path.
struct Head {
  bool match;
  int32_t cid, di0, doff0, dlen0;
  int64_t lf_pos0;
};

// What a mismatched step needs: the threshold and the succ/pred outcomes.
struct Tail {
  int32_t s_int, s_off, p_int, p_off;
  int64_t thr, s_pos, p_pos;
};

// Narrow row (query_mega.py:8-17): [match, cid, di0, doff0, lf_pos0, dlen0,
// thr, s_int | s_off, s_pos, p_int, p_off, p_pos, 0, 0, 0]; a and b the
// first 32 bytes, d and e.x the succ/pred outcomes.
__device__ __forceinline__ Head narrow_head(const Raw& w) {
  return {w.a.x == 1, w.a.y, w.a.z, w.a.w, w.b.y, w.b.x};
}

__device__ __forceinline__ Tail narrow_tail(const Raw& w) {
  return {w.b.w, w.d.x, w.d.z, w.d.w, w.b.z, w.d.y, w.e.x};
}

struct NarrowRows {
  static constexpr bool kWide = false;
  const int4* __restrict__ mega;
  int64_t rows, r;
  __device__ __forceinline__ const int4* at(int32_t c,
                                            int32_t interval) const {
    return mega + 4 * clip(c * r + interval, rows);
  }
  __device__ __forceinline__ Raw load(int32_t c, int32_t interval) const {
    const int4* p = at(c, interval);
    Raw w;
    w.a = __ldg(p);
    w.b = __ldg(p + 1);
    w.d = __ldg(p + 2);
    w.e.x = __ldg(reinterpret_cast<const int32_t*>(p + 3));
    return w;
  }
  __device__ __forceinline__ Head head(const Raw& w, int32_t) const {
    return narrow_head(w);
  }
  __device__ __forceinline__ Tail tail(const Raw& w, int32_t,
                                       int32_t) const {
    return narrow_tail(w);
  }
};

// Wide full row (query_mega_wide.py:65-69): [match << 8 | cid, di0, doff0,
// lf_lo | lf_hi, dlen0, thr_lo, thr_hi | s_int, s_off, s_lo, s_hi | p_int,
// p_off, p_lo, p_hi]; a and b the first 32 bytes.
__device__ __forceinline__ Head wide_head(const Raw& w) {
  return {(w.a.x >> 8) == 1, w.a.x & 0xFF, w.a.y, w.a.z, w.b.y,
          join(w.a.w, w.b.x)};
}

__device__ __forceinline__ Tail wide_tail(const Raw& w) {
  return {w.d.x, w.d.y, w.e.x, w.e.y, join(w.b.z, w.b.w), join(w.d.z, w.d.w),
          join(w.e.z, w.e.w)};
}

struct WideFullRows {
  static constexpr bool kWide = true;
  const int4* __restrict__ mega;
  int64_t rows, r;
  __device__ __forceinline__ const int4* at(int32_t c,
                                            int32_t interval) const {
    return mega + 4 * clip(c * r + interval, rows);
  }
  __device__ __forceinline__ Raw load(int32_t c, int32_t interval) const {
    const int4* p = at(c, interval);
    Raw w;
    w.a = __ldg(p);
    w.b = __ldg(p + 1);
    w.d = __ldg(p + 2);
    w.e = __ldg(p + 3);
    return w;
  }
  __device__ __forceinline__ Head head(const Raw& w, int32_t) const {
    return wide_head(w);
  }
  __device__ __forceinline__ Tail tail(const Raw& w, int32_t,
                                       int32_t) const {
    return wide_tail(w);
  }
};

// The same rows of a mega table split over "ip" (K13b narrow, K13c wide):
// row g = c*r + interval (int32, as the JAX programs compute it) from the
// shard that owns it (shards.cuh), the whole row a load.  A row that no
// shard owns reads as zeros, as JAX's masked take summed over "ip" gives
// it; it is not clamped into the table as NarrowRows clamps.
template <bool Wide>
struct ShardedRows {
  static constexpr bool kWide = Wide;
  const long long* __restrict__ tab;
  int ip;
  int64_t L;
  int32_t r;
  __device__ __forceinline__ Raw load(int32_t c, int32_t interval) const {
    const colbwt::ShardRow o =
        colbwt::shard_row(tab, ip, L, add32(mul32(c, r), interval));
    Raw w{};
    if (o.base != nullptr) {
      const int4* p = static_cast<const int4*>(o.base) + 4 * clip(o.local,
                                                                  o.rows);
      w.a = __ldg(p);
      w.b = __ldg(p + 1);
      w.d = __ldg(p + 2);
      w.e = Wide ? __ldg(p + 3)
                 : make_int4(__ldg(reinterpret_cast<const int32_t*>(p + 3)),
                             0, 0, 0);
    }
    return w;
  }
  __device__ __forceinline__ Head head(const Raw& w, int32_t) const {
    return Wide ? wide_head(w) : narrow_head(w);
  }
  __device__ __forceinline__ Tail tail(const Raw& w, int32_t,
                                       int32_t) const {
    return Wide ? wide_tail(w) : narrow_tail(w);
  }
};
using ShardedNarrowRows = ShardedRows<false>;
using ShardedWideFullRows = ShardedRows<true>;

// Wide compact layout (query_mega_wide.py:71-78): shared row [char, cid,
// di0, doff0 | lf_lo, lf_hi, dlen0, 0] at interval (a, b), per-char row
// [thr_lo, thr_hi, s_int, s_off | s_lo, s_hi, p_int, p_off | p_lo, p_hi]
// at c*r+interval (d, e, f: five 8-byte loads), loaded on a mismatch only.
struct WideCompactRows {
  static constexpr bool kWide = true;
  const int4* __restrict__ shared;
  const int2* __restrict__ percha;
  int64_t rows, r;
  __device__ __forceinline__ void per_char(Raw& w, int32_t c,
                                           int32_t interval) const {
    const int2* q = percha + 5 * clip(c * r + interval, rows);
    const int2 t = __ldg(q), su = __ldg(q + 1), sp = __ldg(q + 2),
               pu = __ldg(q + 3);
    w.f = __ldg(q + 4);
    w.d = make_int4(t.x, t.y, su.x, su.y);
    w.e = make_int4(sp.x, sp.y, pu.x, pu.y);
  }
  __device__ __forceinline__ Raw load(int32_t c, int32_t interval) const {
    const int4* s = shared + 2 * clip(interval, r);
    Raw w;
    w.a = __ldg(s);
    w.b = __ldg(s + 1);
    return w;
  }
  __device__ __forceinline__ Head head(const Raw& w, int32_t c) const {
    return {w.a.x == c, w.a.y, w.a.z, w.a.w, w.b.z, join(w.b.x, w.b.y)};
  }
  __device__ __forceinline__ Tail tail(Raw w, int32_t c,
                                       int32_t interval) const {
    per_char(w, c, interval);
    return {w.d.z, w.d.w, w.e.z, w.e.w, join(w.d.x, w.d.y),
            join(w.e.x, w.e.y), join(w.f.x, w.f.y)};
  }
};

// One lane's part of a plane of T: its row of a (B, M) row-major plane,
// elements [r0, r0 + M), or its column of an (M, B) column-major one.  The
// walk stores its outputs one at a time, right to left (`put`); `finish`
// then stores zeros in the columns left of the walk, row-major through
// the 16-byte chunks wholly inside the row (scalar at the row's two ends).
template <typename T, int L>
struct Plane {
  static constexpr int64_t kN = 16 / sizeof(T);  // elements a chunk
  T* __restrict__ p;
  int64_t r0, r1;  // row-major: the row's elements; column-major: b, B

  __device__ __forceinline__ Plane(T* plane, int64_t b, int64_t B,
                                   int64_t M)
      : p(plane),
        r0(L == kColMajor ? b : b * M),
        r1(L == kColMajor ? B : b * M + M) {}

  __device__ __forceinline__ void put(int64_t col, uint32_t v) {
    p[L == kColMajor ? col * r1 + r0 : r0 + col] = static_cast<T>(v);
  }

  // zeros in columns [0, end)
  __device__ __forceinline__ void finish(int64_t end) const {
    if (L == kColMajor) {
      for (int64_t col = end - 1; col >= 0; --col) p[col * r1 + r0] = 0;
      return;
    }
    const int64_t e = r0 + end;  // elements [r0, e) are the padding
    const int64_t qe = e & ~(kN - 1);
    const int64_t qlo = (r0 + kN - 1) & ~(kN - 1);  // the first whole chunk
    for (int64_t x = e - 1; x >= (qe > r0 ? qe : r0); --x) p[x] = 0;
    for (int64_t q = qe - kN; q >= qlo; q -= kN) {
      *reinterpret_cast<uint4*>(p + q) = make_uint4(0, 0, 0, 0);
    }
    for (int64_t x = (qlo < qe ? qlo : qe) - 1; x >= r0; --x) p[x] = 0;
  }
};

// A lane's outputs in the planes of one output mode: two int32 planes, one
// packed (pml << 8 | cid) int32 plane, or one packed uint16 plane.
template <int Mode, int L>
struct Outputs {
  using T0 = typename std::conditional<Mode == kPackedU16, uint16_t,
                                       int32_t>::type;
  Plane<T0, L> o0;
  Plane<int32_t, L> o1;
  __device__ __forceinline__ Outputs(void* out0, int32_t* out1, int64_t b,
                                     int64_t B, int64_t M)
      : o0(static_cast<T0*>(out0), b, B, M), o1(out1, b, B, M) {}
  __device__ __forceinline__ void put(int64_t col, uint32_t pml,
                                      uint32_t cid) {
    if (Mode == kTwoPlanes) {
      o0.put(col, pml);
      o1.put(col, cid);
    } else {
      o0.put(col, (pml << 8) | cid);
    }
  }
  __device__ __forceinline__ void finish(int64_t end) {
    o0.finish(end);
    if (Mode == kTwoPlanes) o1.finish(end);
  }
};

struct ScanArgs {
  const int32_t* length;  // (r,) run lengths, for rounds past the first
  int64_t r, n;
  const uint8_t* patterns;  // (B, M) dense char ids, right-aligned
  const int32_t* lengths;   // (B,) full read lengths
  const int32_t *interval0, *offset0, *pos_lo0, *pos_hi0, *mlen0;
  int64_t step_offset, B, M;
  int ff_bound;
  bool masked;
  void* out0;
  int32_t* out1;
  // the final state; the sharded scan's alias the start state's
  int32_t *interval1, *offset1, *pos_lo1, *pos_hi1, *mlen1;
};

// One thread per read: the read's steps right to left, state in registers.
template <class Rows, int Mode, int L>
__global__ void __launch_bounds__(kThreads)
    mega_scan_kernel(const Rows rows, const ScanArgs a) {
  const int64_t b = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (b >= a.B) return;
  int32_t interval = a.interval0[b];
  int32_t offset = a.offset0[b];
  int32_t mlen = a.mlen0[b];
  int64_t pos = Rows::kWide ? join(a.pos_lo0[b], a.pos_hi0[b])
                            : static_cast<int64_t>(a.pos_lo0[b]);
  const int64_t M = a.M;
  // masked: the read's own steps, clamp(len - step_offset, 0, M)
  int64_t steps = M;
  if (a.masked) {
    const int64_t left = a.lengths[b] - a.step_offset;
    steps = left < 0 ? 0 : (left < M ? left : M);
  }
  const uint8_t* __restrict__ pat = a.patterns + b * M;
  Outputs<Mode, L> out(a.out0, a.out1, b, a.B, M);

  int32_t c = 0, c_next = 0;
  Raw w{};
  if (steps > 0) {
    c = __ldg(pat + M - 1);
    w = rows.load(c, interval);
    if (steps > 1) c_next = __ldg(pat + M - 2);
  }
  for (int64_t s = 0; s < steps; ++s) {
    const int64_t col = M - 1 - s;
    const Head h = rows.head(w, c);

    // match / no-reposition path: LF, the first fast-forward round against
    // the row's dlen0, then ff_bound - 2 rounds gathering the length array
    int32_t doff = add32(h.doff0, offset);
    int64_t new_pos = Rows::kWide
                          ? h.lf_pos0 + offset
                          : add32(static_cast<int32_t>(h.lf_pos0), offset);
    bool over = doff >= h.dlen0;
    int32_t di = h.di0 + over;
    doff -= over ? h.dlen0 : 0;
    for (int t = 2; t < a.ff_bound; ++t) {
      const int32_t ln = __ldg(a.length + clip(di, a.r));
      over = doff >= ln;
      di += over;
      doff -= over ? ln : 0;
    }

    // threshold_step (include/col_bwt.hpp:531-574): pred if pos < thr and
    // one exists; else succ if one exists (thr == n means none); else LF
    if (!h.match) {
      const Tail t = rows.tail(w, c, interval);
      if (pos < t.thr && t.p_int >= 0) {
        di = t.p_int;
        doff = t.p_off;
        new_pos = t.p_pos;
      } else if (t.thr < a.n) {
        di = t.s_int;
        doff = t.s_off;
        new_pos = t.s_pos;
      }
    }
    interval = di;
    offset = doff;
    pos = new_pos;
    mlen = h.match ? add32(mlen, 1) : 0;
    // the next step's row as soon as its interval is known, then this
    // step's stores and the character after next while the row is in flight
    if (s + 1 < steps) w = rows.load(c_next, interval);
    out.put(col, static_cast<uint32_t>(mlen), static_cast<uint32_t>(h.cid));
    c = c_next;
    if (s + 2 < steps) c_next = __ldg(pat + col - 2);
  }
  out.finish(M - steps);
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

template <int Mode, int L, class Rows>
int launch_as(const Rows& rows, const ScanArgs& a, void* stream) {
  const int64_t blocks = (a.B + kThreads - 1) / kThreads;
  mega_scan_kernel<Rows, Mode, L><<<blocks < 1 ? 1 : blocks, kThreads, 0,
                                    static_cast<cudaStream_t>(stream)>>>(
      rows, a);
  return static_cast<int>(cudaGetLastError());
}

// The batch scans (K5, K6a): row-major planes, 16-byte aligned, the
// padding through 16-byte chunks (column-major where kBatchColMajor).
template <class Rows>
int launch_batch(const Rows& rows, const ScanArgs& a, int out_mode,
                 void* stream) {
  constexpr int kL = kBatchColMajor ? kColMajor : kRowPadVector;
  if (out_mode == kTwoPlanes) return launch_as<kTwoPlanes, kL>(rows, a, stream);
  if (out_mode == kPackedI32) return launch_as<kPackedI32, kL>(rows, a, stream);
  return launch_as<kPackedU16, kL>(rows, a, stream);
}

ScanArgs scan_args(const void* length, int64_t r, int64_t n,
                   const void* patterns, const void* lengths,
                   const void* interval0, const void* offset0,
                   const void* pos_lo0, const void* pos_hi0,
                   const void* mlen0, int64_t step_offset, int64_t B,
                   int64_t M, int64_t ff_bound, int64_t masked, void* out0,
                   void* out1, void* interval1, void* offset1, void* pos_lo1,
                   void* pos_hi1, void* mlen1) {
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
  return launch_batch(
      rd, scan_args(length, r, n, patterns, lengths, interval0, offset0, pos0,
                    nullptr, mlen0, step_offset, B, M, ff_bound, masked,
                    out0, out1, interval1, offset1, pos1, nullptr, mlen1),
      static_cast<int>(out_mode), stream);
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
      mlen0, step_offset, B, M, ff_bound, masked, out0, out1, interval1,
      offset1, pos_lo1, pos_hi1, mlen1);
  if (compact) {
    const WideCompactRows rd{static_cast<const int4*>(shared),
                             static_cast<const int2*>(table), rows, r};
    return launch_batch(rd, a, static_cast<int>(out_mode), stream);
  }
  const WideFullRows rd{static_cast<const int4*>(table), rows, r};
  return launch_batch(rd, a, static_cast<int>(out_mode), stream);
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
      step_offset, B, M, ff_bound, 1, pml, cid, interval, offset, pos_lo,
      pos_hi, mlen);
  auto* t = static_cast<const long long*>(tab);
  if (wide) {
    const ShardedWideFullRows rd{t, static_cast<int>(ip), L,
                                 static_cast<int32_t>(r)};
    return launch_as<kTwoPlanes, kColMajor>(rd, a, stream);
  }
  const ShardedNarrowRows rd{t, static_cast<int>(ip), L,
                             static_cast<int32_t>(r)};
  return launch_as<kTwoPlanes, kColMajor>(rd, a, stream);
}

}  // extern "C"
