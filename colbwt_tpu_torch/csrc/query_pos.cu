// Positional-automaton kernels for Hopper (sm_90a): K1, K2 and K3.
//
// Replaces three jitted XLA programs of colbwt_tpu/ops/query_pos.py:
//   K1 colbwt_build_t1_chunk    <- _build_t1_chunk   (query_pos.py:93)
//   K2 colbwt_compose_tables    <- _compose_tables   (query_pos.py:153)
//   K3 colbwt_query_chunk_pos   <- query_chunk_pos   (query_pos.py:309),
//      with query_batch_pos's digit unpacking (:386, :395) and
//      _fold_keys (:298) done in registers.
//
// What bounds them on an H100: random 8-byte gathers.  A k = 4 table over
// n = 4M positions with ACGT keys is 256 * n * 8 B = 8.2 GB against a
// 50 MB L2, so every row K3 reads is a cold 32-byte sector from HBM, and
// K3's next read depends on the row just read.  K2 streams its output
// (8.2 GB for T4) and reads T_ka's key_hi block once for each key_lo
// (8.2 GB more at (2,2)); the rows it gathers for one output key all lie
// in one n-row block of T_kb (32 MB at n = 4M), and on a real index the
// positions it gathers keep the run locality of the LF mapping.  K1 reads
// r-sized arrays (a few MB at bench's r, 55 MB each at r = 13.7M) and
// streams its output.
//
// The design: for K1 one block a tile of positions (below); for K2 one
// block a (key, tile of positions), 8-byte rows (below); for K3 one thread
// per read in blocks of one warp, so that the main path's batch of 8,192
// reads spreads over every SM, each step's outputs one vector store (below).
//
// Every word is handled as uint32_t: bit 31 holds a match flag (T1) or
// the top match bit of a k = 4 row, and shifts into it must not be signed
// overflow.  Every table index key * n + pos is int64 and clamped to the
// table, as jnp.take(..., mode="clip") does.
//
// Each entry point has a plain C interface (ctypes), launches on the
// caller's stream, allocates nothing and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ int64_t clamp_index(int64_t i, int64_t size) {
  return i < 0 ? 0 : (i >= size ? size - 1 : i);
}

// K1: T1 rows [row0, row0 + C) for positions [s, s + C) and key char c.
//
// A chunk's positions are contiguous and runs are n / r positions long on
// average (3.1 on bench's index), so the run of a position is found once a
// tile, not by a binary search a position (21 dependent loads at r = 1.3M,
// out of the L2 at r = 13.7M), and a run's fields are read once, not once
// for each of its positions.  One block a tile of kT1Tile positions:
// - warps 0 and 1 find the runs of the tile's first and last positions,
//   side by side, each by a 32-way search over idx: a round's 32 lanes
//   probe 32 evenly spaced runs at once, so 5 dependent rounds at r =
//   13.7M where a binary search takes 24;
// - the tile's runs (at most kT1Tile: idx is strictly increasing) are read
//   with coalesced loads, one thread a run, and their position-free fields
//   kept in shared memory: the start, lf_pos0 - idx (LF of a position is
//   that plus the position), col_id, the threshold, the pred and succ
//   landings, and flags (match, has_pred, has_succ); a run that starts
//   inside the tile marks its first position;
// - each warp takes a contiguous segment of the tile, 32 positions at a
//   time: a position's run is the segment's first run plus the marks up to
//   it, a warp ballot and a popcount (the running max of the run-start
//   marks of the JAX code), and its row is one 8-byte store, a warp's 32
//   rows coalesced.
// Dynamic shared memory, 26 bytes a position of the tile.
constexpr int kT1Threads = 256;
constexpr int kT1Tile = 2048;
constexpr int kT1SmemBytes = kT1Tile * (6 * 4 + 2);
enum : uint8_t { kT1Match = 1, kT1Pred = 2, kT1Succ = 4 };

// The largest run i with idx[i] <= pos (idx strictly increasing, idx[0] =
// 0), the run that holds rank position pos, found by one warp (all 32
// lanes call it; every lane returns the run).
__device__ __forceinline__ int64_t warp_run_of(const int32_t* __restrict__ idx,
                                               int64_t r, int64_t pos,
                                               int lane) {
  int64_t lo = 0, hi = r;  // idx[lo] <= pos; the run lies in [lo, hi)
  while (hi - lo > 1) {
    const int64_t step = (hi - lo + 31) / 32;
    const int64_t probe = lo + lane * step;  // lane 0 probes lo itself
    const unsigned le = __ballot_sync(
        0xFFFFFFFFu,
        probe < hi && static_cast<int64_t>(__ldg(idx + probe)) <= pos);
    lo += (31 - __clz(le)) * step;
    hi = lo + step < hi ? lo + step : hi;
  }
  return lo;
}

// The last of the tile's runs [0, runs) that starts at or before pos.
__device__ __forceinline__ int tile_run(const int32_t* s_start, int runs,
                                        int64_t pos) {
  int lo = 0, hi = runs;  // s_start[0] <= pos: the answer lies in [lo, hi)
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (static_cast<int64_t>(s_start[mid]) <= pos) lo = mid; else hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(kT1Threads) build_t1_chunk_kernel(
    int2* __restrict__ buf, const int32_t* __restrict__ run_char,
    const int32_t* __restrict__ idx, const int32_t* __restrict__ length,
    const int32_t* __restrict__ lf_pos0, const int32_t* __restrict__ threshold,
    const int32_t* __restrict__ pred_row, const int32_t* __restrict__ succ_row,
    const int32_t* __restrict__ col_id, int64_t r, int32_t c, int64_t row0,
    int64_t s, int64_t n, int64_t C) {
  extern __shared__ int32_t t1_smem[];
  int32_t* s_start = t1_smem;
  uint32_t* s_base = reinterpret_cast<uint32_t*>(s_start + kT1Tile);
  int32_t* s_cid = reinterpret_cast<int32_t*>(s_base + kT1Tile);
  int32_t* s_thr = s_cid + kT1Tile;
  uint32_t* s_pred = reinterpret_cast<uint32_t*>(s_thr + kT1Tile);
  uint32_t* s_succ = s_pred + kT1Tile;
  uint8_t* s_flags = reinterpret_cast<uint8_t*>(s_succ + kT1Tile);
  uint8_t* s_begin = s_flags + kT1Tile;
  __shared__ int64_t s_ends[2];

  const int64_t t0 = static_cast<int64_t>(blockIdx.x) * kT1Tile;
  const int len = static_cast<int>(C - t0 < kT1Tile ? C - t0 : kT1Tile);
  const int64_t p0 = s + t0;  // the tile's first position
  for (int i = threadIdx.x; i < kT1Tile / 4; i += kT1Threads) {
    reinterpret_cast<uint32_t*>(s_begin)[i] = 0;
  }
  const int warp = threadIdx.x >> 5;
  if (warp < 2) {
    const int64_t run = warp_run_of(idx, r, warp == 0 ? p0 : p0 + len - 1,
                                    threadIdx.x & 31);
    if ((threadIdx.x & 31) == 0) s_ends[warp] = run;
  }
  __syncthreads();
  const int64_t first = s_ends[0];
  const int runs = static_cast<int>(s_ends[1] - first + 1);
  for (int j = threadIdx.x; j < runs; j += kT1Threads) {
    const int64_t run = first + j;
    const int32_t start = __ldg(idx + run);
    const int32_t si = __ldg(succ_row + run);
    const int32_t pi = __ldg(pred_row + run);
    const bool match = __ldg(run_char + run) == c;
    const bool has_succ = si < r, has_pred = pi >= 0;
    s_start[j] = start;
    s_base[j] = static_cast<uint32_t>(__ldg(lf_pos0 + run)) -
                static_cast<uint32_t>(start);
    s_cid[j] = __ldg(col_id + run);
    if (!match && has_succ) {
      const int64_t sic = si < r - 1 ? si : r - 1;
      s_thr[j] = __ldg(threshold + sic);
      s_succ[j] = static_cast<uint32_t>(__ldg(lf_pos0 + sic));
    }
    if (!match && has_pred) {
      const int64_t pic = pi > 0 ? pi : 0;
      s_pred[j] = static_cast<uint32_t>(__ldg(lf_pos0 + pic)) +
                  static_cast<uint32_t>(__ldg(length + pic)) - 1u;
    }
    s_flags[j] = (match ? kT1Match : 0) | (has_pred ? kT1Pred : 0) |
                 (has_succ ? kT1Succ : 0);
    if (j > 0) s_begin[start - p0] = 1;  // p0 < start <= p0 + len - 1
  }
  __syncthreads();

  constexpr int kSeg = kT1Tile / (kT1Threads / 32);  // positions a warp
  const int lane = threadIdx.x & 31;
  const int seg0 = warp * kSeg;
  if (seg0 >= len) return;
  // the run of the position before the segment (the tile's first run for
  // the first segment: no run starts at p0's offset 0)
  int carry = seg0 == 0 ? 0 : tile_run(s_start, runs, p0 + seg0 - 1);
  int2* out = buf + row0 + t0;
  for (int i0 = seg0; i0 < seg0 + kSeg && i0 < len; i0 += 32) {
    const int i = i0 + lane;
    const unsigned marks = __ballot_sync(0xFFFFFFFFu, s_begin[i] != 0);
    const int j = carry + __popc(marks & (0xFFFFFFFFu >> (31 - lane)));
    carry += __popc(marks);
    if (i >= len) continue;
    // threshold_step priority (include/col_bwt.hpp:531-574): pred iff
    // pos < thr and a pred exists (thr = n, so always, without a succ);
    // else succ; else LF from the same state
    const int64_t pos = p0 + i;
    const uint8_t f = s_flags[j];
    const uint32_t lf = s_base[j] + static_cast<uint32_t>(pos);
    uint32_t np;
    if (f & kT1Match) {
      np = lf;
    } else if (f & kT1Succ) {
      np = (f & kT1Pred) && pos < s_thr[j] ? s_pred[j] : s_succ[j];
    } else {
      np = (f & kT1Pred) ? s_pred[j] : lf;
    }
    const uint32_t w0 = np | ((f & kT1Match) ? 0x80000000u : 0u);
    out[i] = make_int2(static_cast<int32_t>(w0), s_cid[j]);
  }
}

// K2: T_{ka+kb}[key][p] from T_ka[key_hi][p] then T_kb[key_lo][pos_a].
//
// One block a (key, tile of kComposeTile positions), blocks key-major, no
// 64-bit division: the block finds its key and tile with 32-bit divisions,
// keeps 32-bit offsets inside the tile and int64 only in its base
// addresses.  A thread moves kComposeUnroll 8-byte rows a block's width
// apart (coalesced), its T_ka loads issued before its T_kb gathers.
constexpr int kComposeThreads = 256;
constexpr int kComposeUnroll = 4;
constexpr int kComposeTile = kComposeThreads * kComposeUnroll;

__global__ void __launch_bounds__(kComposeThreads) compose_tables_kernel(
    int2* __restrict__ out, const int2* __restrict__ ta,
    const int2* __restrict__ tb, int64_t tb_rows, int64_t n, uint32_t keys_b,
    uint32_t tiles, int ka, int kb) {
  const int k = ka + kb;
  const int pb = 32 - k, pba = 32 - ka, pbb = 32 - kb;
  const uint32_t maska = (1u << pba) - 1u;
  const uint32_t maskb = (1u << pbb) - 1u;
  const uint32_t mbits_a = (1u << ka) - 1u;
  const uint32_t mbits_b = (1u << kb) - 1u;
  const uint32_t cid_mask_a = ka >= 4 ? 0xFFFFFFFFu : (1u << (8 * ka)) - 1u;

  const uint32_t key = blockIdx.x / tiles;
  const uint32_t tile = blockIdx.x - key * tiles;
  const uint32_t key_hi = key / keys_b;
  const uint32_t key_lo = key - key_hi * keys_b;
  const int64_t p0 = static_cast<int64_t>(tile) * kComposeTile;
  const int32_t rows =
      static_cast<int32_t>(n - p0 < kComposeTile ? n - p0 : kComposeTile);
  out += static_cast<int64_t>(key) * n + p0;
  ta += static_cast<int64_t>(key_hi) * n + p0;
  tb += static_cast<int64_t>(key_lo) * n;
  // T_kb row key_lo * n + pos, clamped to tb_rows as jnp.take(mode="clip")
  const int64_t tb_left = tb_rows - static_cast<int64_t>(key_lo) * n;

  int2 a[kComposeUnroll], b[kComposeUnroll];
#pragma unroll
  for (int u = 0; u < kComposeUnroll; ++u) {
    const int32_t o = threadIdx.x + u * kComposeThreads;
    a[u] = o < rows ? __ldg(ta + o) : make_int2(0, 0);
  }
#pragma unroll
  for (int u = 0; u < kComposeUnroll; ++u) {
    const int32_t o = threadIdx.x + u * kComposeThreads;
    const int64_t pos = static_cast<uint32_t>(a[u].x) & maska;
    b[u] = o < rows ? __ldg(tb + (pos < tb_left ? pos : tb_left - 1))
                    : make_int2(0, 0);
  }
#pragma unroll
  for (int u = 0; u < kComposeUnroll; ++u) {
    const int32_t o = threadIdx.x + u * kComposeThreads;
    if (o >= rows) continue;
    const uint32_t a0 = static_cast<uint32_t>(a[u].x);
    const uint32_t a1 = static_cast<uint32_t>(a[u].y);
    const uint32_t b0 = static_cast<uint32_t>(b[u].x);
    const uint32_t b1 = static_cast<uint32_t>(b[u].y);
    const uint32_t ma = (a0 >> pba) & mbits_a;
    const uint32_t mb = (b0 >> pbb) & mbits_b;
    out[o] = make_int2(
        static_cast<int32_t>((b0 & maskb) | (((mb << ka) | ma) << pb)),
        static_cast<int32_t>((a1 & cid_mask_a) | (b1 << (8 * ka))));
  }
}

// K3 output planes.
enum OutMode { kTwoPlanes = 0, kPackedI32 = 1, kPackedU16 = 2 };

// K3: a thread per read, the read's digits consumed right to left, k per
// table row.  Digits are bytes (pack = 0) or pack-bit fields, digit j of a
// byte at bits j * pack.  The scan is a chain of dependent 8-byte gathers
// into a table of gigabytes, so its speed is the number of gathers in
// flight and the load/store traffic beside them:
// - blocks of one warp: the main path's 8,192 reads make 256 blocks over
//   the 132 SMs, not 32 blocks of 256;
// - a step's key does not depend on its gather: the next step's digit
//   bytes (1-3 when packed; never past the row) are loaded while the row
//   is in flight;
// - kPosStore 2: a step's k outputs are neighbours in a row of the (B, M)
//   planes, so k = 2 and 4 go out as one 4- to 16-byte store a plane, not
//   k scattered ones (k = 1 and 3 one store an output).  The sweep's other
//   designs (scan_designs.py): 0 one store an output, 1 column-major
//   (M, B) planes that the caller transposes.
// Every output is the packed word (pml << 8 | cid), uint32 arithmetic;
// the two-plane mode splits it as the plain version does (pml = packed >>
// 8, arithmetic).
constexpr int kPosThreads = 32;
constexpr int kPosStore = 2;
constexpr bool kPosKeyAhead = true;  // false: a step's key before its row

// The key of step s of a read whose digit bytes start at `rp`: columns
// c_hi = M-1-s*k down to c_hi-k+1, the first the key's high digit.  `ps`
// is log2(digits a byte).
__device__ __forceinline__ int64_t step_key(const uint8_t* __restrict__ rp,
                                            int64_t M, int64_t s, int k,
                                            int64_t A, int pack, int ps) {
  const int64_t c_hi = M - 1 - s * k;
  int64_t key = 0;
  if (pack) {
    const int64_t lo = (c_hi - (k - 1)) >> ps;
    const int bytes = static_cast<int>((c_hi >> ps) - lo) + 1;  // 1-3
    uint32_t win = __ldg(rp + lo);
    if (bytes > 1) win |= static_cast<uint32_t>(__ldg(rp + lo + 1)) << 8;
    if (bytes > 2) win |= static_cast<uint32_t>(__ldg(rp + lo + 2)) << 16;
    const uint32_t dmask = (1u << pack) - 1u;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (j < k) {
        const int bit = static_cast<int>(c_hi - j - (lo << ps)) * pack;
        key = key * A + ((win >> bit) & dmask);
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (j < k) key = key * A + __ldg(rp + c_hi - j);
    }
  }
  return key;
}

__device__ __forceinline__ void store_out(int out_mode, void* out0,
                                          int32_t* out1, int64_t o,
                                          uint32_t packed) {
  if (out_mode == kTwoPlanes) {
    static_cast<int32_t*>(out0)[o] = static_cast<int32_t>(packed) >> 8;
    out1[o] = static_cast<int32_t>(packed & 0xFFu);
  } else if (out_mode == kPackedI32) {
    static_cast<int32_t*>(out0)[o] = static_cast<int32_t>(packed);
  } else {
    static_cast<uint16_t*>(out0)[o] = static_cast<uint16_t>(packed);
  }
}

// A step's k outputs v[0..k-1] (v[j] at column c0 + k-1-j) from element o
// = row * M + c0 of the planes: k = 2 and 4 as one vector store a plane (o
// is a multiple of k: M and c0 are), k = 1 and 3 one store an output.
__device__ __forceinline__ void store_step(int out_mode, void* out0,
                                           int32_t* out1, int64_t o,
                                           const uint32_t* v, int k) {
  if (k == 4) {
    if (out_mode == kPackedU16) {
      reinterpret_cast<uint2*>(out0)[o / 4] =
          make_uint2((v[3] & 0xFFFFu) | (v[2] << 16),
                     (v[1] & 0xFFFFu) | (v[0] << 16));
    } else if (out_mode == kPackedI32) {
      reinterpret_cast<uint4*>(out0)[o / 4] =
          make_uint4(v[3], v[2], v[1], v[0]);
    } else {
      reinterpret_cast<int4*>(out0)[o / 4] = make_int4(
          static_cast<int32_t>(v[3]) >> 8, static_cast<int32_t>(v[2]) >> 8,
          static_cast<int32_t>(v[1]) >> 8, static_cast<int32_t>(v[0]) >> 8);
      reinterpret_cast<uint4*>(out1)[o / 4] =
          make_uint4(v[3] & 0xFFu, v[2] & 0xFFu, v[1] & 0xFFu, v[0] & 0xFFu);
    }
  } else if (k == 2) {
    if (out_mode == kPackedU16) {
      reinterpret_cast<uint32_t*>(out0)[o / 2] =
          (v[1] & 0xFFFFu) | (v[0] << 16);
    } else if (out_mode == kPackedI32) {
      reinterpret_cast<uint2*>(out0)[o / 2] = make_uint2(v[1], v[0]);
    } else {
      reinterpret_cast<int2*>(out0)[o / 2] =
          make_int2(static_cast<int32_t>(v[1]) >> 8,
                    static_cast<int32_t>(v[0]) >> 8);
      reinterpret_cast<uint2*>(out1)[o / 2] =
          make_uint2(v[1] & 0xFFu, v[0] & 0xFFu);
    }
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (j < k) store_out(out_mode, out0, out1, o + k - 1 - j, v[j]);
    }
  }
}

__global__ void __launch_bounds__(kPosThreads) query_chunk_pos_kernel(
    const int2* __restrict__ table, int64_t table_rows, int64_t n,
    const uint8_t* __restrict__ patterns, int64_t pat_cols,
    const int32_t* __restrict__ lengths, const int32_t* __restrict__ pos0,
    const int32_t* __restrict__ mlen0, int64_t step_offset, int64_t B,
    int64_t M, int k, int64_t A, int pack, bool masked, int out_mode,
    void* __restrict__ out0, int32_t* __restrict__ out1,
    int32_t* __restrict__ pos_out, int32_t* __restrict__ mlen_out) {
  const int64_t b = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (b >= B) return;
  const int pb = 32 - k;
  const uint32_t mask = (1u << pb) - 1u;
  const int ps = pack == 2 ? 2 : (pack == 4 ? 1 : 0);
  const int64_t S = M / k;
  const uint8_t* rp = patterns + b * pat_cols;
  const int64_t len = lengths[b];
  int64_t pos = pos0[b];
  uint32_t ml = static_cast<uint32_t>(mlen0[b]);
  int64_t key = kPosKeyAhead && S > 0 ? step_key(rp, M, 0, k, A, pack, ps)
                                      : 0;
  for (int64_t s = 0; s < S; ++s) {
    if (!kPosKeyAhead) key = step_key(rp, M, s, k, A, pack, ps);
    const int2 w = __ldg(table + clamp_index(key * n + pos, table_rows));
    if (kPosKeyAhead && s + 1 < S) {
      key = step_key(rp, M, s + 1, k, A, pack, ps);
    }
    const uint32_t w0 = static_cast<uint32_t>(w.x);
    const uint32_t w1 = static_cast<uint32_t>(w.y);
    uint32_t v[4];  // the step's outputs, digit j at column M-1-s*k-j
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (j >= k) continue;
      ml = ((w0 >> (pb + j)) & 1u) ? ml + 1u : 0u;  // match ? len + 1 : 0
      v[j] = (ml << 8) | ((w1 >> (8 * j)) & 0xFFu);
      if (masked && !(s * k + step_offset + j < len)) v[j] = 0;
      if (kPosStore != 2) {
        const int64_t col = M - 1 - (s * k + j);
        store_out(out_mode, out0, out1,
                  kPosStore == 1 ? col * B + b : b * M + col, v[j]);
      }
    }
    if (kPosStore == 2) {
      store_step(out_mode, out0, out1, b * M + M - (s + 1) * k, v, k);
    }
    pos = w0 & mask;
  }
  pos_out[b] = static_cast<int32_t>(pos);
  mlen_out[b] = static_cast<int32_t>(ml);
}

// K1's dynamic shared memory passes 48 KB, which a kernel opts into on
// each device: once a device, not once a launch.
cudaError_t t1_allow_smem() {
  constexpr int kMaxDevices = 64;
  static bool allowed[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && allowed[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(build_t1_chunk_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kT1SmemBytes);
  if (err == cudaSuccess && dev < kMaxDevices) allowed[dev] = true;
  return err;
}

}  // namespace

extern "C" {

// buf (>= row0 + C, 2) int32, 8-byte aligned; the r-sized arrays int32,
// idx strictly increasing from idx[0] = 0; 0 <= s, s + C <= n.
int colbwt_build_t1_chunk(void* buf, const void* run_char, const void* idx,
                          const void* length, const void* lf_pos0,
                          const void* threshold, const void* pred_row,
                          const void* succ_row, const void* col_id, int64_t r,
                          int64_t c, int64_t row0, int64_t s, int64_t n,
                          int64_t C, void* stream) {
  if (r < 1 || C < 1 || s < 0 || s + C > n) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t tiles = (C + kT1Tile - 1) / kT1Tile;
  const cudaError_t err = t1_allow_smem();
  if (err != cudaSuccess) return static_cast<int>(err);
  build_t1_chunk_kernel<<<static_cast<unsigned>(tiles), kT1Threads,
                          kT1SmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int2*>(buf), static_cast<const int32_t*>(run_char),
      static_cast<const int32_t*>(idx), static_cast<const int32_t*>(length),
      static_cast<const int32_t*>(lf_pos0),
      static_cast<const int32_t*>(threshold),
      static_cast<const int32_t*>(pred_row),
      static_cast<const int32_t*>(succ_row),
      static_cast<const int32_t*>(col_id), r, static_cast<int32_t>(c), row0,
      s, n, C);
  return static_cast<int>(cudaGetLastError());
}

// out (A**(ka+kb) * n, 2) int32; ta (>= A**ka * n, 2); tb
// (tb_rows >= A**kb * n, 2); all 8-byte aligned.
int colbwt_compose_tables(void* out, const void* ta, const void* tb,
                          int64_t tb_rows, int64_t n, int64_t A, int64_t ka,
                          int64_t kb, void* stream) {
  int64_t keys = 1, keys_b = 1;
  for (int64_t j = 0; j < ka + kb; ++j) keys *= A;
  for (int64_t j = 0; j < kb; ++j) keys_b *= A;
  const int64_t tiles = (n + kComposeTile - 1) / kComposeTile;
  const int64_t blocks = keys * tiles;
  if (n < 1 || tb_rows < keys_b * n || blocks > INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  compose_tables_kernel<<<static_cast<unsigned>(blocks), kComposeThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<int2*>(out), static_cast<const int2*>(ta),
      static_cast<const int2*>(tb), tb_rows, n,
      static_cast<uint32_t>(keys_b), static_cast<uint32_t>(tiles),
      static_cast<int>(ka), static_cast<int>(kb));
  return static_cast<int>(cudaGetLastError());
}

int colbwt_query_chunk_pos(const void* table, int64_t table_rows, int64_t n,
                           const void* patterns, int64_t pat_cols,
                           const void* lengths, const void* pos0,
                           const void* mlen0, int64_t step_offset, int64_t B,
                           int64_t M, int64_t k, int64_t A, int64_t pack,
                           int64_t masked, int64_t out_mode, void* out0,
                           void* out1, void* pos_out, void* mlen_out,
                           void* stream) {
  if (k < 1 || k > 4 || M % k || (pack != 0 && pack != 2 && pack != 4)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t blocks = (B + kPosThreads - 1) / kPosThreads;
  query_chunk_pos_kernel<<<blocks < 1 ? 1 : blocks, kPosThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int2*>(table), table_rows, n,
      static_cast<const uint8_t*>(patterns), pat_cols,
      static_cast<const int32_t*>(lengths),
      static_cast<const int32_t*>(pos0), static_cast<const int32_t*>(mlen0),
      step_offset, B, M, static_cast<int>(k), A, static_cast<int>(pack),
      masked != 0, static_cast<int>(out_mode), out0,
      static_cast<int32_t*>(out1), static_cast<int32_t*>(pos_out),
      static_cast<int32_t*>(mlen_out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
