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
// r-sized arrays (a few MB, L2-resident) and streams its output.
//
// The design: one thread per output element for K1; for K2 one block a
// (key, tile of positions), 8-byte rows (below); for K3 one thread per read
// in blocks of one warp, so that the main path's batch of 8,192 reads
// spreads over every SM, each step's outputs one vector store (below).
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

constexpr int kThreads = 256;

__device__ __forceinline__ int64_t clamp_index(int64_t i, int64_t size) {
  return i < 0 ? 0 : (i >= size ? size - 1 : i);
}

// Largest run i with idx[i] <= pos (idx strictly increasing, idx[0] = 0):
// the run that holds rank position pos.
__device__ __forceinline__ int64_t run_of(const int32_t* __restrict__ idx,
                                          int64_t r, int64_t pos) {
  int64_t lo = 0, hi = r;  // first i with idx[i] > pos lies in [lo, hi]
  while (lo < hi) {
    int64_t mid = (lo + hi) >> 1;
    if (static_cast<int64_t>(idx[mid]) <= pos) lo = mid + 1; else hi = mid;
  }
  return lo - 1;
}

// K1: T1 rows [row0, row0 + C) for positions [s, s + C) and key char c.
__global__ void build_t1_chunk_kernel(
    int32_t* __restrict__ buf, const int32_t* __restrict__ run_char,
    const int32_t* __restrict__ idx, const int32_t* __restrict__ length,
    const int32_t* __restrict__ lf_pos0, const int32_t* __restrict__ threshold,
    const int32_t* __restrict__ pred_row, const int32_t* __restrict__ succ_row,
    const int32_t* __restrict__ col_id, int64_t r, int32_t c, int64_t row0,
    int64_t s, int64_t n, int64_t C) {
  for (int64_t t = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       t < C; t += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t pos = s + t;
    const int64_t run = run_of(idx, r, pos);
    const int32_t offset = static_cast<int32_t>(pos - idx[run]);
    const int32_t lf_match = lf_pos0[run] + offset;
    const bool match = run_char[run] == c;
    const int32_t si = succ_row[run];
    const int32_t pi = pred_row[run];
    const bool has_succ = si < r;
    const bool has_pred = pi >= 0;
    const int64_t sic = si < r - 1 ? si : r - 1;
    const int64_t thr = has_succ ? static_cast<int64_t>(threshold[sic]) : n;
    const int32_t succ_pos = lf_pos0[sic];
    const int64_t pic = pi > 0 ? pi : 0;
    const int32_t pred_pos = lf_pos0[pic] + length[pic] - 1;
    // threshold_step priority (include/col_bwt.hpp:531-574): pred iff
    // pos < thr and a pred exists; else succ; else LF from the same state.
    const bool take_pred = pos < thr && has_pred;
    const bool take_succ = !take_pred && has_succ;
    const int32_t repos = take_pred ? pred_pos
                                    : (take_succ ? succ_pos : lf_match);
    const uint32_t new_pos = static_cast<uint32_t>(match ? lf_match : repos);
    const uint32_t w0 = new_pos | (static_cast<uint32_t>(match) << 31);
    const int64_t row = row0 + t;
    buf[2 * row] = static_cast<int32_t>(w0);
    buf[2 * row + 1] = col_id[run];
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

int64_t grid_for(int64_t work) {
  int64_t blocks = (work + kThreads - 1) / kThreads;
  const int64_t cap = int64_t(1) << 20;  // grid-stride loops cover the rest
  return blocks < 1 ? 1 : (blocks > cap ? cap : blocks);
}

}  // namespace

extern "C" {

int colbwt_build_t1_chunk(void* buf, const void* run_char, const void* idx,
                          const void* length, const void* lf_pos0,
                          const void* threshold, const void* pred_row,
                          const void* succ_row, const void* col_id, int64_t r,
                          int64_t c, int64_t row0, int64_t s, int64_t n,
                          int64_t C, void* stream) {
  build_t1_chunk_kernel<<<grid_for(C), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<int32_t*>(buf), static_cast<const int32_t*>(run_char),
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
