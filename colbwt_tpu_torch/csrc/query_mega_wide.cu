// Wide mega-table build for Hopper (sm_90a): K6b and K6c.
//
// Replaces the jitted XLA programs of colbwt_tpu/ops/query_mega_wide.py
// that build the wide engine's table on the device:
//   K6b colbwt_fill_block_wide    <- _fill_block_full (:160) and
//       _fill_block_compact (:172), both through _device_block_cols (:97)
//   K6c colbwt_shared_table_wide  <- _shared_table (:183)
//
// K6b writes char block c, one row per run, into the preallocated table at
// row c * r (or at any row0: the sharded engine fills an ip shard's slice of
// the table, parallel/query_sharded_mega_wide.py): the full layout's 16 columns, or the compact layout's 10
// per-char columns.  JAX recomputes the succ/pred jump rows on the device
// (a reverse cummin and a cummax over the char array) only so as not to ship
// them through its slow host link (query_mega_wide.py:22-31).  They are the
// index's own succ_jump[c] and pred_jump[c] rows (models/index.py:106-117,
// the same running min/max, all sentinels at c = sigma), so this kernel reads
// those rows, uploaded per block (O(r) each), instead of scanning.  The plain
// PyTorch version beside it recomputes them with cummax and a flipped cummin
// exactly as JAX does, so holding the two equal checks that shortcut.  The
// succ/pred landing states use JAX's bounded fast-forward: the position limbs
// are taken before it, then one unconditional round and ff_bound - 2 more.
//
// What bounds them on an H100: per run, a handful of gathers into r-sized
// int32 arrays (5.5 MB each at r = 1.37M, so they stay in the 50 MB L2) and
// a 64-byte (full) or 40-byte (compact) row written out: a block is about
// 88 MB of stores, so the build is bound by its writes to HBM.
//
// The simple design: one thread per run, the row assembled in registers and
// written with 16-byte (full) or 8-byte (compact) vector stores.  Every index
// is clamped as jnp.take(..., mode="clip") does, and sums are taken in int64
// (no int32 sum of the JAX program overflows: limbs are < 2**30 and offsets
// < 2**29).
//
// Plain C interface (ctypes); each entry point launches on the caller's
// stream, allocates nothing and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kLimb = int64_t(1) << 30;
constexpr int32_t kNoState = -1;

__device__ __forceinline__ int64_t clip(int64_t i, int64_t size) {
  return i < 0 ? 0 : (i >= size ? size - 1 : i);
}

struct RunArrays {
  const int32_t *run_char, *col_id, *di, *doff, *length, *idx_lo, *idx_hi,
      *thr_lo, *thr_hi;
  int64_t r;
};

// LF of run `run` at offset `lo` + `off`: position limbs, then the landing run
// and offset after the bounded fast-forward.
struct Landing {
  int32_t run, off, lo, hi;
};

__device__ __forceinline__ Landing resolve(const RunArrays& a, int64_t run0,
                                           int64_t start_off, bool ok,
                                           int ff_bound) {
  const int64_t start = ok ? run0 : 0;
  int64_t d = a.di[clip(start, a.r)];
  int64_t o = a.doff[clip(start, a.r)] + start_off;
  int64_t lo = a.idx_lo[clip(d, a.r)] + o;
  const int64_t carry = lo >= kLimb;
  lo -= carry * kLimb;
  const int64_t hi = a.idx_hi[clip(d, a.r)] + carry;
  const int rounds = ff_bound > 2 ? ff_bound - 1 : 1;  // 1 + (ff_bound - 2)
  for (int t = 0; t < rounds; ++t) {
    const int64_t ln = a.length[clip(d, a.r)];
    const bool over = o >= ln;
    d += over;
    o -= over ? ln : 0;
  }
  Landing out;
  out.run = ok ? static_cast<int32_t>(d) : kNoState;
  out.off = ok ? static_cast<int32_t>(o) : 0;
  out.lo = ok ? static_cast<int32_t>(lo) : 0;
  out.hi = ok ? static_cast<int32_t>(hi) : 0;
  return out;
}

// K6b: char block c of the full (compact == false, 16 columns) or per-char
// (compact, 10 columns) table, written at rows [row0, row0 + r) of buf:
// row0 = c * r in a whole table, another offset in an ip shard's slice.
__global__ void fill_block_kernel(int32_t* __restrict__ buf, bool compact,
                                  int32_t c, int64_t row0, const RunArrays a,
                                  const int32_t* __restrict__ succ_row,
                                  const int32_t* __restrict__ pred_row,
                                  int32_t n_lo, int32_t n_hi, int ff_bound) {
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       i < a.r; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t s_run = succ_row[i];
    const int64_t p_run = pred_row[i];
    const bool has_succ = s_run < a.r;
    const bool has_pred = p_run >= 0;
    const int64_t sr = s_run < a.r - 1 ? s_run : a.r - 1;
    const int32_t t_lo = has_succ ? a.thr_lo[clip(sr, a.r)] : n_lo;
    const int32_t t_hi = has_succ ? a.thr_hi[clip(sr, a.r)] : n_hi;
    const Landing s = resolve(a, sr, 0, has_succ, ff_bound);
    const int64_t pr = p_run > 0 ? p_run : 0;
    const Landing p =
        resolve(a, pr, int64_t(a.length[clip(pr, a.r)]) - 1, has_pred,
                ff_bound);
    const int64_t row = row0 + i;
    if (compact) {
      int2* q = reinterpret_cast<int2*>(buf + 10 * row);
      q[0] = make_int2(t_lo, t_hi);
      q[1] = make_int2(s.run, s.off);
      q[2] = make_int2(s.lo, s.hi);
      q[3] = make_int2(p.run, p.off);
      q[4] = make_int2(p.lo, p.hi);
      continue;
    }
    const int32_t match = a.run_char[i] == c;
    const int64_t d = a.di[i];
    int64_t lf_lo = a.idx_lo[clip(d, a.r)] + int64_t(a.doff[i]);
    const int64_t carry = lf_lo >= kLimb;
    lf_lo -= carry * kLimb;
    const int32_t lf_hi = a.idx_hi[clip(d, a.r)] + static_cast<int32_t>(carry);
    const int32_t dlen0 = a.length[clip(d, a.r)];
    int4* q = reinterpret_cast<int4*>(buf + 16 * row);
    q[0] = make_int4((match << 8) | a.col_id[i], a.di[i], a.doff[i],
                     static_cast<int32_t>(lf_lo));
    q[1] = make_int4(lf_hi, dlen0, t_lo, t_hi);
    q[2] = make_int4(s.run, s.off, s.lo, s.hi);
    q[3] = make_int4(p.run, p.off, p.lo, p.hi);
  }
}

// K6c: the compact layout's char-independent (r, 8) rows.
__global__ void shared_table_kernel(int32_t* __restrict__ out,
                                    const RunArrays a) {
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       i < a.r; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t d = a.di[i];
    int64_t lf_lo = a.idx_lo[clip(d, a.r)] + int64_t(a.doff[i]);
    const int64_t carry = lf_lo >= kLimb;
    lf_lo -= carry * kLimb;
    const int32_t lf_hi = a.idx_hi[clip(d, a.r)] + static_cast<int32_t>(carry);
    int4* q = reinterpret_cast<int4*>(out + 8 * i);
    q[0] = make_int4(a.run_char[i], a.col_id[i], a.di[i], a.doff[i]);
    q[1] = make_int4(static_cast<int32_t>(lf_lo), lf_hi,
                     a.length[clip(d, a.r)], 0);
  }
}

int64_t grid_for(int64_t work) {
  int64_t blocks = (work + kThreads - 1) / kThreads;
  const int64_t cap = int64_t(1) << 20;  // grid-stride loops cover the rest
  return blocks < 1 ? 1 : (blocks > cap ? cap : blocks);
}

RunArrays run_arrays(const void* run_char, const void* col_id, const void* di,
                     const void* doff, const void* length, const void* idx_lo,
                     const void* idx_hi, const void* thr_lo,
                     const void* thr_hi, int64_t r) {
  RunArrays a;
  a.run_char = static_cast<const int32_t*>(run_char);
  a.col_id = static_cast<const int32_t*>(col_id);
  a.di = static_cast<const int32_t*>(di);
  a.doff = static_cast<const int32_t*>(doff);
  a.length = static_cast<const int32_t*>(length);
  a.idx_lo = static_cast<const int32_t*>(idx_lo);
  a.idx_hi = static_cast<const int32_t*>(idx_hi);
  a.thr_lo = static_cast<const int32_t*>(thr_lo);
  a.thr_hi = static_cast<const int32_t*>(thr_hi);
  a.r = r;
  return a;
}

}  // namespace

extern "C" {

int colbwt_fill_block_wide(void* buf, int64_t compact, int64_t c,
                           int64_t row0, const void* run_char, const void* col_id,
                           const void* di, const void* doff,
                           const void* length, const void* idx_lo,
                           const void* idx_hi, const void* thr_lo,
                           const void* thr_hi, const void* succ_row,
                           const void* pred_row, int64_t r, int64_t n_lo,
                           int64_t n_hi, int64_t ff_bound, void* stream) {
  fill_block_kernel<<<grid_for(r), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<int32_t*>(buf), compact != 0, static_cast<int32_t>(c), row0,
      run_arrays(run_char, col_id, di, doff, length, idx_lo, idx_hi, thr_lo,
                 thr_hi, r),
      static_cast<const int32_t*>(succ_row),
      static_cast<const int32_t*>(pred_row), static_cast<int32_t>(n_lo),
      static_cast<int32_t>(n_hi), static_cast<int>(ff_bound));
  return static_cast<int>(cudaGetLastError());
}

int colbwt_shared_table_wide(void* out, const void* run_char,
                             const void* col_id, const void* di,
                             const void* doff, const void* length,
                             const void* idx_lo, const void* idx_hi,
                             int64_t r, void* stream) {
  shared_table_kernel<<<grid_for(r), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<int32_t*>(out),
      run_arrays(run_char, col_id, di, doff, length, idx_lo, idx_hi, nullptr,
                 nullptr, r));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
