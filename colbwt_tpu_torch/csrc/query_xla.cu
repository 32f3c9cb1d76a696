// Compact-engine query kernel for Hopper (sm_90a): K4.
//
// Replaces the jitted XLA program colbwt_tpu/ops/query_xla.py:153
// query_batch_device, with its step query_step (:89), the unbounded
// fast-forward lf_fast_forward (:63) and the jump gather _gather_jump (:84).
//
// What bounds it on an H100: latency, a chain of dependent loads a
// character.  The step of the JAX program gathers from nine r-sized
// structure-of-arrays fields, four or five levels deep (col_id, char and
// the jumps; threshold[succ] and length[pred]; dest_interval and
// dest_offset; idx and length; each further fast-forward round), and the
// next character waits on the landed interval.  At r = 1.3M runs the
// tables are about 100 MB, twice the 50 MB L2, so a level costs about one
// device-memory round trip while the bytes moved stay far below the
// memory rate.
//
// The design cuts the levels.  ops/query_xla.py's tables (models/
// tensors.py compact_rows, jump_pairs) hold a 32-byte run row a run: char,
// col_id, dest_interval, dest_offset, dest_head = idx[clip(dest_interval)]
// + dest_offset (wrapped), length, length[clip(dest_interval)] (the first
// fast-forward round's length) and threshold; and an 8-byte [succ, pred]
// pair a (character, run), at c * r + run.  A step loads the row of
// clip(interval) and the pair of (c, interval) together: both depend only
// on the state.  On a match the LF step and the first fast-forward round
// read that row alone (pos' = dest_head + offset), so a matched step that
// lands in its first round is one level.  A mismatch loads the rows of
// clip(succ) and clip(pred) together (threshold[succ], length[pred]); the
// interval it takes is one of the three rows in hand: two levels.  Rounds
// 2.. of the fast-forward (unbounded at ff_bound 0, K - 1 rounds at ff_bound
// K >= 3) read the next run's length from its row, which is also the next
// step's row when the read lands there; the next step loads it again, from
// the L1 (keeping the row in registers measured 1-4% slower on an H100:
// scan_designs.py).
//
// One thread a read, its state (interval, offset, pos, mlen) in
// registers, blocks of one warp so that a batch of 8,192 reads spreads
// over 256 blocks.  A read walks only its own steps; the columns
// left of it are the padding the plain version writes as zeros.  Outputs
// are the (B, M) row-major planes of the plain version: a lane keeps G
// consecutive columns of both planes in registers and stores them as
// 16-byte vectors (G = 8 where M % 8 == 0, 4 where M % 4 == 0, else 1);
// the groups of columns wholly left of the read are stored as zeros in one
// pass after the walk.  The characters are read the same way, G columns a
// load.
//
// Semantics kept from the JAX program, all in int32 arithmetic (wrapping,
// as XLA's int32 does): every gather index is clamped as
// jnp.take(mode="clip") clamps it (the interval, c * r + interval in 64
// bits as the plain version computes it, succ, pred, di after di + over);
// the CID is the current interval's, sampled before the step; a mismatch
// repositions to the predecessor when pos < thr (strictly) and one exists,
// else to the successor when one exists (thr = threshold[succ], else n),
// else LF-steps from the current state; pos' is not moved by the
// fast-forward.
//
// Plain C interface (ctypes); launches on the caller's stream, allocates
// nothing and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 32;

__device__ __forceinline__ int64_t clip(int64_t i, int64_t size) {
  return i < 0 ? 0 : (i >= size ? size - 1 : i);
}

// int32 addition that wraps, as XLA's does
__device__ __forceinline__ int32_t wadd(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) +
                              static_cast<uint32_t>(b));
}

// a run row: a = (char, col_id, dest_interval, dest_offset), b =
// (dest_head, length, length[clip(dest_interval)], threshold)
struct Row {
  int4 a, b;
};

__device__ __forceinline__ Row load_row(const int4* __restrict__ rows,
                                        int64_t i) {
  return {__ldg(&rows[2 * i]), __ldg(&rows[2 * i + 1])};
}

struct State {
  int32_t interval, offset, pos, mlen;
};

// one character step of a valid column (query_xla.py:89-150): the pml and
// cid it outputs
__device__ __forceinline__ void step(const int4* __restrict__ rows,
                                     const int2* __restrict__ pairs,
                                     int32_t r, int64_t pair_count,
                                     int32_t n, int ff_bound, int32_t c,
                                     State& s, int32_t& pml, int32_t& cid) {
  const int64_t iv = clip(s.interval, r);
  const int2 pair = __ldg(
      &pairs[clip(static_cast<int64_t>(c) * r + s.interval, pair_count)]);
  const Row cur = load_row(rows, iv);
  cid = cur.a.y;
  const bool match = cur.a.x == c;
  Row ch = cur;  // the row of the interval the LF step leaves from
  int32_t off = s.offset;
  if (!match) {
    const int32_t si = pair.x, pi = pair.y;
    const bool has_succ = si < r, has_pred = pi >= 0;
    Row rs, rp;
    if (has_succ) rs = load_row(rows, clip(si, r));
    if (has_pred) rp = load_row(rows, clip(pi, r));
    const int32_t thr = has_succ ? rs.b.w : n;
    const bool use_pred = s.pos < thr && has_pred;
    if (use_pred) {
      ch = rp;
      off = wadd(rp.b.y, -1);
    } else if (has_succ) {
      ch = rs;
      off = 0;
    }  // neither: keep the current state
  }
  // LF step (include/ds/LF_table.hpp:251-268) and the run fast-forward
  int32_t di = ch.a.z;
  int32_t doff = wadd(ch.a.w, off);
  const int32_t new_pos = wadd(ch.b.x, off);
  if (ff_bound != 1 && doff >= ch.b.z) {  // round 1: the folded length
    di = wadd(di, 1);
    doff = wadd(doff, -ch.b.z);
    for (int t = 2; ff_bound == 0 || t < ff_bound; ++t) {
      const int32_t ln = __ldg(&rows[2 * clip(di, r) + 1].y);  // length
      if (doff < ln) break;
      di = wadd(di, 1);
      doff = wadd(doff, -ln);
    }
  }
  pml = match ? wadd(s.mlen, 1) : 0;
  s.interval = di;
  s.offset = doff;
  s.pos = new_pos;
  s.mlen = pml;
}

// G consecutive int32 columns of a (B, M) row-major plane, as 16-byte
// vectors where G allows
template <int G>
__device__ __forceinline__ void store_cols(int32_t* __restrict__ plane,
                                           int64_t at, const int32_t* v) {
  if constexpr (G % 4 == 0) {
#pragma unroll
    for (int j = 0; j < G; j += 4) {
      *reinterpret_cast<int4*>(plane + at + j) =
          make_int4(v[j], v[j + 1], v[j + 2], v[j + 3]);
    }
  } else {
#pragma unroll
    for (int j = 0; j < G; ++j) plane[at + j] = v[j];
  }
}

template <int G>
__device__ __forceinline__ void load_cols(const int32_t* __restrict__ src,
                                          int64_t at, int32_t* v) {
  if constexpr (G % 4 == 0) {
#pragma unroll
    for (int j = 0; j < G; j += 4) {
      const int4 q = __ldg(reinterpret_cast<const int4*>(src + at + j));
      v[j] = q.x;
      v[j + 1] = q.y;
      v[j + 2] = q.z;
      v[j + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < G; ++j) v[j] = __ldg(src + at + j);
  }
}

// a group's outputs, columns [g * G, g * G + G) of read b
template <int G>
__device__ __forceinline__ void store_group(int32_t* __restrict__ pml_out,
                                            int32_t* __restrict__ cid_out,
                                            int64_t b, int64_t B, int64_t M,
                                            int64_t g, const int32_t* pb,
                                            const int32_t* cb) {
  store_cols<G>(pml_out, b * M + g * G, pb);
  store_cols<G>(cid_out, b * M + g * G, cb);
}

// G columns a group, M % G == 0
template <int G>
__global__ void query_batch_xla_kernel(
    const int4* __restrict__ rows, const int2* __restrict__ pairs,
    int32_t r, int64_t pair_count, int32_t n,
    const int32_t* __restrict__ patterns, const int32_t* __restrict__ lengths,
    int64_t B, int64_t M, int ff_bound, int32_t* __restrict__ pml_out,
    int32_t* __restrict__ cid_out) {
  const int64_t b = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (b >= B) return;
  const int64_t len = lengths[b];
  const int64_t steps = len < 0 ? 0 : (len < M ? len : M);
  const int64_t groups = M / G;
  const int64_t busy = (steps + G - 1) / G;  // groups holding a valid step

  State s;
  s.interval = r - 1;
  s.offset = wadd(__ldg(&rows[2 * static_cast<int64_t>(r - 1) + 1].y),
                  -1);  // length[r - 1] - 1
  s.pos = wadd(n, -1);
  s.mlen = 0;
  int32_t pb[G], cb[G];
  for (int64_t q = 0; q < busy; ++q) {
    const int64_t g = groups - 1 - q;  // right to left
    int32_t chars[G];
    load_cols<G>(patterns, b * M + g * G, chars);
#pragma unroll
    for (int j = G - 1; j >= 0; --j) {
      pb[j] = 0;
      cb[j] = 0;
      if (q * G + (G - 1 - j) < steps) {
        step(rows, pairs, r, pair_count, n, ff_bound, chars[j], s, pb[j],
             cb[j]);
      }
    }
    store_group<G>(pml_out, cid_out, b, B, M, g, pb, cb);
  }
  // the padding left of the read: zeros, a group at a time
#pragma unroll
  for (int j = 0; j < G; ++j) {
    pb[j] = 0;
    cb[j] = 0;
  }
  for (int64_t g = groups - 1 - busy; g >= 0; --g) {
    store_group<G>(pml_out, cid_out, b, B, M, g, pb, cb);
  }
}

}  // namespace

extern "C" {

// rows (r, 8) int32, 16-byte aligned; pairs (pair_count, 2) int32 [succ,
// pred] at c * r + run, 8-byte aligned; patterns (B, M) int32 dense ids,
// right-aligned; lengths (B,); pml_out, cid_out (B, M) int32.  The vector
// columns need M % 4 == 0 and the three (B, M) arrays 16-byte aligned.
int colbwt_query_batch_xla(const void* rows, const void* pairs, int64_t r,
                           int64_t pair_count, int64_t n,
                           const void* patterns, const void* lengths,
                           int64_t B, int64_t M, int64_t ff_bound,
                           void* pml_out, void* cid_out, void* stream) {
  const int64_t blocks = (B + kThreads - 1) / kThreads;
  const bool aligned = ((reinterpret_cast<uintptr_t>(patterns) |
                         reinterpret_cast<uintptr_t>(pml_out) |
                         reinterpret_cast<uintptr_t>(cid_out)) & 15) == 0;
  const int group = !aligned ? 1 : (M % 8 == 0 ? 8 : (M % 4 == 0 ? 4 : 1));
  const auto kernel = group == 8   ? query_batch_xla_kernel<8>
                      : group == 4 ? query_batch_xla_kernel<4>
                                   : query_batch_xla_kernel<1>;
  kernel<<<blocks < 1 ? 1 : blocks, kThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(rows), static_cast<const int2*>(pairs),
      static_cast<int32_t>(r), pair_count, static_cast<int32_t>(n),
      static_cast<const int32_t*>(patterns),
      static_cast<const int32_t*>(lengths), B, M, static_cast<int>(ff_bound),
      static_cast<int32_t*>(pml_out), static_cast<int32_t*>(cid_out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
