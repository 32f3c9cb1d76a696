// Fused-gather query kernel for Hopper (sm_90a): K7.
//
// Replaces the jitted XLA program colbwt_tpu/ops/query_fused.py:108
// query_batch_fused: a lax.scan over the columns of a (B, M) right-aligned
// batch whose step gathers one 32-byte run row, one 32-byte jump row and
// ff_bound - 1 run lengths per read.
//
// What bounds it on an H100: latency, not bandwidth.  Each step's loads
// depend on the state the step before produced.  The run rows are
// r x 32 B and the jump rows (sigma + 1) x r x 32 B (263 MB at r = 1.37M,
// five times the 50 MB L2), so a step costs about one device-memory round
// trip, while the bytes moved (64 B a step) stay far below the memory rate.
// A 16-read batch waits on its chains alone (0.37-0.53 us a step); in a
// dispatch batch of 8,192 reads the scattered row loads queue in the memory
// system (1.3 us a step): the block size changes nothing (32, 64 and 128
// threads within 3%, scan_designs.py on an H100).
//
// The design follows from that.  One thread per read carries the state
// (interval, offset, pos, mlen) in registers and walks its read right to
// left.  Both 32-byte rows depend only on the interval, so their loads are
// issued together (two 16-byte vector loads each, through the read-only
// path).  The first fast-forward round needs the length of the run row's
// destination run, which ops/query_fused.py fused_rows folds into the run
// row's column 6, so at ff_bound 2 no load waits on another within a step;
// only rounds 2.. (ff_bound >= 3) read the length array.  The outputs are two column-major (M, B) planes: at each step the
// lanes of a warp store to neighbouring addresses (a row-major store puts
// 4 bytes into each of 32 sectors), and the wrapper transposes them on the
// device: a quarter faster than row-major stores at 32,768 reads, whose
// planes outgrow the L2, 6% slower at 8,192, whose row-major writes merge
// in the L2 (the transposes' cost; scan_designs.py on an H100).  The read
// ids are uint8, so a read's sector holds 32 columns.  The jump row is
// loaded beside the run row at every step: loading it only on a mismatch
// gains on 16 and 32,768 reads but loses 15% at 8,192, where a warp waits
// on its slowest lane's two dependent loads.  A read stops at its length:
// the columns left of it leave the state alone and output 0
// (query_fused.py:167-172).
//
// Semantics kept from the JAX program, all in int32 arithmetic (wrapping,
// as XLA's int32 does): every gather index is clamped as
// jnp.take(mode="clip") clamps it (interval, c * r + interval, di after
// di + over; the folded length is length[clip(di0)], the first round's
// gather); the CID is the current interval's, sampled before the step;
// a mismatch repositions to the predecessor when pos < thr (strictly) and
// one exists, else to the successor when thr < n, else LF-steps from the
// current state; lf_pos = run_rows[4] + offset is not moved by the
// fast-forward.
//
// Plain C interface (ctypes); launches on the caller's stream, allocates
// nothing and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;

__device__ __forceinline__ int64_t clip(int64_t i, int64_t size) {
  return i < 0 ? 0 : (i >= size ? size - 1 : i);
}

// int32 addition and multiplication that wrap, as XLA's do
__device__ __forceinline__ int32_t wadd(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) +
                              static_cast<uint32_t>(b));
}
__device__ __forceinline__ int32_t wmul(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) *
                              static_cast<uint32_t>(b));
}

__global__ void query_batch_fused_kernel(
    const int4* __restrict__ run_rows, const int4* __restrict__ jump_rows,
    const int32_t* __restrict__ length, int32_t r, int64_t jump_count,
    int32_t n, const uint8_t* __restrict__ patterns,
    const int32_t* __restrict__ lengths, int64_t B, int64_t M, int ff_bound,
    int32_t* __restrict__ pml_out, int32_t* __restrict__ cid_out) {
  const int64_t b = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (b >= B) return;
  const uint8_t* pat = patterns + b * M;
  const int64_t len = lengths[b];
  const int64_t steps = len < 0 ? 0 : (len < M ? len : M);

  int32_t interval = r - 1;
  int32_t offset = wadd(__ldg(&run_rows[2 * static_cast<int64_t>(r - 1) + 1].y),
                        -1);  // run_rows[r - 1, 5] - 1
  int32_t pos = wadd(n, -1);
  int32_t mlen = 0;
  // every lane walks all M columns, so a warp's lanes store the same
  // column of the (M, B) planes together
  for (int64_t i = 0; i < M; ++i) {
    const int64_t col = M - 1 - i;
    int32_t new_len = 0;
    int32_t cid = 0;
    if (i < steps) {
      const int32_t c = pat[col];
      const int64_t iv = clip(interval, r);
      const int64_t jf = clip(wadd(wmul(c, r), interval), jump_count);
      // the two row loads depend only on the interval: start them together
      // (run row: char, col_id, di, doff, lf_pos0, length, dlen0, -; jump
      // row: thr, s_int, s_off, s_pos, p_int, p_off, p_pos, -)
      const int4 ra = __ldg(&run_rows[2 * iv]);
      const int4 rb = __ldg(&run_rows[2 * iv + 1]);
      const int4 ja = __ldg(&jump_rows[2 * jf]);
      const int4 jb = __ldg(&jump_rows[2 * jf + 1]);

      const bool match = ra.x == c;
      const int32_t thr = ja.x;
      const bool take_pred = !match && pos < thr && jb.x >= 0;
      const bool take_succ = !match && !take_pred && thr < n;

      // match / fallback path: LF from (interval, offset), bounded ff; the
      // first round against the row's dlen0, the rest gathering `length`
      int32_t di = ra.z;
      int32_t doff = wadd(ra.w, offset);
      const int32_t lf_pos = wadd(rb.x, offset);
      if (ff_bound > 1 && doff >= rb.z) {
        di = wadd(di, 1);
        doff = wadd(doff, -rb.z);
      }
      for (int t = 2; t < ff_bound; ++t) {
        const int32_t ln = __ldg(&length[clip(di, r)]);
        if (doff >= ln) {
          di = wadd(di, 1);
          doff = wadd(doff, -ln);
        }
      }
      new_len = match ? wadd(mlen, 1) : 0;
      cid = ra.y;
      interval = take_pred ? jb.x : (take_succ ? ja.y : di);
      offset = take_pred ? jb.y : (take_succ ? ja.z : doff);
      pos = take_pred ? jb.z : (take_succ ? ja.w : lf_pos);
      mlen = new_len;
    }
    pml_out[col * B + b] = new_len;
    cid_out[col * B + b] = cid;
  }
}

}  // namespace

extern "C" {

// run_rows (r, 8) and jump_rows (jump_count, 8) int32, 16-byte aligned;
// length (r,); patterns (B, M) uint8 dense ids; lengths (B,); pml_out,
// cid_out (M, B) int32.
int colbwt_query_batch_fused(const void* run_rows, const void* jump_rows,
                             const void* length, int64_t r,
                             int64_t jump_count, int64_t n,
                             const void* patterns, const void* lengths,
                             int64_t B, int64_t M, int64_t ff_bound,
                             void* pml_out, void* cid_out, void* stream) {
  const int64_t blocks = (B + kThreads - 1) / kThreads;
  query_batch_fused_kernel<<<blocks < 1 ? 1 : blocks, kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(run_rows), static_cast<const int4*>(jump_rows),
      static_cast<const int32_t*>(length), static_cast<int32_t>(r), jump_count,
      static_cast<int32_t>(n), static_cast<const uint8_t*>(patterns),
      static_cast<const int32_t*>(lengths), B, M, static_cast<int>(ff_bound),
      static_cast<int32_t*>(pml_out), static_cast<int32_t*>(cid_out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
