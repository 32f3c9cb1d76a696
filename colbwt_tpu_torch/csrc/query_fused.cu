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
// trip plus ff_bound - 1 length reads (r x 4 B, which the L2 holds), while
// the bytes moved (96 B a step) stay far below the memory rate.
//
// The design follows from that: one thread per read carries the state
// (interval, offset, pos, mlen) in registers and walks its read right to
// left.  Both 32-byte rows depend only on the interval, so their loads are
// issued together (two 16-byte vector loads each, through the read-only
// path); only the fast-forward's length reads wait on the run row.  A read
// stops at its length: the steps left of it leave the state alone and
// output 0 (query_fused.py:167-172), and the function returns no final
// state, so the kernel writes those zeros without stepping.
//
// Semantics kept from the JAX program, all in int32 arithmetic (wrapping,
// as XLA's int32 does): every gather index is clamped as
// jnp.take(mode="clip") clamps it (interval, c * r + interval, di after
// di + over); the CID is the current interval's, sampled before the step;
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
    int32_t n, const int32_t* __restrict__ patterns,
    const int32_t* __restrict__ lengths, int64_t B, int64_t M, int ff_bound,
    int32_t* __restrict__ pml_out, int32_t* __restrict__ cid_out) {
  const int64_t b = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (b >= B) return;
  const int32_t* pat = patterns + b * M;
  int32_t* pml = pml_out + b * M;
  int32_t* cid = cid_out + b * M;
  const int64_t len = lengths[b];
  const int64_t steps = len < 0 ? 0 : (len < M ? len : M);

  int32_t interval = r - 1;
  int32_t offset = wadd(__ldg(&run_rows[2 * static_cast<int64_t>(r - 1) + 1].y),
                        -1);  // run_rows[r - 1, 5] - 1
  int32_t pos = wadd(n, -1);
  int32_t mlen = 0;
  for (int64_t i = 0; i < steps; ++i) {
    const int64_t col = M - 1 - i;
    const int32_t c = pat[col];
    const int64_t iv = clip(interval, r);
    const int64_t jf = clip(wadd(wmul(c, r), interval), jump_count);
    // the two row loads depend only on the interval: issue them together
    const int4 ra = __ldg(&run_rows[2 * iv]);      // char, col_id, di, doff
    const int4 rb = __ldg(&run_rows[2 * iv + 1]);  // lf_pos0, length, -, -
    const int4 ja = __ldg(&jump_rows[2 * jf]);     // thr, s_int, s_off, s_pos
    const int4 jb = __ldg(&jump_rows[2 * jf + 1]); // p_int, p_off, p_pos, -

    const bool match = ra.x == c;
    const int32_t thr = ja.x;
    const bool take_pred = !match && pos < thr && jb.x >= 0;
    const bool take_succ = !match && !take_pred && thr < n;

    // match / fallback path: LF from (interval, offset), bounded ff
    int32_t di = ra.z;
    int32_t doff = wadd(ra.w, offset);
    const int32_t lf_pos = wadd(rb.x, offset);
    for (int t = 1; t < ff_bound; ++t) {
      const int32_t ln = __ldg(&length[clip(di, r)]);
      if (doff >= ln) {
        di = wadd(di, 1);
        doff = wadd(doff, -ln);
      }
    }
    const int32_t new_len = match ? wadd(mlen, 1) : 0;
    pml[col] = new_len;
    cid[col] = ra.y;
    interval = take_pred ? jb.x : (take_succ ? ja.y : di);
    offset = take_pred ? jb.y : (take_succ ? ja.z : doff);
    pos = take_pred ? jb.z : (take_succ ? ja.w : lf_pos);
    mlen = new_len;
  }
  for (int64_t col = M - 1 - steps; col >= 0; --col) {  // left padding
    pml[col] = 0;
    cid[col] = 0;
  }
}

}  // namespace

extern "C" {

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
      static_cast<int32_t>(n), static_cast<const int32_t*>(patterns),
      static_cast<const int32_t*>(lengths), B, M, static_cast<int>(ff_bound),
      static_cast<int32_t*>(pml_out), static_cast<int32_t*>(cid_out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
