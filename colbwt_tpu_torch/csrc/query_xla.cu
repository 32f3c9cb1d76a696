// Compact-engine query kernel for Hopper (sm_90a): K4.
//
// Replaces the jitted XLA program colbwt_tpu/ops/query_xla.py:153
// query_batch_device, with its step query_step (:89), the unbounded
// fast-forward lf_fast_forward (:63) and the jump gather _gather_jump (:84).
//
// What bounds it on an H100: per character, a chain of about eight
// dependent 4-byte gathers into r-sized structure-of-arrays (col_id, char,
// the pred/succ jump rows, threshold, dest_interval/dest_offset, idx, then
// the fast-forward's length reads).  At r = 1.3M runs the arrays total about
// 100 MB (the two (sigma+1, r) jump tables are 60 MB of it), twice the
// 50 MB L2, so the kernel is bound by the latency of that dependent chain,
// not by HBM bandwidth.
//
// The simple design: one thread per read, stepping right to left through
// that read.  The JAX program runs the fast-forward as a batch-wide
// while_loop until every lane has landed; a lane that has landed never
// moves again, so running each lane's own loop to its landing gives the
// same state for every valid lane.  Padding steps (left of a right-aligned
// read) leave the state frozen and write zeros, as query_step does.  All
// indices are clamped to their arrays, as jnp.take(..., mode="clip") does.
//
// Plain C interface (ctypes); launches on the caller's stream, allocates
// nothing and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ int64_t clip(int64_t i, int64_t size) {
  return i < 0 ? 0 : (i >= size ? size - 1 : i);
}

__global__ void query_batch_xla_kernel(
    const int32_t* __restrict__ run_char, const int32_t* __restrict__ idx,
    const int32_t* __restrict__ length,
    const int32_t* __restrict__ dest_interval,
    const int32_t* __restrict__ dest_offset,
    const int32_t* __restrict__ col_id, const int32_t* __restrict__ threshold,
    const int32_t* __restrict__ pred_jump,
    const int32_t* __restrict__ succ_jump, int64_t r, int64_t jump_size,
    int32_t n, const int32_t* __restrict__ patterns,
    const int32_t* __restrict__ lengths, int64_t B, int64_t M, int ff_bound,
    int32_t* __restrict__ pml_out, int32_t* __restrict__ cid_out) {
  const int64_t b = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (b >= B) return;
  const int64_t len = lengths[b];
  int32_t interval = static_cast<int32_t>(r - 1);
  int32_t offset = length[r - 1] - 1;
  int32_t pos = n - 1;
  int32_t mlen = 0;
  for (int64_t i = 0; i < M; ++i) {
    const int64_t o = b * M + (M - 1 - i);
    if (i >= len) {  // padding: frozen state, zero outputs
      pml_out[o] = 0;
      cid_out[o] = 0;
      continue;
    }
    const int32_t c = patterns[o];
    const int64_t iv = clip(interval, r);
    const int32_t cid = col_id[iv];
    const bool match = run_char[iv] == c;

    // threshold repositioning, selected on a mismatch
    const int64_t flat = clip(static_cast<int64_t>(c) * r + interval,
                              jump_size);
    const int32_t si = succ_jump[flat];
    const int32_t pi = pred_jump[flat];
    const bool has_succ = si < r;
    const bool has_pred = pi >= 0;
    const int32_t thr = has_succ ? threshold[clip(si, r)] : n;
    const bool use_pred = pos < thr && has_pred;
    const int32_t ti = use_pred ? pi : (has_succ ? si : interval);
    const int32_t toff = use_pred ? length[clip(pi, r)] - 1
                                  : (has_succ ? 0 : offset);
    const int32_t new_interval = match ? interval : ti;
    const int32_t new_offset = match ? offset : toff;
    const int32_t new_len = match ? mlen + 1 : 0;

    // LF step (include/ds/LF_table.hpp:251-268) and run fast-forward
    const int64_t ni = clip(new_interval, r);
    int32_t di = dest_interval[ni];
    int32_t doff = dest_offset[ni] + new_offset;
    const int32_t new_pos = idx[clip(di, r)] + doff;
    if (ff_bound > 0) {
      for (int t = 1; t < ff_bound; ++t) {
        const int32_t ln = length[clip(di, r)];
        if (doff >= ln) {
          di += 1;
          doff -= ln;
        }
      }
    } else {
      for (int32_t ln = length[clip(di, r)]; doff >= ln;
           ln = length[clip(di, r)]) {
        di += 1;
        doff -= ln;
      }
    }
    interval = di;
    offset = doff;
    pos = new_pos;
    mlen = new_len;
    pml_out[o] = new_len;
    cid_out[o] = cid;
  }
}

}  // namespace

extern "C" {

int colbwt_query_batch_xla(const void* run_char, const void* idx,
                           const void* length, const void* dest_interval,
                           const void* dest_offset, const void* col_id,
                           const void* threshold, const void* pred_jump,
                           const void* succ_jump, int64_t r, int64_t jump_size,
                           int64_t n, const void* patterns,
                           const void* lengths, int64_t B, int64_t M,
                           int64_t ff_bound, void* pml_out, void* cid_out,
                           void* stream) {
  const int64_t blocks = (B + kThreads - 1) / kThreads;
  query_batch_xla_kernel<<<blocks < 1 ? 1 : blocks, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(run_char), static_cast<const int32_t*>(idx),
      static_cast<const int32_t*>(length),
      static_cast<const int32_t*>(dest_interval),
      static_cast<const int32_t*>(dest_offset),
      static_cast<const int32_t*>(col_id),
      static_cast<const int32_t*>(threshold),
      static_cast<const int32_t*>(pred_jump),
      static_cast<const int32_t*>(succ_jump), r, jump_size,
      static_cast<int32_t>(n), static_cast<const int32_t*>(patterns),
      static_cast<const int32_t*>(lengths), B, M, static_cast<int>(ff_bound),
      static_cast<int32_t*>(pml_out), static_cast<int32_t*>(cid_out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
