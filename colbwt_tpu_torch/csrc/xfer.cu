// Chunked host-to-device upload for Hopper (sm_90a): K14.
//
// Replaces the jitted XLA program colbwt_tpu/utils/xfer.py:27 _write_rows
// (a dynamic_update_slice of one row slice into a donated device buffer,
// driven 16 MB at a time by device_put_chunked).  Its contract stays: the
// device holds the destination and nothing more (the staging is on the
// host), and a memory-mapped source is read slice by slice, never copied
// whole on the host.
//
// What bounds it on an H100: the host-to-device link, not the SMs.  The
// work is a copy, so no SM kernel runs: the copy engine moves the bytes.
// A copy from pageable memory is staged by CUDA through its own
// pinned buffer and does not overlap the host's read of the source; the
// design here stages explicitly through two pinned buffers, allocated once
// per device with cudaHostAlloc, so the host copies slice i+1 (reading the
// source, page faults of a memory map included) while the copy engine moves
// slice i, on a stream of its own.  An event per buffer guards its reuse;
// one event at the end makes the caller's stream wait for the last slice,
// so the call returns once the last slice is staged, before it has landed.
//
// Plain C interface (ctypes); allocates no device memory and returns the
// first CUDA error (cudaSuccess is 0).

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <mutex>

namespace {

constexpr int kMaxDevices = 64;

struct Staging {
  char* buf[2] = {nullptr, nullptr};
  int64_t bytes = 0;
  cudaStream_t stream = nullptr;
  cudaEvent_t free_ev[2] = {nullptr, nullptr};
  cudaEvent_t start_ev = nullptr;
  cudaEvent_t done_ev = nullptr;
};

Staging g_staging[kMaxDevices];
std::mutex g_mutex;

// The device's staging, (re)allocated when a call needs larger buffers.
cudaError_t staging_for(int device, int64_t bytes, Staging** out) {
  Staging& s = g_staging[device];
  cudaError_t err = cudaSuccess;
  if (s.stream == nullptr) {
    if ((err = cudaStreamCreateWithFlags(&s.stream, cudaStreamNonBlocking)))
      return err;
    for (int b = 0; b < 2; ++b)
      if ((err = cudaEventCreateWithFlags(&s.free_ev[b],
                                          cudaEventDisableTiming)))
        return err;
    if ((err = cudaEventCreateWithFlags(&s.start_ev, cudaEventDisableTiming)))
      return err;
    if ((err = cudaEventCreateWithFlags(&s.done_ev, cudaEventDisableTiming)))
      return err;
  }
  if (s.bytes < bytes) {
    for (int b = 0; b < 2; ++b) {
      if (s.buf[b] != nullptr) {
        if ((err = cudaEventSynchronize(s.free_ev[b]))) return err;
        if ((err = cudaFreeHost(s.buf[b]))) return err;
        s.buf[b] = nullptr;
      }
    }
    s.bytes = 0;
    for (int b = 0; b < 2; ++b)
      if ((err = cudaHostAlloc(reinterpret_cast<void**>(&s.buf[b]), bytes,
                               cudaHostAllocDefault)))
        return err;
    s.bytes = bytes;
  }
  *out = &s;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Copy `nbytes` from host memory `src` (any host memory: pageable, or a
// memory-mapped file) to device memory `dst` in slices of `chunk_bytes`.
// The copies are ordered after the work queued on `stream` so far, and
// `stream` waits for the last of them.
int colbwt_upload_rows(const void* src, void* dst, int64_t nbytes,
                       int64_t chunk_bytes, void* stream) {
  if (nbytes <= 0) return static_cast<int>(cudaSuccess);
  if (chunk_bytes <= 0) return static_cast<int>(cudaErrorInvalidValue);
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err) return static_cast<int>(err);
  if (device < 0 || device >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidDevice);
  const int64_t chunk = chunk_bytes < nbytes ? chunk_bytes : nbytes;
  std::lock_guard<std::mutex> lock(g_mutex);
  Staging* s = nullptr;
  if ((err = staging_for(device, chunk, &s))) return static_cast<int>(err);
  cudaStream_t caller = static_cast<cudaStream_t>(stream);
  // the destination may have been freed and reallocated by the caller's
  // stream: write it only after what that stream has queued
  if ((err = cudaEventRecord(s->start_ev, caller))) return static_cast<int>(err);
  if ((err = cudaStreamWaitEvent(s->stream, s->start_ev, 0)))
    return static_cast<int>(err);
  const char* from = static_cast<const char*>(src);
  char* to = static_cast<char*>(dst);
  int64_t i = 0;
  for (int64_t off = 0; off < nbytes; off += chunk, ++i) {
    const int b = static_cast<int>(i & 1);
    const int64_t len = nbytes - off < chunk ? nbytes - off : chunk;
    // the copy that last read this buffer must have finished
    if ((err = cudaEventSynchronize(s->free_ev[b]))) return static_cast<int>(err);
    memcpy(s->buf[b], from + off, static_cast<size_t>(len));
    if ((err = cudaMemcpyAsync(to + off, s->buf[b], static_cast<size_t>(len),
                               cudaMemcpyHostToDevice, s->stream)))
      return static_cast<int>(err);
    if ((err = cudaEventRecord(s->free_ev[b], s->stream)))
      return static_cast<int>(err);
  }
  if ((err = cudaEventRecord(s->done_ev, s->stream))) return static_cast<int>(err);
  if ((err = cudaStreamWaitEvent(caller, s->done_ev, 0)))
    return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
