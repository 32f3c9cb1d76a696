// Chunked host-to-device upload for Hopper (sm_90a): K14.
//
// Replaces the jitted XLA program colbwt_tpu/utils/xfer.py:27 _write_rows
// (a dynamic_update_slice of one row slice into a donated device buffer,
// driven 16 MB at a time by device_put_chunked).  Its contract stays: the
// device holds the destination and nothing more (the staging is on the
// host), a memory-mapped source is read slice by slice, never copied whole
// on the host, the caller's stream waits for the last DMA, and the call
// returns once the source has been read.
//
// What bounds it on an H100: the host, not the SMs.  The work is a copy, so
// no SM kernel runs: the copy engine moves the bytes, at about 47 GB/s from
// pinned memory.  A pageable source has to be copied into pinned memory on
// the host first, and one host thread's memcpy reaches a few GB/s, so the
// copy engine would idle most of the time.  The design feeds it as fast as
// the host's memory allows:
//
// - each card has a pool of host threads, started at its first upload and
//   kept for the process: min(8, the CPUs this process may run on, read with
//   sched_getaffinity, which honours a container's cpuset);
// - each thread owns two pinned staging buffers of 2 MB (so at most 8 x 2 x
//   2 MB = 32 MB of pinned memory a card), each guarded by an event; slice i
//   of the source goes to thread i mod T, which waits for its buffer's last
//   DMA, copies the slice in, queues the slice's DMA on the card's upload
//   stream and records the buffer's event right after it, so the memcpy of
//   later slices overlaps the DMA of earlier ones;
// - every thread calls cudaSetDevice for its card before any CUDA call: the
//   current device is per thread and a new thread starts on device 0;
// - a pinned source (a pinned tensor's NumPy view) needs no staging: one
//   cudaMemcpyAsync moves it, and the call waits for it, since the source
//   has been read only when the DMA has ended;
// - a lock per card, so uploads to distinct cards run side by side.
//
// The upload stream waits for what the caller's stream has queued (the
// destination may have been freed and reallocated there), and the caller's
// stream waits for the last DMA.
//
// Plain C interface (ctypes); allocates no device memory and returns the
// first CUDA error (cudaSuccess is 0).

#include <cuda_runtime.h>
#include <sched.h>
#include <stdint.h>
#include <string.h>

#include <algorithm>
#include <condition_variable>
#include <mutex>
#include <thread>
#include <vector>

namespace {

constexpr int kMaxDevices = 64;
constexpr int kMaxThreads = 8;
constexpr int64_t kSliceBytes = int64_t{2} << 20;

int pool_threads() {
  cpu_set_t set;
  int cpus = 1;
  if (sched_getaffinity(0, sizeof(set), &set) == 0) cpus = CPU_COUNT(&set);
  return std::max(1, std::min(kMaxThreads, cpus));
}

bool is_pinned(const void* p) {
  cudaPointerAttributes attr;
  if (cudaPointerGetAttributes(&attr, p) != cudaSuccess) {
    cudaGetLastError();  // older runtimes refuse pageable pointers
    return false;
  }
  return attr.type == cudaMemoryTypeHost;
}

// One upload handed to the pool: slice i goes to thread i mod workers.
struct Job {
  const char* src = nullptr;
  char* dst = nullptr;  // nullptr: stage only, no DMA
  int64_t nbytes = 0;
  int64_t slice = 0;
  int workers = 0;
};

struct Card {
  int device = 0;
  std::mutex upload;  // one upload at a time on this card
  cudaStream_t stream = nullptr;
  cudaEvent_t start_ev = nullptr;
  cudaEvent_t done_ev = nullptr;
  int threads = 0;
  std::vector<char*> buf;            // two a thread, kSliceBytes each
  std::vector<cudaEvent_t> free_ev;  // the last DMA out of each buffer
  // hand-off between the caller and the pool
  std::mutex m;
  std::condition_variable wake;
  std::condition_variable done;
  uint64_t generation = 0;
  int running = 0;
  Job job;
  cudaError_t err = cudaSuccess;
};

// never freed: the pool's threads live as long as the process
Card* g_cards[kMaxDevices];
std::mutex g_cards_mutex;

cudaError_t run_slices(Card* c, int w, const Job& job, int64_t* used) {
  const int64_t slices = (job.nbytes + job.slice - 1) / job.slice;
  for (int64_t i = w; i < slices; i += job.workers) {
    const int b = 2 * w + static_cast<int>((*used)++ & 1);
    const int64_t off = i * job.slice;
    const int64_t len = std::min(job.slice, job.nbytes - off);
    // the DMA that last read this buffer must have finished
    cudaError_t err = cudaEventSynchronize(c->free_ev[b]);
    if (err != cudaSuccess) return err;
    memcpy(c->buf[b], job.src + off, static_cast<size_t>(len));
    if (job.dst == nullptr) continue;
    err = cudaMemcpyAsync(job.dst + off, c->buf[b], static_cast<size_t>(len),
                          cudaMemcpyHostToDevice, c->stream);
    if (err != cudaSuccess) return err;
    err = cudaEventRecord(c->free_ev[b], c->stream);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

void worker_main(Card* c, int w) {
  const cudaError_t set_err = cudaSetDevice(c->device);
  uint64_t seen = 0;
  int64_t used = 0;  // slices staged, to alternate the two buffers
  for (;;) {
    Job job;
    {
      std::unique_lock<std::mutex> lk(c->m);
      c->wake.wait(lk, [&] { return c->generation != seen; });
      seen = c->generation;
      job = c->job;
    }
    cudaError_t err = set_err;
    if (err == cudaSuccess && w < job.workers)
      err = run_slices(c, w, job, &used);
    std::lock_guard<std::mutex> lk(c->m);
    if (err != cudaSuccess && c->err == cudaSuccess) c->err = err;
    if (--c->running == 0) c->done.notify_all();
  }
}

// The card's stream, events, staging and pool, made at its first upload
// (the caller's current device is `device`).
cudaError_t card_for(int device, Card** out) {
  std::lock_guard<std::mutex> lk(g_cards_mutex);
  if (g_cards[device] == nullptr) {
    Card* c = new Card();
    c->device = device;
    c->threads = pool_threads();
    c->buf.assign(2 * c->threads, nullptr);
    c->free_ev.assign(2 * c->threads, nullptr);
    cudaError_t err =
        cudaStreamCreateWithFlags(&c->stream, cudaStreamNonBlocking);
    if (!err) err = cudaEventCreateWithFlags(&c->start_ev,
                                             cudaEventDisableTiming);
    if (!err) err = cudaEventCreateWithFlags(&c->done_ev,
                                             cudaEventDisableTiming);
    for (size_t b = 0; b < c->buf.size() && !err; ++b) {
      err = cudaEventCreateWithFlags(&c->free_ev[b], cudaEventDisableTiming);
      if (!err) err = cudaHostAlloc(reinterpret_cast<void**>(&c->buf[b]),
                                    kSliceBytes, cudaHostAllocDefault);
    }
    if (err) return err;  // the half-made card is dropped, not reused
    for (int w = 0; w < c->threads; ++w)
      std::thread(worker_main, c, w).detach();
    g_cards[device] = c;
  }
  *out = g_cards[device];
  return cudaSuccess;
}

cudaError_t run_job(Card* c, const Job& job) {
  std::unique_lock<std::mutex> lk(c->m);
  c->job = job;
  c->err = cudaSuccess;
  c->running = c->threads;
  ++c->generation;
  c->wake.notify_all();
  c->done.wait(lk, [&] { return c->running == 0; });
  return c->err;
}

cudaError_t current_card(Card** out) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  return card_for(device, out);
}

Job make_job(const void* src, void* dst, int64_t nbytes, int64_t chunk_bytes,
             int threads) {
  Job job;
  job.src = static_cast<const char*>(src);
  job.dst = static_cast<char*>(dst);
  job.nbytes = nbytes;
  job.slice = std::min(chunk_bytes, kSliceBytes);
  const int64_t slices = (nbytes + job.slice - 1) / job.slice;
  job.workers = static_cast<int>(std::min<int64_t>(threads, slices));
  return job;
}

cudaError_t upload(const void* src, void* dst, int64_t nbytes,
                   int64_t chunk_bytes, cudaStream_t caller) {
  if (nbytes <= 0) return cudaSuccess;
  if (chunk_bytes <= 0) return cudaErrorInvalidValue;
  Card* c = nullptr;
  cudaError_t err = current_card(&c);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(c->upload);
  if ((err = cudaEventRecord(c->start_ev, caller))) return err;
  if ((err = cudaStreamWaitEvent(c->stream, c->start_ev, 0))) return err;
  const bool pinned = is_pinned(src);
  if (pinned) {
    err = cudaMemcpyAsync(dst, src, static_cast<size_t>(nbytes),
                          cudaMemcpyHostToDevice, c->stream);
  } else {
    err = run_job(c, make_job(src, dst, nbytes, chunk_bytes, c->threads));
  }
  if (err != cudaSuccess) return err;
  if ((err = cudaEventRecord(c->done_ev, c->stream))) return err;
  if ((err = cudaStreamWaitEvent(caller, c->done_ev, 0))) return err;
  // a pinned source has been read only once its DMA has ended
  if (pinned && (err = cudaEventSynchronize(c->done_ev))) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Copy `nbytes` from host memory `src` (pinned, pageable, or a memory-mapped
// file) to device memory `dst` on the current device, a pageable source in
// slices of at most min(`chunk_bytes`, 2 MB).  The copies are ordered after
// the work queued on `stream` so far, and `stream` waits for the last of
// them; returns once the source has been read.
int colbwt_upload_rows(const void* src, void* dst, int64_t nbytes,
                       int64_t chunk_bytes, void* stream) {
  return static_cast<int>(upload(src, dst, nbytes, chunk_bytes,
                                 static_cast<cudaStream_t>(stream)));
}

// The same pool's slice copies into the current device's pinned staging,
// with no DMA: the host memcpy rate the upload can reach at most.
int colbwt_host_stage(const void* src, int64_t nbytes, int64_t chunk_bytes) {
  if (nbytes <= 0) return static_cast<int>(cudaSuccess);
  if (chunk_bytes <= 0) return static_cast<int>(cudaErrorInvalidValue);
  Card* c = nullptr;
  cudaError_t err = current_card(&c);
  if (err != cudaSuccess) return static_cast<int>(err);
  std::lock_guard<std::mutex> lock(c->upload);
  return static_cast<int>(
      run_job(c, make_job(src, nullptr, nbytes, chunk_bytes, c->threads)));
}

// The host threads a card's upload pool holds.
int colbwt_upload_threads(void) { return pool_threads(); }

}  // extern "C"
