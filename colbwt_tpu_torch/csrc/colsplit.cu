// Col-split FL walk kernels for Hopper (sm_90a): K10a and K10b.
//
// Replace two jitted XLA programs of colbwt_tpu/ops/colsplit_jax.py, each a
// lax.scan of T lockstep FL steps over the MUMs of one bucket (with the
// step _fl_unit :49): _tunneled_walk (:59, K10a) and _all_walk (:84, K10b).
// One FL step of a rank position p: i = (number of run starts <= p) - 1,
// then p -> idx[dest_interval[i]] + dest_offset[i] + (p - idx[i]), every
// index clamped to [0, r-1] as jnp.take(mode="clip") does.
//
// K10a, tunnels mode: a move-structure walk, one thread per MUM over all
// T steps.  The walker carries u = searchsorted(idx, p, "right"), the number
// of run starts <= p, beside p, and reads one 16-byte row a step from
// `rows`, built once per col_split call (ops/colsplit.py walk_rows): for run
// j its start idx[j], the next run's start idx[j+1] (unused at j = r-1),
// dest_head = idx[clip(dest_interval[j])] + dest_offset[j] wrapped to int32,
// and clip(dest_interval[j]).  A step, from run j = max(u-1, 0):
//   alive &= (u == 0 ? q < start : start <= q && (j == r-1 || q < next)),
//     q = p + N - 1 wrapped: the walker dies once a run boundary falls
//     inside [p, p+N), i.e. searchsorted(q) != u, as JAX's i_lo == i_hi;
//   p' = dest_head + (p - start), every sum wrapped: two's-complement sums
//     are associative mod 2**32, so p' equals JAX's idx[clip(di)] + doff
//     + (p - idx[i]) bit for bit;
//   u' from run clip(dest_interval[j]) by fast-forward: while p' is at or
//     past the run's next start, the next run (the destination's row and
//     the next one are loaded together: most steps need one or the other).  The FL table is not
//     balanced, so after kMaxForward rows, and wherever p' lies before the
//     destination run's start (a p0 outside [0, n), a wrapped sum), the
//     walker takes the binary search instead: u' is searchsorted(p') for
//     every table.
// pos[t, m] = p' and valid[t, m] = alive && t % rate == 0 && t < len; a
// dead lane keeps stepping exactly as JAX's does, so the dense (T, M)
// planes equal the plain version's everywhere.  Threads m and m+1 write
// neighbouring words of row t.
//
// K10b, all mode (N <= 64): the MUM's N-high range is N unit walkers
// d = 0..N-1, one thread each, Np = next power of two >= N threads a MUM,
// 128 / Np MUMs a block.  A walker becomes a fragment head for good once
// it stands on a run head (sep); p moves only while t < len; a head's
// height is the distance to the next head above it, found through the
// walkers' head flags in shared memory.  Outputs are the dense (T, M, N)
// planes of JAX.
//
// What bounds them on an H100: latency, a chain of dependent loads a
// step.  K10b's step is a binary search of idx and then dest_interval,
// dest_offset and idx, about log2(r) + 4 loads; at bench's r = 1.3M runs
// idx is 5 MB and the three run arrays 15 MB, which the 50 MB L2 holds, so
// a step costs some tens of L2 round trips.  K10a's step is one 16-byte
// row (20 MB at bench's r), plus the rare fast-forward rows.  Both keep
// one walker per thread with its state in registers and rely on many MUMs
// in flight to hide the rest; the outputs are written once, coalesced
// along m (K10a) or d (K10b).
//
// Plain C interface (ctypes); launches on the caller's stream, allocates
// nothing and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTunnelThreads = 128;
// K10a: fast-forward rows before the binary search takes over, and whether
// a step loads the destination run's row and the one after it together
constexpr int kMaxForward = 8;
constexpr bool kWalkPair = true;
constexpr int kAllThreads = 128;

__device__ __forceinline__ int32_t clip(int32_t i, int32_t r) {
  return i < 0 ? 0 : (i >= r ? r - 1 : i);
}

// searchsorted(idx, v, side="right"): the number of run starts <= v
__device__ __forceinline__ int32_t upper_bound(const int32_t* __restrict__ idx,
                                               int32_t r, int32_t v) {
  int32_t lo = 0, hi = r;
  while (lo < hi) {
    const int32_t mid = lo + ((hi - lo) >> 1);
    if (idx[mid] <= v) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// int32 sums wrap as the plain version's do
__device__ __forceinline__ int32_t wrap_add(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) +
                              static_cast<uint32_t>(b));
}

// one FL step from p, given i = clip(upper_bound(p) - 1)
__device__ __forceinline__ int32_t fl_step(const int32_t* __restrict__ idx,
                                           const int32_t* __restrict__ di,
                                           const int32_t* __restrict__ doff,
                                           int32_t r, int32_t i, int32_t p) {
  const int32_t start = idx[i];
  return wrap_add(wrap_add(idx[clip(di[i], r)], doff[i]),
                  wrap_add(p, -start));
}

// K10a's row of run j is an int4: x its start, y the next run's start, z
// dest_head, w clip(dest_interval).
//
// u = searchsorted(idx, p, "right") and the row of run max(u-1, 0), from
// the row of a run `from` at or before p's (fast-forward), else searched
__device__ __forceinline__ int4 locate(const int32_t* __restrict__ idx,
                                       const int4* __restrict__ rows,
                                       int32_t r, int32_t from, int32_t p,
                                       int32_t& u) {
  int32_t j = from;
  int4 w = __ldg(&rows[j]);
  int4 w1 = w;
  if (kWalkPair && j < r - 1) w1 = __ldg(&rows[j + 1]);
  if (p >= w.x) {
    int f = 0;
    if (kWalkPair && j < r - 1 && p >= w.y) {
      w = w1;
      ++j;
      ++f;
    }
    for (; f < kMaxForward && j < r - 1 && p >= w.y; ++f) {
      w = __ldg(&rows[++j]);  // p >= next == rows[j + 1].start
    }
    if (j == r - 1 || p < w.y) {
      u = j + 1;
      return w;
    }
  }
  u = upper_bound(idx, r, p);
  return __ldg(&rows[u > 0 ? u - 1 : 0]);
}

__global__ void tunneled_walk_kernel(
    const int32_t* __restrict__ idx, const int4* __restrict__ rows,
    int32_t r, const int32_t* __restrict__ p0,
    const int32_t* __restrict__ lens, int64_t M, int32_t T, int32_t rate,
    int32_t N, int32_t* __restrict__ pos_out, uint8_t* __restrict__ valid_out) {
  const int64_t m = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (m >= M) return;
  int32_t p = p0[m];
  const int32_t len = lens[m];
  int32_t u = upper_bound(idx, r, p);
  int4 w = __ldg(&rows[u > 0 ? u - 1 : 0]);
  bool alive = true;
  for (int32_t t = 0; t < T; ++t) {
    const int32_t q = wrap_add(p, N - 1);
    alive = alive && (u == 0 ? q < w.x : w.x <= q && (u == r || q < w.y));
    p = wrap_add(w.z, wrap_add(p, -w.x));
    const int64_t o = t * M + m;
    pos_out[o] = p;
    valid_out[o] = alive && t % rate == 0 && t < len;
    if (t + 1 < T) w = locate(idx, rows, r, w.w, p, u);
  }
}

__global__ void all_walk_kernel(
    const int32_t* __restrict__ idx, const int32_t* __restrict__ di,
    const int32_t* __restrict__ doff, int32_t r,
    const int32_t* __restrict__ p0, const int32_t* __restrict__ lens,
    int64_t M, int32_t T, int32_t rate, int32_t N, int32_t Np,
    int32_t* __restrict__ pos_out, int32_t* __restrict__ height_out,
    uint8_t* __restrict__ valid_out) {
  __shared__ int32_t head[kAllThreads];  // d if walker d is a head, else N
  const int32_t tid = threadIdx.x;
  const int32_t base = tid / Np * Np;  // this MUM's first walker slot
  const int32_t d = tid - base;
  const int64_t m = static_cast<int64_t>(blockIdx.x) * (kAllThreads / Np) +
                    tid / Np;
  const bool in = m < M && d < N;
  int32_t p = in ? wrap_add(p0[m], d) : 0;
  const int32_t len = in ? lens[m] : 0;
  bool sep = false;
  for (int32_t t = 0; t < T; ++t) {
    const bool active = t < len;
    const int32_t i = clip(upper_bound(idx, r, p) - 1, r);
    sep = sep || (p == idx[i] && active && d > 0);
    const int32_t p_next = fl_step(idx, di, doff, r, i, p);
    if (active) p = p_next;
    const bool first = sep || d == 0;
    head[tid] = in && first ? d : N;
    __syncthreads();
    int32_t next_head = N;
    for (int32_t e = d + 1; e < N; ++e) {
      if (head[base + e] != N) {
        next_head = e;
        break;
      }
    }
    __syncthreads();
    if (in) {
      const int64_t o = (t * M + m) * N + d;
      pos_out[o] = p;
      height_out[o] = next_head - d;
      valid_out[o] = first && active && t % rate == 0;
    }
  }
}

}  // namespace

extern "C" {

// rows (r, 4) int32 as ops/colsplit.py walk_rows builds them, 16-byte
// aligned; idx (r,) its first column, for the binary searches
int colbwt_tunneled_walk(const void* idx, const void* rows, int64_t r,
                         const void* p0, const void* lens, int64_t M,
                         int64_t T, int64_t rate, int64_t N, void* pos,
                         void* valid, void* stream) {
  const int64_t blocks = (M + kTunnelThreads - 1) / kTunnelThreads;
  tunneled_walk_kernel<<<blocks, kTunnelThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(idx), static_cast<const int4*>(rows),
      static_cast<int32_t>(r), static_cast<const int32_t*>(p0),
      static_cast<const int32_t*>(lens), M, static_cast<int32_t>(T),
      static_cast<int32_t>(rate), static_cast<int32_t>(N),
      static_cast<int32_t*>(pos), static_cast<uint8_t*>(valid));
  return static_cast<int>(cudaGetLastError());
}

int colbwt_all_walk(const void* idx, const void* dest_interval,
                    const void* dest_offset, int64_t r, const void* p0,
                    const void* lens, int64_t M, int64_t T, int64_t rate,
                    int64_t N, void* pos, void* height, void* valid,
                    void* stream) {
  int32_t Np = 1;
  while (Np < N) Np *= 2;
  const int64_t per_block = kAllThreads / Np;
  const int64_t blocks = (M + per_block - 1) / per_block;
  all_walk_kernel<<<blocks, kAllThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(idx),
      static_cast<const int32_t*>(dest_interval),
      static_cast<const int32_t*>(dest_offset), static_cast<int32_t>(r),
      static_cast<const int32_t*>(p0), static_cast<const int32_t*>(lens), M,
      static_cast<int32_t>(T), static_cast<int32_t>(rate),
      static_cast<int32_t>(N), Np, static_cast<int32_t*>(pos),
      static_cast<int32_t*>(height), static_cast<uint8_t*>(valid));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
