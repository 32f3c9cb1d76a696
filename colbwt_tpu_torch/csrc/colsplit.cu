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
// d = 0..N-1, each the same move-structure walker as K10a's (p, u and its
// run's row in registers, `locate` for the next row), over the same rows.
// A walker becomes a fragment head for good once it stands on a run head,
// p == start of its run (sep, set only while t < len and d > 0; at u == 0
// the row is run 0's, whose start lies above p); p, u and the row move
// only while t < len.  A head's height is the distance to the next head
// above it: the MUM's walkers sit in one warp, so the heads are a mask of
// one __ballot_sync a step (two at N > 32), and the next head above d is
// the lowest set bit above bit d, else N; no shared memory and no block
// barrier in the step loop.  Up to N = 32 a warp holds floor(32 / N)
// MUMs, a lane a walker (lanes past the last whole MUM stay out of every
// mask and store nothing); from N = 33 a warp holds one MUM, a lane the
// walkers d and d + 32.  Outputs are the dense (T, M, N) planes of JAX; at
// each step a warp's lanes store neighbouring words along (m, d).
//
// What bounds them on an H100: latency, a chain of dependent loads a
// step.  A step is one 16-byte row (20 MB at bench's r = 1.3M runs, which
// the 50 MB L2 holds), plus the rare fast-forward rows; the parent K10b
// ran a binary search of idx and then three dependent loads a step, about
// log2(r) + 4 round trips.  Both kernels keep one walker a thread (K10b:
// one or two) with its state in registers and rely on many MUMs in flight
// to hide the rest; the outputs are written once, coalesced along m
// (K10a) or (m, d) (K10b).  K10b's outputs are 9 bytes a walker a step
// (150 MB on bench's first bucket), at least 0.045 ms of HBM writes.
//
// Plain C interface (ctypes); launches on the caller's stream, allocates
// nothing and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTunnelThreads = 128;
// fast-forward rows before the binary search takes over, and whether a
// step loads the destination run's row and the one after it together: so
// K10a, not K10b (10% faster without on an H100, scan_designs.py: a step
// lands past its destination run about one time in four, and K10b's N
// walkers a MUM would load the extra row N times)
constexpr int kMaxForward = 8;
constexpr bool kWalkPair = true;
constexpr bool kAllPair = false;
constexpr int kAllThreads = 128;
constexpr unsigned kFullMask = 0xffffffffu;

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

// K10a's row of run j is an int4: x its start, y the next run's start, z
// dest_head, w clip(dest_interval).
//
// u = searchsorted(idx, p, "right") and the row of run max(u-1, 0), from
// the row of a run `from` at or before p's (fast-forward, the next row
// loaded beside it when Pair), else searched
template <bool Pair>
__device__ __forceinline__ int4 locate(const int32_t* __restrict__ idx,
                                       const int4* __restrict__ rows,
                                       int32_t r, int32_t from, int32_t p,
                                       int32_t& u) {
  int32_t j = from;
  int4 w = __ldg(&rows[j]);
  int4 w1 = w;
  if (Pair && j < r - 1) w1 = __ldg(&rows[j + 1]);
  if (p >= w.x) {
    int f = 0;
    if (Pair && j < r - 1 && p >= w.y) {
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
    if (t + 1 < T) w = locate<kWalkPair>(idx, rows, r, w.w, p, u);
  }
}

// K10b's head mask of a warp's one MUM past 32 walkers: bit d set where
// walker d (lane d % 32, its walker d / 32) heads a fragment
__device__ __forceinline__ uint64_t head_mask64(bool f0, bool f1) {
  return static_cast<uint64_t>(__ballot_sync(kFullMask, f0)) |
         static_cast<uint64_t>(__ballot_sync(kFullMask, f1)) << 32;
}

// W walkers a lane: 1 up to N = 32 (floor(32 / N) MUMs a warp), 2 past it
// (one MUM a warp)
template <int W>
__global__ void all_walk_kernel(
    const int32_t* __restrict__ idx, const int4* __restrict__ rows,
    int32_t r, const int32_t* __restrict__ p0,
    const int32_t* __restrict__ lens, int64_t M, int32_t T, int32_t rate,
    int32_t N, int32_t* __restrict__ pos_out,
    int32_t* __restrict__ height_out, uint8_t* __restrict__ valid_out) {
  const int32_t lane = threadIdx.x & 31;
  const int64_t warp =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int32_t per_warp = W == 1 ? 32 / N : 1;  // MUMs a warp
  const int32_t slot = W == 1 ? lane / N : 0;    // the lane's MUM in it
  const int64_t m = warp * per_warp + slot;
  const bool mum = slot < per_warp && m < M;
  const int32_t base = slot * N;  // the MUM's first lane (W == 1)
  const uint32_t span = N >= 32 ? kFullMask : (1u << N) - 1;
  int32_t d[W], p[W], u[W];
  int4 w[W];
  bool in[W], sep[W];
  const int32_t len = mum ? lens[m] : 0;
#pragma unroll
  for (int k = 0; k < W; ++k) {
    d[k] = W == 1 ? lane - base : lane + 32 * k;
    in[k] = mum && d[k] < N;
    p[k] = in[k] ? wrap_add(p0[m], d[k]) : 0;
    u[k] = in[k] ? upper_bound(idx, r, p[k]) : 0;
    w[k] = in[k] ? __ldg(&rows[u[k] > 0 ? u[k] - 1 : 0])
                 : make_int4(0, 0, 0, 0);
    sep[k] = false;
  }
  for (int32_t t = 0; t < T; ++t) {
    const bool active = t < len;
    bool first[W];
#pragma unroll
    for (int k = 0; k < W; ++k) {
      if (in[k] && active) {
        sep[k] = sep[k] || (p[k] == w[k].x && d[k] > 0);
        p[k] = wrap_add(w[k].z, wrap_add(p[k], -w[k].x));
        if (t + 1 < T) {
          w[k] = locate<kAllPair>(idx, rows, r, w[k].w, p[k], u[k]);
        }
      }
      first[k] = in[k] && (sep[k] || d[k] == 0);
    }
    uint64_t heads;  // the MUM's head mask, bit d for walker d
    if constexpr (W == 1) {
      heads = (__ballot_sync(kFullMask, first[0]) >> base) & span;
    } else {
      heads = head_mask64(first[0], first[W - 1]);
    }
    const bool mark = active && t % rate == 0;
#pragma unroll
    for (int k = 0; k < W; ++k) {
      if (!in[k]) continue;
      // the lowest head above d, else N (2 << 63 wraps to 0: none above)
      const uint64_t above = heads & ~((uint64_t{2} << d[k]) - 1);
      const int32_t next_head = above ? __ffsll(above) - 1 : N;
      const int64_t o = (t * M + m) * N + d[k];
      pos_out[o] = p[k];
      height_out[o] = next_head - d[k];
      valid_out[o] = first[k] && mark;
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

// rows and idx as colbwt_tunneled_walk takes them; pos and height
// (T, M, N) int32, valid (T, M, N) uint8
int colbwt_all_walk(const void* idx, const void* rows, int64_t r,
                    const void* p0, const void* lens, int64_t M, int64_t T,
                    int64_t rate, int64_t N, void* pos, void* height,
                    void* valid, void* stream) {
  const int64_t per_warp = N <= 32 ? 32 / N : 1;
  const int64_t warps = (M + per_warp - 1) / per_warp;
  const int64_t blocks = (warps * 32 + kAllThreads - 1) / kAllThreads;
  const auto kernel = N <= 32 ? all_walk_kernel<1> : all_walk_kernel<2>;
  kernel<<<blocks, kAllThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(idx), static_cast<const int4*>(rows),
      static_cast<int32_t>(r), static_cast<const int32_t*>(p0),
      static_cast<const int32_t*>(lens), M, static_cast<int32_t>(T),
      static_cast<int32_t>(rate), static_cast<int32_t>(N),
      static_cast<int32_t*>(pos), static_cast<int32_t*>(height),
      static_cast<uint8_t*>(valid));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
