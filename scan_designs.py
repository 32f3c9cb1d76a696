#!/usr/bin/env python3
"""Design sweep of the T1 build K1, the scans K3, K4, K5, K6a and K7, the
multi-MUM window K8/K9, the col-split walks K10a and K10b, the LCP lift
K11b, the thresholds' segmented argmin K12, the sharded table composition
K13d, the sharded per-step kernels K13a-K13c and K13e and the K13e chunk
scan on one CUDA card.

    python3 scan_designs.py [--parent DIR]
                            [--groups scans,lcp,tk,pos,walk,xla,step,mums,thr]
                            [--designs NAME,...]

Each group times, on the same inputs and in turns, the shipped kernels of
colbwt_tpu_torch/csrc beside variants of them.  Each variant is the
shipped source with one change, compiled into a library of its own:

- scans (query_fused.cu, query_mega.cu; bench.py's index and reads as
  chip_smoke.py's phase 3 builds them, the run-split indexes with
  ff_bound 2 and 1 and the indexes with run lengths x256 (mega) and x1024
  (mega-wide)):
  K7 (when one of its variants is built: not with --designs parent) at
  E's and F's shapes:
  - row-major: the outputs stored (B, M) row-major, not transposed;
  - threads-32, threads-128: that block size in place of 64;
  - jump-on-mismatch: the jump row loaded only when the step's
    character mismatches the run's, after the run row;
  K5 and K6a (full, compact) at the dispatch batch (8,192 x 255, u16,
  unmasked as the parent's engine scans it and masked as the shipped
  one does; K5 also two planes) and at the 16 long reads' second and
  third chunks of 2,048 (step_offset 2,048 and 4,096), and the K13b/K13c
  chunk scan at G-mega's batch (263,168 reads, ip = 2) and G-wide's
  second and third long-read chunks, the calls captured from the shipped
  routes:
  - mega-other-rows: every row reader the other way, the narrow and
    full readers a row's mismatch half on demand and the compact one its
    whole pair of rows a step;
  - mega-vector-stores: the walk's outputs stored through a lane's
    16-byte chunks too, not one at a time (the padding is in both);
  - mega-scalar-stores: the padding stored one element at a time;
  - mega-threads-64, mega-threads-128: that block size in place of 32;
  - column-major: the outputs stored (M, B) column-major and transposed
    on the device, as the mega chunk scan stores them;
- lcp (suffix.cu; K11b on the suffix array and pyramid of bench's
  collection, n = 4,000,004, and of chip_smoke.py's 16 x 4.5 Mbp
  pangenome, n = 72,000,016, both built on the card): the walk's span
  (positions a thread) and layout, blocked (each lane a run of
  consecutive positions) or groups of 4, 8 and 16 lanes side by side in
  place of the shipped warp of 32 (interleaved); the values scattered
  into SA order in place of stored in text order and gathered (the
  sweep's top levels are the inverse suffix array, so the scatter design
  never builds one in the lcp it writes);
- tk (query_sharded.cu; K13d for shard 0 of T3 at (dp, ip) = (1, 2) on
  bench's index, G-pos's shape): positions a thread, the fan's width and
  the block order (prefix-major in place of tile-major);
- pos (query_pos.cu; K1 for one chunk of the first ACGT char at bench's
  index (C = n = 4,000,004, r = 1,281,530) and at chip_smoke.py's
  pangenome index (phase 8's build, n = 72,000,016, r = 13,734,195; C =
  2**25): tiles of 1,024 or 4,096 positions in place of 2,048
  ("t1-tile-1024", "t1-tile-4096"), a position's run by a binary search
  of the tile's run starts in place of the warp's running count
  ("t1-search"), the tile's first and last runs by two threads' binary
  searches in place of two warps' 32-way searches ("t1-binary-ends");
  K3 on bench's index at the shapes the main path gives it: cell A's dispatch batch of 8,192 x 252 (k = 4, 2-bit digits,
  the u16 plane), S-A's of 32,768, the N reads' general-T1 batch of 1,024
  (k = 1) and the long reads' second chunk of 2,048 with carried state):
  64 or 128 threads a block in place of 32, one store an output or
  column-major planes in place of a step's vector store, a step's key
  read before its row in place of while the previous row is in flight;
- walk (colsplit.cu; K10a on the first bucket of bench's MUMs, 17,543 x
  238 steps, and on 16 of them, the chain floor): 32, 64 or 256 threads a
  block in place of 128, 2 or 32 fast-forward rows before the binary
  search in place of 8, and the destination's row alone in place of it
  and the next one together; the fast-forward rows a step logged first;
  K10b on bench's first all-mode bucket (the same 17,543 MUMs, N = 4), its
  first tunnels-mode bucket (chip_smoke.py's phase 3 shape), its 16
  longest MUMs (the chain floor), its starts walked with N = 48 (two
  walkers a lane) and the pangenome's first all-mode bucket (N = 16):
  64 or 256 threads a block in place of 128, the next row loaded beside
  the destination's ("allwalk-pair"), the head mask of N > 32 through
  shared memory in place of two ballots ("allwalk-shared-mask"); the
  walk group's K10a variants run at K10b's shapes too (K10b shares
  `locate` and kMaxForward);
- xla (query_xla.cu; K4 at chip_smoke.py's shapes: the main-path batch of
  8,192 x 256 on bench's index at ff_bound 0 and on its ff_bound-2 split
  at 2 and 0, the 16 long reads' last 2,048 characters (the chain floor),
  cell B's two batches): 64 or 128 threads a block in place of 32,
  column-major planes transposed on the device, one store a column, 4
  columns a store in place of 8, the pair loaded on a mismatch alone;
  then cell B's query through `col-bwt-torch query`, a process each for
  the parent's tree and the shipped one, for its device memory peak;
- step (query_sharded.cu; the per-step route of shards on other cards,
  run on one card at (dp, ip) = (1, 2) over bench's index split to
  ff_bound 2 and its x1024 wide index, with chip_smoke.py's 263,168 reads
  of <= 152 bp and 16 long reads: K13a's four rounds of one character
  step (G-round), one K13b step (G-step narrow) and one K13c step (G-step
  wide) at 263,168 lanes, and one K13c step on the long reads' 16 lanes,
  each the ninth call of its shape, as chip_smoke.py's phase 12 takes
  them): the shipped launchers made once a chunk over the port's own
  library ("shipped") against the public per-call wrapper
  ("step-wrapper"), row-major (B, M) planes and patterns in place of
  column-major (M, B) ("step-row-major") and a step's pml and cid as one
  8-byte store into an interleaved plane (K13b/K13c, "step-interleaved");
  the variants launch through `K.Launcher` over a parameter block made
  once.  K13e at G-pos's shape (bench's index, (dp, ip) = (1, 2), k = 3,
  263,168 lanes): one step ("shipped": the StepPos launcher;
  "step-wrapper"; "step-row-major"), and the whole batch's scan: the
  chunk scan as the route calls it (the kernel and the wrapper's
  transpose), the kernel alone ("shipped-kernel"), with row-major (B, M)
  outputs ("scan-pos-row-major"), and the per-step route `step_row` (51
  fetches and 51 steps, "step-route").  With --parent, the parent's own
  launchers, wrappers and routes run too (its parallel/ modules loaded
  from DIR, their launches through its library; a parent without StepPos
  steps K13e through its per-call wrapper and scans the batch with 51
  fetches and 51 steps), and each tree's G-pos, G-pos step (a tree with
  `step_row`), G-round and G-step walls are timed in turns (parent,
  shipped, shipped, parent), every run's outputs equal to the first's.
  Each time is taken twice: between
  CUDA events around the calls as the host makes them (the wrapper or
  launcher included), and on the card alone (the calls queued behind a
  sleep kernel, chip_smoke.py's `gpu_ms`).
- mums (construct.cu; bench's collection and chip_smoke.py's 16 x 4.5
  Mbp pangenome, their SA and LCP built on the card): K8 on the first
  chunk find_multi_mums_chunked gives it (C = 2**20, N = 4 at bench, as
  chip_smoke.py's phase 3 cuts it; C = 2**26, N = 16 at the pangenome)
  and on the tail chunk, and the K9 route at bench's n (the kernel on the
  padded array; the wrapper's padding copies and unpackbits timed apart):
  tiles of 1,024 or 4,096 window starts in place of 2,048
  ("mums-tile-1024", "mums-tile-4096"), 128 or 512 threads a block in
  place of 256, scalar staging loads in place of 16-byte ones
  ("mums-scalar-loads"); then config #3's collection (chip_smoke.py's
  phase 14 generator at full size, 10,000 genomes of 30,000 bp, n =
  300,010,000) for the large-N route alone: its first chunk (C = 2**26,
  N = 10,000, uint16 ids; its two kernels' device times apart, by
  torch.profiler) and the same positions at N = 1,025, the
  shipped route against the parent's two-pass kernels and against the
  span kernel's registers capped for 6 blocks an SM in place of 4
  ("mums-span-blocks-6") or not capped ("mums-span-any-blocks"), and at
  N = 1,024, 256 and 64 the tile
  route against the large-N route; then the routes' switch on
  collections of 32-256 genomes made the same way (n just past 2**26):
  the tile route (past the shipped switch, the parent's) against the
  large-N route;
- thr (suffix.cu, K12 alone; the same collections): each character's
  call (two launches) apart, the terminator's among them, and the five
  as compute_thresholds makes them: a warp's tiles of 256 or 1,024
  positions in place of 512 ("thr-tile-256", "thr-tile-1024"), 4 or 16
  warps a block in place of 8, a lane's runs reduced by 32-bit atomics in
  two passes (the minimum lcp, then its first position;
  "thr-two-pass-32") or by a 64-bit atomicMin at the end of every run
  ("thr-atomic-a-run") in place of a store for the runs inside a lane and
  two atomics for its first and last runs, and the kernel's registers
  capped for 6 blocks an SM ("thr-min-blocks-6").

With --parent DIR (a checkout of the parent commit) its sources of each
group are timed too, called as its wrappers called them (int32 ids for
K7, row-major planes); its entry points must take the shipped ones'
arguments, but for those in PARENT_SIGNATURES (K13e's per-step entry
point, which took every argument where the shipped one takes a parameter
block prepared once and the step; the parent's large-N K8 route, which
took a scratch array of distances and no size, and K12, which took no
workspace); an entry point the parent lacks (the K13e chunk scan) is not
bound there.
--designs names the designs to time and build (default: all, the
shipped kernel first and again last); the shipped kernel runs at every
shape anyway, as the reference that every design's outputs must equal,
and is itself held to its plain version (K3, K10a, K11b, K13d; the step
group holds every design to the first it times, the parent's where
given).  A time is the mean of
`reps` calls between CUDA events after one warm-up, a column-major
design's device transposes included.  Prints the card's name and power
limit first, the ptxas register counts of K1's, K3's, K4's, K8's,
K10a's, K10b's, K11b's, K12's, K13d's, the per-step kernels' and the
K13e chunk scan's shipped sources, and one JSON line of every time last
(also written to build/scan_designs/times.json); exits nonzero without
CUDA.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import os
import shutil
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
WORK = REPO / "build" / "scan_designs"
# the routes' switch: collections of this many genomes (config #3's
# generator, n just past 2**26), each route on its first chunk
SWITCH_DOCS = (32, 64, 96, 128, 192, 256)
# each group's sources, compiled together into one library a design
GROUPS = {"scans": ("query_fused.cu", "query_mega.cu"),
          "lcp": ("suffix.cu",),
          "tk": ("query_sharded.cu",),
          "pos": ("query_pos.cu",),
          "walk": ("colsplit.cu",),
          "xla": ("query_xla.cu",),
          "step": ("query_sharded.cu",),
          "mums": ("construct.cu",),
          "thr": ("suffix.cu",)}
SOURCES = tuple(f for group in GROUPS.values() for f in group)
# the shipped kernels whose ptxas counts the sweep prints
PTXAS_KERNELS = ("lcp_walk_kernel", "isa_scatter_kernel",
                 "all_walk_kernel", "query_batch_xla_kernel",
                 "compose_sharded_tk_kernel", "query_chunk_pos_kernel",
                 "tunneled_walk_kernel", "sharded_step_mega_kernel",
                 "sharded_step_compact_kernel", "build_t1_chunk_kernel",
                 "sharded_step_pos_kernel", "sharded_scan_pos_kernel",
                 "mum_tile_kernel", "mum_span_kernel",
                 "mum_summary_kernel", "argmin_tile_kernel",
                 "argmin_finish_kernel")

_FUSED_STORE = ("    pml_out[col * B + b] = new_len;\n"
                "    cid_out[col * B + b] = cid;\n")
_FUSED_JUMP = ("      const int4 ja = __ldg(&jump_rows[2 * jf]);\n"
               "      const int4 jb = __ldg(&jump_rows[2 * jf + 1]);\n"
               "\n"
               "      const bool match = ra.x == c;\n")
_FUSED_THREADS = "constexpr int kThreads = 64;\n"
_MEGA_THREADS = "constexpr int kThreads = 32;\n"
# the row readers' second halves: the narrow and wide full rows' succ/pred
# outcomes, loaded with the row's first half; the compact per-char row,
# loaded on a mismatch
_MEGA_HALF = {"narrow_tail": ("    w.d = __ldg(p + 2);\n    w.e.x = __ldg("
                              "reinterpret_cast<const int32_t*>(p + 3));\n"),
              "wide_tail": ("    w.d = __ldg(p + 2);\n"
                            "    w.e = __ldg(p + 3);\n")}
_MEGA_TAIL = ("  __device__ __forceinline__ Tail tail(const Raw& w, int32_t,\n"
              "                                       int32_t) const {{\n"
              "    return {}(w);\n"
              "  }}\n")
_MEGA_TAIL_LOAD = ("  __device__ __forceinline__ Tail tail(Raw w, int32_t c,\n"
                   "                                       int32_t interval) "
                   "const {{\n"
                   "    const int4* p = at(c, interval);\n"
                   "{}"
                   "    return {}(w);\n"
                   "  }}\n")
_MEGA_COMPACT = ("    w.b = __ldg(s + 1);\n    return w;\n",
                 "    per_char(w, c, interval);\n    return {w.d.z")
_MEGA_PUT = (
    "  __device__ __forceinline__ void put(int64_t col, uint32_t v) {\n"
    "    p[L == kColMajor ? col * r1 + r0 : r0 + col] = static_cast<T>(v);\n"
    "  }\n")
_MEGA_PAD = ("    const int64_t e = r0 + end;  "
             "// elements [r0, e) are the padding\n")
_MEGA_FINISH = (
    "    const int64_t qe = e & ~(kN - 1);\n"
    "    const int64_t qlo = (r0 + kN - 1) & ~(kN - 1);  "
    "// the first whole chunk\n"
    "    for (int64_t x = e - 1; x >= (qe > r0 ? qe : r0); --x) p[x] = 0;\n"
    "    for (int64_t q = qe - kN; q >= qlo; q -= kN) {\n"
    "      *reinterpret_cast<uint4*>(p + q) = make_uint4(0, 0, 0, 0);\n"
    "    }\n"
    "    for (int64_t x = (qlo < qe ? qlo : qe) - 1; x >= r0; --x) "
    "p[x] = 0;\n")
_LCP_SPAN = "constexpr int kLcpSpan = 32;\n"
_LCP_GROUP = "constexpr int kLcpGroup = 32;\n"
_LCP_STORE = ("      if (j == 0) plcp[p] = 0;\n",
              "    plcp[p] = static_cast<int32_t>(h);\n")
_LCP_GATHER = (
    "      lv, static_cast<int>(num_levels), top, inv, s_a, n, text_order);\n"
    "  if ((err = cudaGetLastError())) return static_cast<int>(err);\n"
    "  lcp_gather_kernel<<<ceil_div(n, 256), 256, 0, s>>>(\n"
    "      s_a, text_order, n, static_cast<int32_t*>(lcp));\n")
_TK_UNROLL = "constexpr int kTkUnroll = 2;\n"
_TK_FAN = "constexpr int kTkFan = 2;\n"
_TK_ORDER = ("  const uint32_t tile = blockIdx.x / prefixes;\n"
             "  const uint32_t prefix = blockIdx.x - tile * prefixes;\n")
_POS_THREADS = "constexpr int kPosThreads = 32;\n"
_POS_STORE = "constexpr int kPosStore = 2;\n"
_WALK_THREADS = "constexpr int kTunnelThreads = 128;\n"
_WALK_FORWARD = "constexpr int kMaxForward = 8;\n"
_ALL_THREADS = "constexpr int kAllThreads = 128;\n"
_ALL_MASK = ("  return static_cast<uint64_t>(__ballot_sync(kFullMask, f0)) |\n"
             "         static_cast<uint64_t>(__ballot_sync(kFullMask, f1)) "
             "<< 32;\n")
_XLA_THREADS = "constexpr int kThreads = 32;\n"
_XLA_STORE = ("  store_cols<G>(pml_out, b * M + g * G, pb);\n"
              "  store_cols<G>(cid_out, b * M + g * G, cb);\n")
_XLA_PAIR = ("  const int2 pair = __ldg(\n"
             "      &pairs[clip(static_cast<int64_t>(c) * r + s.interval, "
             "pair_count)]);\n")
_XLA_GROUP = ("  const int group = !aligned ? 1 : (M % 8 == 0 ? 8 : "
              "(M % 4 == 0 ? 4 : 1));\n")
_STEP_COL_MAJOR = "constexpr bool kStepColMajor = true;\n"
_STEP_INTERLEAVE = "constexpr bool kStepInterleave = false;\n"
_T1_TILE = "constexpr int kT1Tile = 2048;\n"
_T1_MARKS = (
    "    const unsigned marks = __ballot_sync(0xFFFFFFFFu, s_begin[i] != 0);\n"
    "    const int j = carry + __popc(marks & (0xFFFFFFFFu >> (31 - lane)));\n"
    "    carry += __popc(marks);\n")
_T1_WARP_RUN_OF = "__device__ __forceinline__ int64_t warp_run_of("
# one thread's binary search for a position's run (the parent's run_of)
_T1_RUN_OF = (
    "__device__ __forceinline__ int64_t run_of(const int32_t* __restrict__ "
    "idx,\n"
    "                                          int64_t r, int64_t pos) {\n"
    "  int64_t lo = 0, hi = r;\n"
    "  while (lo < hi) {\n"
    "    int64_t mid = (lo + hi) >> 1;\n"
    "    if (static_cast<int64_t>(__ldg(idx + mid)) <= pos) lo = mid + 1;\n"
    "    else hi = mid;\n"
    "  }\n"
    "  return lo - 1;\n"
    "}\n\n")
_T1_ENDS = (
    "  if (warp < 2) {\n"
    "    const int64_t run = warp_run_of(idx, r, warp == 0 ? p0 : p0 + len - 1,"
    "\n"
    "                                    threadIdx.x & 31);\n"
    "    if ((threadIdx.x & 31) == 0) s_ends[warp] = run;\n"
    "  }\n")
_SCAN_POS_STORE = "      packed[col * B + b] =\n"
_MUM_TILE = "constexpr int kMumTile = 2048;"
_MUM_THREADS = "constexpr int kMumThreads = 256;\n"
_MUM_WIDE = "  if ((reinterpret_cast<uintptr_t>(src + base) & 15) == 0) {\n"
_SPAN_BOUNDS = "__launch_bounds__(kSpanThreads, 4)\n    mum_span_kernel("
_ARG_TILE = "constexpr int kArgTile = 512;"
_ARG_WARPS = "constexpr int kArgWarps = 8;"
# K12's reduction: one shared 64-bit atomicMin of a run's packed key
_ARG_KEYS = "  unsigned long long* s_key = reinterpret_cast<unsigned long long*>(mine);\n"
_ARG_INIT = "        s_key[u] = ~0ull;\n"
_ARG_READ = "      const unsigned long long key = s_key[u];\n"
_ARG_REDUCE = (
    "      int run = -1, first = -1;\n"
    "      unsigned long long key = ~0ull, first_key = ~0ull;\n"
    "#pragma unroll\n"
    "      for (int j = 0; j < kArgPer; ++j) {\n"
    "        const int q = q0 + j;\n"
    "        if ((word >> (q & 31)) & 1) {\n"
    "          end = s_end[++u];\n"
    "        }\n"
    "        if (q < len && u >= 0 && q <= end) {\n"
    "          const unsigned long long k = arg_key(v[j], a + q);\n"
    "          if (u != run) {\n"
    "            if (run == first) {\n"
    "              first_key = key;\n"
    "            } else {\n"
    "              s_key[run] = key;\n"
    "            }\n"
    "            if (first < 0) first = u;\n"
    "            run = u;\n"
    "            key = k;\n"
    "          } else {\n"
    "            key = min(key, k);\n"
    "          }\n"
    "        }\n"
    "      }\n"
    "      if (run == first) first_key = min(first_key, key);\n"
    "      if (first >= 0) atomicMin(&s_key[first], first_key);\n"
    "      if (run != first) atomicMin(&s_key[run], key);\n")
# the first tile reduction in its place: an atomicMin at the end of every
# run, inside the loop
_ARG_ATOMIC_A_RUN = (
    "      int run = -1;\n"
    "      unsigned long long key = ~0ull;\n"
    "#pragma unroll\n"
    "      for (int j = 0; j < kArgPer; ++j) {\n"
    "        const int q = q0 + j;\n"
    "        if ((word >> (q & 31)) & 1) {\n"
    "          end = s_end[++u];\n"
    "        }\n"
    "        if (q < len && u >= 0 && q <= end) {\n"
    "          const unsigned long long k = arg_key(v[j], a + q);\n"
    "          if (u != run) {\n"
    "            if (run >= 0) atomicMin(&s_key[run], key);\n"
    "            run = u;\n"
    "            key = k;\n"
    "          } else {\n"
    "            key = min(key, k);\n"
    "          }\n"
    "        }\n"
    "      }\n"
    "      if (run >= 0) atomicMin(&s_key[run], key);\n")
# the two 32-bit passes in its place: a run's minimum lcp into s_min, then
# the first position of that minimum into s_pos
_ARG_TWO_PASS = (
    "      int run = -1;\n"
    "      const int u0 = u;\n"
    "      int best = INT32_MAX;\n"
    "#pragma unroll\n"
    "      for (int j = 0; j < kArgPer; ++j) {\n"
    "        const int q = q0 + j;\n"
    "        if ((word >> (q & 31)) & 1) {\n"
    "          end = s_end[++u];\n"
    "        }\n"
    "        if (q < len && u >= 0 && q <= end) {\n"
    "          if (u != run) {\n"
    "            if (run >= 0) atomicMin(&s_min[run], best);\n"
    "            run = u;\n"
    "            best = v[j];\n"
    "          } else {\n"
    "            best = min(best, v[j]);\n"
    "          }\n"
    "        }\n"
    "      }\n"
    "      if (run >= 0) atomicMin(&s_min[run], best);\n"
    "      __syncwarp();\n"
    "      u = u0;\n"
    "      end = u >= 0 ? s_end[u] : -1;\n"
    "      run = -1;\n"
    "      int want = 0, first = INT32_MAX;\n"
    "#pragma unroll\n"
    "      for (int j = 0; j < kArgPer; ++j) {\n"
    "        const int q = q0 + j;\n"
    "        if ((word >> (q & 31)) & 1) {\n"
    "          end = s_end[++u];\n"
    "        }\n"
    "        if (q < len && u >= 0 && q <= end) {\n"
    "          if (u != run) {\n"
    "            if (first != INT32_MAX) atomicMin(&s_pos[run], first);\n"
    "            run = u;\n"
    "            want = s_min[u];\n"
    "            first = INT32_MAX;\n"
    "          }\n"
    "          if (v[j] == want && first == INT32_MAX) first = q;\n"
    "        }\n"
    "      }\n"
    "      if (first != INT32_MAX) atomicMin(&s_pos[run], first);\n")
# variant -> [(source, shipped text, the variant's text)]
VARIANTS = {
    "row-major": [
        ("query_fused.cu", _FUSED_STORE,
         _FUSED_STORE.replace("col * B + b", "b * M + col"))],
    "column-major": [
        ("query_mega.cu", "constexpr bool kBatchColMajor = false;\n",
         "constexpr bool kBatchColMajor = true;\n")],
    "jump-on-mismatch": [
        ("query_fused.cu", _FUSED_JUMP,
         "      const bool match = ra.x == c;\n"
         "      int4 ja = make_int4(0, 0, 0, 0), jb = ja;\n"
         "      if (!match) {\n"
         "        ja = __ldg(&jump_rows[2 * jf]);\n"
         "        jb = __ldg(&jump_rows[2 * jf + 1]);\n"
         "      }\n")],
    "threads-32": [
        ("query_fused.cu", _FUSED_THREADS,
         _FUSED_THREADS.replace("64", "32"))],
    "mega-other-rows": [
        *(sub for fn, half in _MEGA_HALF.items() for sub in (
            ("query_mega.cu", half + "    return w;\n", "    return w;\n"),
            ("query_mega.cu", _MEGA_TAIL.format(fn),
             _MEGA_TAIL_LOAD.format(half, fn)))),
        ("query_mega.cu", _MEGA_COMPACT[0],
         _MEGA_COMPACT[0].replace("    return w;",
                                  "    per_char(w, c, interval);\n"
                                  "    return w;")),
        ("query_mega.cu", _MEGA_COMPACT[1],
         _MEGA_COMPACT[1].replace("    per_char(w, c, interval);\n", ""))],
    "mega-vector-stores": [
        ("query_mega.cu", _MEGA_PUT,
         "  uint64_t lo = 0, hi = 0;  // the chunk being filled\n"
         "  __device__ __forceinline__ void put(int64_t col, uint32_t v) {\n"
         "    const int64_t e = r0 + col;\n"
         "    const int64_t q = e & ~(kN - 1);\n"
         "    if (L != kRowPadVector || q < r0 || q + kN > r1) {\n"
         "      p[L == kColMajor ? col * r1 + r0 : e] = static_cast<T>(v);\n"
         "      return;\n"
         "    }\n"
         "    const int bit = static_cast<int>((e - q) * 8 * sizeof(T));\n"
         "    const uint64_t x = sizeof(T) == 2 ? (v & 0xFFFFu) : v;\n"
         "    if (bit < 64) {\n"
         "      lo |= x << bit;\n"
         "    } else {\n"
         "      hi |= x << (bit - 64);\n"
         "    }\n"
         "    if (e == q) {  // the chunk's leftmost element: it is full\n"
         "      *reinterpret_cast<uint4*>(p + q) = make_uint4(\n"
         "          static_cast<uint32_t>(lo),\n"
         "          static_cast<uint32_t>(lo >> 32),\n"
         "          static_cast<uint32_t>(hi),\n"
         "          static_cast<uint32_t>(hi >> 32));\n"
         "      lo = 0;\n"
         "      hi = 0;\n"
         "    }\n"
         "  }\n"),
        ("query_mega.cu", _MEGA_PAD,
         "    int64_t e = r0 + end;  // elements [r0, e) are the padding\n"
         "    const int64_t q0 = e & ~(kN - 1);\n"
         "    if (L == kRowPadVector && e > q0 && q0 >= r0 &&\n"
         "        q0 + kN <= r1) {\n"
         "      e = q0;  // the walk's last chunk, its padding zeros\n"
         "      *reinterpret_cast<uint4*>(p + q0) = make_uint4(\n"
         "          static_cast<uint32_t>(lo),\n"
         "          static_cast<uint32_t>(lo >> 32),\n"
         "          static_cast<uint32_t>(hi),\n"
         "          static_cast<uint32_t>(hi >> 32));\n"
         "    }\n")],
    "mega-scalar-stores": [
        ("query_mega.cu", _MEGA_FINISH,
         "    for (int64_t x = e - 1; x >= r0; --x) p[x] = 0;\n")],
    "mega-threads-64": [
        ("query_mega.cu", _MEGA_THREADS, _MEGA_THREADS.replace("32", "64"))],
    "mega-threads-128": [
        ("query_mega.cu", _MEGA_THREADS, _MEGA_THREADS.replace("32", "128"))],
    "threads-128": [
        ("query_fused.cu", _FUSED_THREADS,
         _FUSED_THREADS.replace("64", "128"))],
    "lcp-span-8": [("suffix.cu", _LCP_SPAN, _LCP_SPAN.replace("32", "8"))],
    "lcp-span-16": [("suffix.cu", _LCP_SPAN, _LCP_SPAN.replace("32", "16"))],
    "lcp-blocked": [
        ("suffix.cu", _LCP_GROUP, _LCP_GROUP.replace("32", "1"))],
    "lcp-blocked-span-8": [
        ("suffix.cu", _LCP_GROUP, _LCP_GROUP.replace("32", "1")),
        ("suffix.cu", _LCP_SPAN, _LCP_SPAN.replace("32", "8"))],
    "lcp-group-4": [
        ("suffix.cu", _LCP_GROUP, _LCP_GROUP.replace("32", "4"))],
    "lcp-group-8": [
        ("suffix.cu", _LCP_GROUP, _LCP_GROUP.replace("32", "8"))],
    "lcp-group-16": [
        ("suffix.cu", _LCP_GROUP, _LCP_GROUP.replace("32", "16"))],
    "lcp-scatter": [
        ("suffix.cu", _LCP_STORE[0], _LCP_STORE[0].replace("plcp[p]",
                                                           "plcp[0]")),
        ("suffix.cu", _LCP_STORE[1], _LCP_STORE[1].replace("plcp[p]",
                                                           "plcp[j]")),
        ("suffix.cu", _LCP_GATHER,
         "      lv, static_cast<int>(num_levels), top, inv, s_a, n,\n"
         "      static_cast<int32_t*>(lcp));\n")],
    "tk-unroll-1": [
        ("query_sharded.cu", _TK_UNROLL, _TK_UNROLL.replace("2", "1"))],
    "tk-unroll-4": [
        ("query_sharded.cu", _TK_UNROLL, _TK_UNROLL.replace("2", "4"))],
    "tk-fan-4": [("query_sharded.cu", _TK_FAN, _TK_FAN.replace("2", "4"))],
    "tk-fan-8": [("query_sharded.cu", _TK_FAN, _TK_FAN.replace("2", "8"))],
    "pos-threads-64": [
        ("query_pos.cu", _POS_THREADS, _POS_THREADS.replace("32", "64"))],
    "pos-threads-128": [
        ("query_pos.cu", _POS_THREADS, _POS_THREADS.replace("32", "128"))],
    "pos-scalar-stores": [
        ("query_pos.cu", _POS_STORE, _POS_STORE.replace("2", "0"))],
    "pos-column-major": [
        ("query_pos.cu", _POS_STORE, _POS_STORE.replace("2", "1"))],
    "pos-key-after": [
        ("query_pos.cu", "constexpr bool kPosKeyAhead = true;",
         "constexpr bool kPosKeyAhead = false;")],
    "allwalk-pair": [
        ("colsplit.cu", "constexpr bool kAllPair = false;",
         "constexpr bool kAllPair = true;")],
    "allwalk-threads-64": [
        ("colsplit.cu", _ALL_THREADS, _ALL_THREADS.replace("128", "64"))],
    "allwalk-threads-256": [
        ("colsplit.cu", _ALL_THREADS, _ALL_THREADS.replace("128", "256"))],
    "allwalk-shared-mask": [
        ("colsplit.cu", _ALL_MASK,
         "  __shared__ unsigned long long s_mask[kAllThreads / 32];\n"
         "  const int wi = threadIdx.x >> 5, lane = threadIdx.x & 31;\n"
         "  if (lane == 0) s_mask[wi] = 0;\n"
         "  __syncwarp();\n"
         "  const unsigned long long bits =\n"
         "      (f0 ? 1ull << lane : 0ull) |\n"
         "      (f1 ? 1ull << (lane + 32) : 0ull);\n"
         "  if (bits) atomicOr(&s_mask[wi], bits);\n"
         "  __syncwarp();\n"
         "  const uint64_t mask = s_mask[wi];\n"
         "  __syncwarp();\n"
         "  return mask;\n")],
    "xla-pair-on-mismatch": [
        ("query_xla.cu", _XLA_PAIR, ""),
        ("query_xla.cu", "    const int32_t si = pair.x, pi = pair.y;\n",
         _XLA_PAIR.replace("  ", "    ", 1)
         + "    const int32_t si = pair.x, pi = pair.y;\n")],
    "xla-threads-64": [
        ("query_xla.cu", _XLA_THREADS, _XLA_THREADS.replace("32", "64"))],
    "xla-threads-128": [
        ("query_xla.cu", _XLA_THREADS, _XLA_THREADS.replace("32", "128"))],
    "xla-column-major": [
        ("query_xla.cu", _XLA_STORE,
         "#pragma unroll\n"
         "  for (int j = 0; j < G; ++j) {\n"
         "    pml_out[(g * G + j) * B + b] = pb[j];\n"
         "    cid_out[(g * G + j) * B + b] = cb[j];\n"
         "  }\n")],
    "xla-scalar-stores": [
        ("query_xla.cu", _XLA_GROUP,
         "  const int group = aligned ? 1 : 1;\n")],
    "xla-group-4": [
        ("query_xla.cu", _XLA_GROUP,
         "  const int group = !aligned ? 1 : (M % 4 == 0 ? 4 : 1);\n")],
    "walk-threads-32": [
        ("colsplit.cu", _WALK_THREADS, _WALK_THREADS.replace("128", "32"))],
    "walk-threads-64": [
        ("colsplit.cu", _WALK_THREADS, _WALK_THREADS.replace("128", "64"))],
    "walk-threads-256": [
        ("colsplit.cu", _WALK_THREADS, _WALK_THREADS.replace("128", "256"))],
    "walk-forward-2": [
        ("colsplit.cu", _WALK_FORWARD, _WALK_FORWARD.replace("8", "2"))],
    "walk-forward-32": [
        ("colsplit.cu", _WALK_FORWARD, _WALK_FORWARD.replace("8", "32"))],
    "walk-no-pair": [
        ("colsplit.cu", "constexpr bool kWalkPair = true;",
         "constexpr bool kWalkPair = false;")],
    "tk-prefix-major": [
        ("query_sharded.cu", _TK_ORDER,
         "  const uint32_t prefix = blockIdx.x / tiles;\n"
         "  const uint32_t tile = blockIdx.x - prefix * tiles;\n")],
    "step-row-major": [
        ("query_sharded.cu", _STEP_COL_MAJOR,
         _STEP_COL_MAJOR.replace("true", "false"))],
    "step-interleaved": [
        ("query_sharded.cu", _STEP_INTERLEAVE,
         _STEP_INTERLEAVE.replace("false", "true"))],
    "scan-pos-row-major": [
        ("query_sharded.cu", _SCAN_POS_STORE,
         _SCAN_POS_STORE.replace("col * B + b", "b * M + col"))],
    "mums-tile-1024": [
        ("construct.cu", _MUM_TILE, _MUM_TILE.replace("2048", "1024"))],
    "mums-tile-4096": [
        ("construct.cu", _MUM_TILE, _MUM_TILE.replace("2048", "4096"))],
    "mums-threads-128": [
        ("construct.cu", _MUM_THREADS, _MUM_THREADS.replace("256", "128"))],
    "mums-threads-512": [
        ("construct.cu", _MUM_THREADS, _MUM_THREADS.replace("256", "512"))],
    "mums-scalar-loads": [
        ("construct.cu", _MUM_WIDE, "  if (false) {\n")],
    "mums-span-blocks-6": [
        ("construct.cu", _SPAN_BOUNDS,
         _SPAN_BOUNDS.replace("kSpanThreads, 4", "kSpanThreads, 6"))],
    "mums-span-any-blocks": [
        ("construct.cu", _SPAN_BOUNDS,
         _SPAN_BOUNDS.replace("kSpanThreads, 4", "kSpanThreads"))],
    "thr-two-pass-32": [
        ("suffix.cu", _ARG_KEYS,
         _ARG_KEYS + "  int32_t* s_min = reinterpret_cast<int32_t*>(mine);\n"
         "  int32_t* s_pos = s_min + kArgTile + 1;\n"),
        ("suffix.cu", _ARG_INIT,
         "        s_min[u] = INT32_MAX;\n        s_pos[u] = INT32_MAX;\n"),
        ("suffix.cu", _ARG_REDUCE, _ARG_TWO_PASS),
        ("suffix.cu", _ARG_READ,
         "      const unsigned long long key = arg_key(s_min[u], a + "
         "s_pos[u]);\n")],
    "thr-atomic-a-run": [("suffix.cu", _ARG_REDUCE, _ARG_ATOMIC_A_RUN)],
    "thr-min-blocks-6": [
        ("suffix.cu", "__global__ void __launch_bounds__(kArgThreads)\n"
         "    argmin_tile_kernel(",
         "__global__ void __launch_bounds__(kArgThreads, 6)\n"
         "    argmin_tile_kernel(")],
    "thr-tile-256": [
        ("suffix.cu", _ARG_TILE, _ARG_TILE.replace("512", "256"))],
    "thr-tile-1024": [
        ("suffix.cu", _ARG_TILE, _ARG_TILE.replace("512", "1024"))],
    "thr-warps-4": [("suffix.cu", _ARG_WARPS, _ARG_WARPS.replace("8", "4"))],
    "thr-warps-16": [
        ("suffix.cu", _ARG_WARPS, _ARG_WARPS.replace("8", "16"))],
    "t1-tile-1024": [
        ("query_pos.cu", _T1_TILE, _T1_TILE.replace("2048", "1024"))],
    "t1-tile-4096": [
        ("query_pos.cu", _T1_TILE, _T1_TILE.replace("2048", "4096"))],
    "t1-search": [
        ("query_pos.cu", _T1_MARKS,
         "    const int j = tile_run(s_start, runs, p0 + i);\n")],
    "t1-binary-ends": [
        ("query_pos.cu", _T1_WARP_RUN_OF, _T1_RUN_OF + _T1_WARP_RUN_OF),
        ("query_pos.cu", _T1_ENDS,
         "  if ((threadIdx.x & 31) == 0 && warp < 2) {\n"
         "    s_ends[warp] = run_of(idx, r, warp == 0 ? p0 : p0 + len - 1);\n"
         "  }\n")],
}
FUSED_VARIANTS = ("row-major", "jump-on-mismatch", "threads-32",
                  "threads-128")
MEGA_VARIANTS = ("mega-other-rows", "mega-vector-stores",
                 "mega-scalar-stores", "mega-threads-64", "mega-threads-128",
                 "column-major")
LCP_VARIANTS = ("lcp-span-8", "lcp-span-16", "lcp-blocked",
                "lcp-blocked-span-8", "lcp-group-4", "lcp-group-8",
                "lcp-group-16", "lcp-scatter")
TK_VARIANTS = ("tk-unroll-1", "tk-unroll-4", "tk-fan-4", "tk-fan-8",
               "tk-prefix-major")
POS_VARIANTS = ("pos-threads-64", "pos-threads-128", "pos-scalar-stores",
                "pos-column-major", "pos-key-after", "t1-tile-1024",
                "t1-tile-4096", "t1-search", "t1-binary-ends")
WALK_VARIANTS = ("walk-threads-32", "walk-threads-64", "walk-threads-256",
                 "walk-forward-2", "walk-forward-32", "walk-no-pair",
                 "allwalk-pair", "allwalk-threads-64",
                 "allwalk-threads-256", "allwalk-shared-mask")
XLA_VARIANTS = ("xla-threads-64", "xla-threads-128", "xla-column-major",
                "xla-scalar-stores", "xla-group-4", "xla-pair-on-mismatch")
STEP_VARIANTS = ("step-row-major", "step-interleaved", "scan-pos-row-major")
MUMS_VARIANTS = ("mums-tile-1024", "mums-tile-4096", "mums-threads-128",
                 "mums-threads-512", "mums-scalar-loads",
                 "mums-span-blocks-6", "mums-span-any-blocks")
THR_VARIANTS = ("thr-tile-256", "thr-tile-1024", "thr-warps-4",
                "thr-warps-16", "thr-two-pass-32", "thr-atomic-a-run",
                "thr-min-blocks-6")
# the entry points each group's libraries bind
ENTRY_POINTS = {"scans": ("colbwt_query_batch_fused",
                          "colbwt_query_chunk_mega",
                          "colbwt_query_chunk_mega_wide",
                          "colbwt_sharded_scan_mega"),
                "lcp": ("colbwt_lcp_lift",),
                "tk": ("colbwt_compose_sharded_tk",),
                "pos": ("colbwt_query_chunk_pos", "colbwt_build_t1_chunk"),
                "walk": ("colbwt_tunneled_walk", "colbwt_all_walk"),
                "xla": ("colbwt_query_batch_xla",),
                "step": ("colbwt_sharded_fetch", "colbwt_compose_sharded_tk",
                         "colbwt_sharded_step_mega",
                         "colbwt_sharded_step_compact",
                         "colbwt_sharded_step_pos", "colbwt_sharded_scan_pos"),
                "mums": ("colbwt_mum_window", "colbwt_mum_window_two_pass"),
                "thr": ("colbwt_segmented_argmin",)}
_P, _I = ctypes.c_void_p, ctypes.c_int64
# the parent's entry points whose arguments differ from the shipped ones'
PARENT_SIGNATURES = {
    # the first-port K4 (nine field arrays) and K10b (the FL arrays)
    "colbwt_query_batch_xla": [_P] * 9 + [_I] * 3 + [_P] * 2 + [_I] * 3
                              + [_P] * 2 + [_P],
    "colbwt_all_walk": [_P] * 3 + [_I] + [_P] * 2 + [_I] * 4 + [_P] * 3
                       + [_P],
    "colbwt_sharded_step_pos": [_P] * 4 + [_I] * 5 + [_P] * 3 + [_P],
    # the first-port large-N route (a scratch array of C + N distances,
    # no size) and one-warp-a-segment K12
    "colbwt_mum_window_two_pass": [_P, _P, _I, _P] + [_I] * 4 + [_P] * 3
                                  + [_P],
    "colbwt_segmented_argmin": [_P] * 3 + [_I] + [_P] + [_P]}
# the variants of each group
GROUP_VARIANTS = {"scans": tuple(dict.fromkeys(FUSED_VARIANTS
                                                + MEGA_VARIANTS)),
                  "lcp": LCP_VARIANTS, "tk": TK_VARIANTS,
                  "pos": POS_VARIANTS, "walk": WALK_VARIANTS,
                  "xla": XLA_VARIANTS,
                  "step": STEP_VARIANTS, "mums": MUMS_VARIANTS,
                  "thr": THR_VARIANTS}


def log(msg: str) -> None:
    print(msg, flush=True)


def build_libraries(parent: Path | None, groups: list[str],
                    timed: set | None = None) -> dict[str, ctypes.CDLL]:
    """Each group's shipped sources, each variant (of `timed`, when given)
    and the parent's, each compiled into a library of its own (one nvcc
    each, all side by side), named "group/design"; prints the ptxas counts
    of PTXAS_KERNELS."""
    from colbwt_tpu_torch.ops import _kernels as K

    csrc = REPO / "colbwt_tpu_torch" / "csrc"
    trees = {}
    for group in groups:
        trees[f"{group}/shipped"] = (csrc, [])
        trees.update({f"{group}/{name}": (csrc, VARIANTS[name])
                      for name in GROUP_VARIANTS[group]
                      if timed is None or name in timed})
        if parent is not None:
            trees[f"{group}/parent"] = (
                parent / "colbwt_tpu_torch" / "csrc", [])
    cmds = []
    for name, (src, subs) in trees.items():
        sources = GROUPS[name.split("/")[0]]
        out = WORK / name
        shutil.rmtree(out, ignore_errors=True)
        out.mkdir(parents=True)
        for h in src.glob("*.cuh"):
            shutil.copy(h, out / h.name)
        for f in sources:
            text = (src / f).read_text()
            for file, old, new in subs:
                if file == f:
                    if text.count(old) != 1:
                        raise RuntimeError(f"{name}: {f} no longer holds the "
                                           f"text the variant changes")
                    text = text.replace(old, new)
            (out / f).write_text(text)
        verbose = ["-Xptxas", "-v"] if name.endswith("/shipped") else []
        cmds.append([K._nvcc(), *K.NVCC_FLAGS, *verbose, "-shared", "-o",
                     str(out / "lib.so"), *(str(out / f) for f in sources)])
    errs = K._run_all(cmds)
    for err in errs:
        entry = ""
        for line in err.splitlines():
            if "Compiling entry function" in line:
                entry = next((k for k in PTXAS_KERNELS if k in line), "")
            elif entry and ("registers" in line or "stack frame" in line):
                log(f"[designs] ptxas {entry}: {line.strip()}")
    libs = {}
    for name in trees:
        lib = ctypes.CDLL(str(WORK / name / "lib.so"))
        for fn in ENTRY_POINTS[name.split("/")[0]]:
            if name.endswith("/parent") and not hasattr(lib, fn):
                continue  # a kernel the parent did not have
            getattr(lib, fn).argtypes = (
                PARENT_SIGNATURES[fn] if name.endswith("/parent")
                and fn in PARENT_SIGNATURES else K._SIGNATURES[fn])
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("scan_designs: needs a CUDA device", file=sys.stderr)
        return 1
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="a checkout of the parent commit")
    ap.add_argument("--groups", default=",".join(GROUPS),
                    help="the groups to sweep, comma-separated")
    ap.add_argument("--designs", default=None,
                    help="the designs to time, comma-separated (default: "
                         "all)")
    args = ap.parse_args()
    groups = args.groups.split(",")
    if not set(groups) <= set(GROUPS):
        ap.error(f"--groups takes {', '.join(GROUPS)}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(card)
    sys.path.insert(0, str(REPO))
    from chip_smoke import cuda_ms, finish_native_build, start_native_build
    from colbwt_tpu_torch.ops import _kernels as K

    t0 = time.perf_counter()
    native = start_native_build()
    timed = None if args.designs is None else set(args.designs.split(","))
    libs = build_libraries(args.parent, groups, timed)
    K.load()  # the port's own library, for the arrays the sweep builds
    finish_native_build(native)
    log(f"[designs] {len(libs)} libraries built in "
        f"{time.perf_counter() - t0:.1f}s: {', '.join(libs)}")
    times: dict = {}

    def compare(shape: str, designs: dict, reps: int) -> None:
        """Hold every design's outputs to the shipped kernel's, then time
        the chosen ones in turns (the shipped kernel first and last)."""
        want = designs["shipped"]()
        for name, fn in designs.items():
            for g, w in zip(fn(), want):
                if g is None:
                    continue
                if g.dtype == torch.uint16:
                    g, w = g.view(torch.int16), w.view(torch.int16)
                if not torch.equal(g, w):
                    raise RuntimeError(f"{shape}: {name} differs from the "
                                       f"shipped kernel")
        del want
        order = [d for d in list(designs) + ["shipped"]
                 if timed is None or d in timed]
        ms = {}
        for name in order:
            key = "shipped (again)" if name in ms else name
            ms[key] = cuda_ms(torch, designs[name], reps)
        times[shape] = ms
        log(f"[designs] {shape}: " + ", ".join(
            f"{k} {v:.4f} ms" for k, v in ms.items()))

    def of(group: str) -> dict:
        return {name.split("/")[1]: lib for name, lib in libs.items()
                if name.startswith(group + "/")}

    if "lcp" in groups:
        sweep_lcp(torch, of("lcp"), compare)
    if {"mums", "thr"} & set(groups):
        for label, docs in collections("mums" in groups):
            cols = collection_arrays(torch, label, docs)
            del docs
            if label == "config3":
                sweep_mums_large_n(torch, of("mums"), compare, cols)
            elif label.startswith("switch"):
                sweep_mums_switch(torch, of("mums"), compare, cols)
            elif "mums" in groups:
                sweep_mums(torch, of("mums"), compare, cols)
            if "thr" in groups and label in ("bench", "pangenome"):
                sweep_thr(torch, of("thr"), compare, cols)
            del cols
            torch.cuda.empty_cache()
    if {"scans", "tk", "pos", "walk", "xla", "step"} & set(groups):
        bench = bench_index(torch)
        if "walk" in groups:
            sweep_walk(torch, of("walk"), compare, bench)
        if "xla" in groups:
            sweep_xla(torch, of("xla"), compare, bench)
            xla_peaks(bench, args.parent, times)
        if "pos" in groups:
            sweep_pos(torch, of("pos"), compare, bench)
        if "tk" in groups:
            sweep_tk(torch, of("tk"), compare, bench)
        if "scans" in groups:
            sweep_scans(torch, of("scans"), compare, bench)
        if "step" in groups:
            sweep_step(torch, of("step"), bench, args.parent, timed, times)

    WORK.mkdir(parents=True, exist_ok=True)
    line = json.dumps({"card": card, "times": times})
    (WORK / "times.json").write_text(line + "\n")
    print(card)
    print(line, flush=True)
    return 0


def rows(torch, plane):
    """An (M, B) plane as (B, M) on the device (a uint16 plane through its
    int16 view)."""
    if plane is None:
        return None
    if plane.dtype == torch.uint16:
        return plane.view(torch.int16).t().contiguous().view(torch.uint16)
    return plane.t().contiguous()


def bench_index(torch) -> dict:
    """bench.py's documents built into an index (as chip_smoke.py's phase 3
    builds it), its table and chip_smoke.py's reads."""
    from bench import make_docs
    from chip_smoke import load_table, query_reads
    from colbwt_tpu_torch.io.fasta import FastaRecord, write_fasta
    from colbwt_tpu_torch.models.index import ColPmlIndex
    from colbwt_tpu_torch.pipeline import build_pipeline
    from colbwt_tpu_torch.utils.config import ColBwtConfig, SplitMode

    t0 = time.perf_counter()
    docs = make_docs()
    fastas = []
    for i, d in enumerate(docs):
        fastas.append(str(WORK / f"hap{i}.fa"))
        write_fasta(fastas[-1], [FastaRecord(f"hap{i}", d)])
    prefix = str(WORK / "bench")
    build_pipeline(fastas, prefix, ColBwtConfig(
        mode=SplitMode.TUNNELS, split_rate=10, min_mum=20, keep_temp=True),
        device=torch.device("cuda"))
    out = {"docs": docs, "tbl": load_table(prefix), "prefix": prefix,
           "index": ColPmlIndex.load(f"{prefix}.colpml.npz")}
    out["reads"] = query_reads(docs, np.random.default_rng(0x5A0E))
    log(f"[designs] bench's index and reads in "
        f"{time.perf_counter() - t0:.1f}s")
    return out


def sweep_lcp(torch, libs: dict, compare) -> None:
    """K11b at bench's n and the pangenome's, each against its plain
    version first."""
    from bench import make_docs
    from chip_smoke import pangenome_docs
    from colbwt_tpu_torch.ops import _kernels as K
    from colbwt_tpu_torch.ops import construct as TC
    from colbwt_tpu_torch.ops import oracle as O

    dev = torch.device("cuda")
    stream = torch.cuda.current_stream(dev).cuda_stream
    for label, docs, reps in (("bench", make_docs(), 20),
                              ("pangenome", pangenome_docs(), 5)):
        ranks = O.concat_collection(docs)[1]
        n = ranks.size
        sa, _, pyr = TC.suffix_array(ranks, with_pyramid=True, device=dev)
        r0 = torch.from_numpy(ranks.astype(np.int32)).to(dev)
        del docs, ranks
        R = len(pyr)
        if int(pyr[-1].max()) != n - 1:
            raise RuntimeError(f"{label}: the top level is no inverse")
        levels = (ctypes.c_void_p * R)(*(p.data_ptr() for p in pyr))

        plcp = torch.empty(n, dtype=torch.int32, device=dev)

        def lift(lib):
            lcp = torch.empty(n, dtype=torch.int32, device=dev)
            K.check("lcp_lift", lib.colbwt_lcp_lift(
                r0.data_ptr(), sa.data_ptr(), levels, R, n, plcp.data_ptr(),
                lcp.data_ptr(), stream))
            return (lcp,)

        got = lift(libs["shipped"])[0]
        if not torch.equal(got, TC.lcp_from_pyramid_ref(r0, sa, pyr)):
            raise RuntimeError(f"{label}: K11b differs from its plain "
                               "version")
        del got
        designs = {name: (lambda lib=lib: lift(lib))
                   for name, lib in libs.items()}
        compare(f"K11b {label} n={n} R={R}", designs, reps)
        del sa, r0, pyr, levels, plcp
        torch.cuda.empty_cache()


def collections(config3: bool):
    """bench.py's collection and chip_smoke.py's pangenome, and with
    `config3` config #3's (chip_smoke.py phase 14's at full size) and, for
    the routes' switch, collections of SWITCH_DOCS genomes made the same
    way (n just past 2**26), as (label, documents), one at a time."""
    from bench import make_docs
    from chip_smoke import CONFIG3, config3_docs, pangenome_docs

    yield "bench", make_docs()
    yield "pangenome", pangenome_docs()
    if config3:
        yield "config3", config3_docs(CONFIG3["doc_len"])[0]
        for N in SWITCH_DOCS:  # the routes' switch: n just past 2**26
            yield f"switch N={N}", config3_docs((1 << 26) // N + 1, N)[0]


def collection_arrays(torch, label: str, docs: list[bytes]) -> dict:
    """A collection's arrays as the build makes them, the suffix array and
    LCP on the card (suffix_array, lcp_from_pyramid): the window test's
    inputs (lcp, per-rank documents, run-change marks, numpy) and the
    thresholds' (the RLBWT's heads and lengths, lcp on the card)."""
    from chip_smoke import scan_inputs
    from colbwt_tpu_torch.ops import construct as TC
    from colbwt_tpu_torch.ops import oracle as O

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    text, ranks, doc_ids = O.concat_collection(docs)
    sa_t, _, pyr = TC.suffix_array(ranks, with_pyramid=True, device=dev)
    lcp_t = TC.lcp_from_pyramid(ranks, sa_t, pyr)
    del pyr
    sa = sa_t.cpu().numpy()
    del sa_t
    lcp, sa_docs, rc = scan_inputs((ranks, sa, lcp_t.cpu().numpy(),
                                    doc_ids))
    heads, lens = O.rle(O.bwt_from_sa(text, sa))
    log(f"[designs] {label}'s arrays (n = {sa.size:,}, {len(docs)} "
        f"documents, r = {heads.size:,}) in {time.perf_counter() - t0:.1f}s")
    return {"label": label, "N": len(docs), "lcp": lcp, "sa_docs": sa_docs,
            "rc": rc, "lcp_t": lcp_t, "heads": heads, "lens": lens}


def sweep_mums(torch, libs: dict, compare, cols: dict) -> None:
    """K8 on the first chunk find_multi_mums_chunked gives it (bench: C =
    2**20, N = 4; the pangenome: C = 2**26, N = 16) and on the pangenome's
    tail chunk, and the K9 route at bench's n: the kernel on the padded
    array (int32 documents) and, apart from it, the wrapper's padding
    copies and its unpackbits; the shipped kernel against its plain version
    first.  A shape's label carries its bound (chip_smoke.py check_chunks's
    count: the inputs and outputs once)."""
    from chip_smoke import cuda_ms, least_ms, nbytes
    from colbwt_tpu_torch.ops import _kernels as K
    from colbwt_tpu_torch.ops import construct as TC

    dev = torch.device("cuda")
    stream = torch.cuda.current_stream(dev).cuda_stream
    lcp, sa_docs, rc, N = cols["lcp"], cols["sa_docs"], cols["rc"], cols["N"]
    n = lcp.size
    halo = 2 * N + 2

    def window(lib, parent, args, out):
        lcp_s, docs_s, chg_s, limit, min_mum, N = args
        C = lcp_s.shape[0] - halo
        ptrs = (lcp_s.data_ptr(), docs_s.data_ptr(),
                int(docs_s.dtype == torch.uint16), chg_s.data_ptr(), C, N,
                limit, min_mum)
        packed, ell, _ = out
        K.check("mum_window", lib.colbwt_mum_window(
            *ptrs, packed.data_ptr(), ell.data_ptr(), stream))
        return packed[:-(-C // 8)], ell

    def run(shape, args, reps):
        C = args[0].shape[0] - halo
        got = window(libs["shipped"], False, args, outputs(C))
        for g, w in zip(got, TC.mum_scan_chunk_ref(*args)):
            if not torch.equal(g, w):
                raise RuntimeError(f"K8 {shape}: differs from its plain "
                                   "version")
        bound, by = least_ms(nbytes(args[:3], got), args[3] * 6 * N)
        del got
        designs = {name: (lambda lib=lib, o=outputs(C), p=name == "parent":
                          window(lib, p, args, o))
                   for name, lib in libs.items()
                   if not name.startswith("mums-span")}
        compare(f"K8 {cols['label']} {shape}, bound {bound:.4f} ms ({by})",
                designs, reps)

    def outputs(C):
        return (torch.empty(-(-C // 32) * 4, dtype=torch.uint8, device=dev),
                torch.empty(C, dtype=torch.int32, device=dev),
                torch.empty(C + N, dtype=torch.int32, device=dev))

    def chunk(s, C):
        def sl(a, fill, dtype):
            x = a[s:s + C + halo].astype(dtype)
            return torch.from_numpy(np.concatenate(
                [x, np.full(C + halo - x.size, fill, dtype)])).to(dev)
        return (sl(lcp, 0, np.int32), sl(sa_docs, 65535, np.uint16),
                sl(rc, 1, np.uint8), min(n - N - s, C), 20, N)

    C = min(1 << 26, 1 << max(13, (n - 1).bit_length()))
    if cols["label"] == "bench":
        C = 1 << 20  # chip_smoke.py phase 3's chunks
    run(f"first chunk, C = {C}, N = {N}, uint16 documents", chunk(0, C),
        20 if C <= 1 << 20 else 5)
    last = (n - 1) // C * C
    if last:
        args = chunk(last, C)
        run(f"tail chunk at {last}, {n - last} of C = {C} in range, N = {N}",
            args, 5)
    if cols["label"] != "bench":
        return
    t = [torch.from_numpy(a.astype(np.int32)).to(dev)
         for a in (lcp, sa_docs)]
    prev = torch.from_numpy(np.cumsum(rc[1:] != 0).astype(np.int32))
    prev = torch.cat([prev.new_zeros(1), prev]).to(dev)  # changes as ranks
    padded = TC.pad_whole_array(*t, prev, N)
    run(f"K9 route's chunk, the whole array (n = {n}) padded, int32 "
        "documents", (*padded, n - N, 20, N), 20)
    pad_ms = cuda_ms(torch, lambda: TC.pad_whole_array(*t, prev, N), 20)
    packed = TC.mum_scan_chunk(*padded, n - N, 20, N)[0]
    unpack_ms = cuda_ms(torch, lambda: TC.unpackbits_little(packed, n), 20)
    wrapper_ms = cuda_ms(torch, lambda: TC.multi_mum_scan(*t, prev, N, 20),
                         20)
    log(f"[designs] K9 route at n = {n}: multi_mum_scan {wrapper_ms:.4f} ms "
        f"= padding copies {pad_ms:.4f} + the kernel (above) + "
        f"unpackbits_little {unpack_ms:.4f}")


def sweep_mums_large_n(torch, libs: dict, compare, cols: dict) -> None:
    """The large-N route on config #3's first chunk (C = 2**26, uint16
    ids): at N = 10,000 and N = 1,025, the shipped route (the tiles'
    summaries, then a block a span of starts) against the parent's
    two-pass kernels (each position's next-same-document distance by up to
    N + 1 probes, then O(N) work a window start), the shipped one held to
    its plain version first; then at N = 1,024, 256 and 64 the tile route
    (past the shipped switch the parent's, which took up to 1,024) against
    the shipped large-N route.  The labels carry the bound (the inputs and
    outputs once)."""
    from chip_smoke import least_ms, nbytes
    from colbwt_tpu_torch.ops import _kernels as K
    from colbwt_tpu_torch.ops import construct as TC

    dev = torch.device("cuda")
    stream = torch.cuda.current_stream(dev).cuda_stream
    lcp, sa_docs, rc = cols["lcp"], cols["sa_docs"], cols["rc"]
    n = lcp.size
    C = min(1 << 26, 1 << max(13, (n - 1).bit_length()))

    def chunk(N):
        halo = 2 * N + 2

        def sl(a, fill, dtype):
            x = a[:C + halo].astype(dtype)
            return torch.from_numpy(np.concatenate(
                [x, np.full(C + halo - x.size, fill, dtype)])).to(dev)
        return (sl(lcp, 0, np.int32), sl(sa_docs, 65535, np.uint16),
                sl(rc, 1, np.uint8), min(n - N, C), 20, N)

    def outputs(N):
        tiles = -(-(C + 2 * N + 2) // TC.span_tile(N))
        return (torch.empty(-(-C // 32) * 4, dtype=torch.uint8, device=dev),
                torch.empty(C, dtype=torch.int32, device=dev),
                torch.empty(max(C + N, 2 * tiles), dtype=torch.int32,
                            device=dev))

    def tile_lib(N):
        """The tile route's library for N: the shipped one up to its
        switch, past it the parent's (which took up to 1,024)."""
        return libs["shipped"] if N <= TC._TILE_MAX_N else libs.get("parent")

    def route(lib, parent, args, out, tile=False):
        lcp_s, docs_s, chg_s, limit, min_mum, N = args
        ptrs = (lcp_s.data_ptr(), docs_s.data_ptr(), 1, chg_s.data_ptr(), C,
                N, limit, min_mum)
        packed, ell, scratch = out
        if tile:
            code = lib.colbwt_mum_window(*ptrs, packed.data_ptr(),
                                         ell.data_ptr(), stream)
        else:
            size = () if parent else (4 * scratch.numel(),)
            code = lib.colbwt_mum_window_two_pass(
                *ptrs, scratch.data_ptr(), *size, packed.data_ptr(),
                ell.data_ptr(), stream)
        K.check("mum_window", code)
        return packed[:-(-C // 8)], ell

    for N, pair in ((10_000, "parent"), (1025, "parent"), (1024, "tile"),
                    (256, "tile"), (64, "tile")):
        args = chunk(N)
        got = route(libs["shipped"], False, args, outputs(N))
        for g, w in zip(got, TC.mum_scan_chunk_ref(*args)):
            if not torch.equal(g, w):
                raise RuntimeError(f"config #3 N = {N}: the large-N route "
                                   "differs from its plain version")
        bound, by = least_ms(nbytes(args[:3], got), 48 * C)
        del got
        designs = {"shipped": (lambda o=outputs(N), a=args:
                               route(libs["shipped"], False, a, o))}
        if pair == "tile":
            if tile_lib(N) is not None:
                designs["tile route"] = (lambda o=outputs(N), a=args,
                                         lib=tile_lib(N):
                                         route(lib, False, a, o, tile=True))
        else:
            designs.update({name: (lambda lib=lib, o=outputs(N), a=args,
                                   p=name == "parent": route(lib, p, a, o))
                            for name, lib in libs.items()
                            if name == "parent"
                            or name.startswith("mums-span")})
        compare(f"K8 large-N route, config #3's first chunk, C = {C}, N = "
                f"{N}, uint16 documents, bound {bound:.4f} ms ({by})",
                designs, 2)
        if N == 10_000:
            log("[designs] the large-N route's two kernels on the card "
                "(torch.profiler, 5 calls): " + json.dumps(
                    kernel_ms(torch, designs["shipped"], 5)))
        del args, designs
        torch.cuda.empty_cache()


def sweep_mums_switch(torch, libs: dict, compare, cols: dict) -> None:
    """The tile route against the large-N route on the first chunk (C =
    2**26, uint16 ids) of a collection of N genomes made as config #3's,
    for `_TILE_MAX_N`: both held to the plain version.  Past the shipped
    switch the tile route is the parent's library (skipped without
    --parent)."""
    from chip_smoke import least_ms, nbytes
    from colbwt_tpu_torch.ops import _kernels as K
    from colbwt_tpu_torch.ops import construct as TC

    dev = torch.device("cuda")
    stream = torch.cuda.current_stream(dev).cuda_stream
    lcp, sa_docs, rc, N = cols["lcp"], cols["sa_docs"], cols["rc"], cols["N"]
    n, C, halo = lcp.size, 1 << 26, 2 * N + 2

    def sl(a, fill, dtype):
        x = a[:C + halo].astype(dtype)
        return torch.from_numpy(np.concatenate(
            [x, np.full(C + halo - x.size, fill, dtype)])).to(dev)
    args = (sl(lcp, 0, np.int32), sl(sa_docs, 65535, np.uint16),
            sl(rc, 1, np.uint8), min(n - N, C), 20, N)
    tiles = -(-(C + halo) // TC.span_tile(N))
    scratch = torch.empty(2 * tiles, dtype=torch.int32, device=dev)
    ptrs = (args[0].data_ptr(), args[1].data_ptr(), 1, args[2].data_ptr(),
            C, N, args[3], 20)

    # the tile route: the shipped library up to its switch, past it the
    # parent's (which took up to 1,024 documents)
    tile_lib = (libs["shipped"] if N <= TC._TILE_MAX_N
                else libs.get("parent"))
    if tile_lib is None:
        return

    def run(tile):
        packed = torch.empty(C // 8, dtype=torch.uint8, device=dev)
        ell = torch.empty(C, dtype=torch.int32, device=dev)
        lib = tile_lib if tile else libs["shipped"]
        if tile:
            code = lib.colbwt_mum_window(*ptrs, packed.data_ptr(),
                                         ell.data_ptr(), stream)
        else:
            code = lib.colbwt_mum_window_two_pass(
                *ptrs, scratch.data_ptr(), 4 * scratch.numel(),
                packed.data_ptr(), ell.data_ptr(), stream)
        K.check("mum_window", code)
        return packed, ell

    want = TC.mum_scan_chunk_ref(*args)
    for tile in (True, False):
        for g, w in zip(run(tile), want):
            if not torch.equal(g, w):
                raise RuntimeError(f"switch N = {N}: a route differs from "
                                   "the plain version")
    bound, by = least_ms(nbytes(args[:3], want), 48 * C)
    hits = int(np.unpackbits(want[0].cpu().numpy()).sum())
    del want
    compare(f"K8 routes' switch, {N} genomes of {(n - N) // N} bp, first "
            f"chunk C = {C}, {hits} hits, bound {bound:.4f} ms ({by})",
            {"shipped": lambda: run(False), "tile route": lambda: run(True)},
            5)


def kernel_ms(torch, fn, calls: int) -> dict:
    """Device milliseconds a call of each kernel `fn` launches, from a
    torch.profiler trace of `calls` calls after a warm-up."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        dev_us = getattr(ev, "device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "cuda_time_total", 0)
        if dev_us:
            out[ev.key[:60]] = dev_us / 1e3 / calls
    return out


def sweep_thr(torch, libs: dict, compare, cols: dict) -> None:
    """K12 on each character's threshold segments of the collection's
    RLBWT, one launch (call) at a time, the terminator's apart, then the
    five as compute_thresholds makes them; the shipped kernel against its
    plain version first.  A label carries its bound (4 bytes a covered
    position, 24 a segment: chip_smoke.py's count)."""
    from chip_smoke import least_ms
    from colbwt_tpu_torch.ops import _kernels as K
    from colbwt_tpu_torch.ops import construct as TC

    dev = torch.device("cuda")
    stream = torch.cuda.current_stream(dev).cuda_stream
    lcp = cols["lcp_t"]
    n = lcp.shape[0]
    heads = TC.normalize_heads(cols["heads"])
    segs = [(int(heads[runs[0]]), torch.from_numpy(lo).to(dev),
             torch.from_numpy(hi).to(dev))
            for runs, lo, hi in TC.threshold_segments(heads, cols["lens"])]

    def argmin(lib, parent, lo, hi, out, ws):
        m = lo.shape[0]
        if parent:
            code = lib.colbwt_segmented_argmin(
                lcp.data_ptr(), lo.data_ptr(), hi.data_ptr(), m,
                out.data_ptr(), stream)
        else:
            code = lib.colbwt_segmented_argmin(
                lcp.data_ptr(), n, lo.data_ptr(), hi.data_ptr(), m,
                ws.keys.data_ptr(), ws.owner.data_ptr(), out.data_ptr(),
                stream)
        K.check("segmented_argmin", code)
        return out

    def design(lib, parent, picked):
        # keys for the smallest tile a design takes (256 positions)
        ws = types.SimpleNamespace(
            keys=torch.full((-(-n // 256),), -1, dtype=torch.int64,
                            device=dev),
            owner=torch.empty(-(-n // 256), dtype=torch.int32, device=dev))
        outs = [torch.empty(lo.shape[0], dtype=torch.int64, device=dev)
                for _, lo, _ in picked]
        return lambda: [argmin(lib, parent, lo, hi, o, ws)
                        for (_, lo, hi), o in zip(picked, outs)]

    reps = 20 if cols["label"] == "bench" else 5
    for c, lo, hi in segs:
        got = design(libs["shipped"], False, [(c, lo, hi)])()[0]
        if not torch.equal(got, TC.segmented_argmin_ref(lcp, lo, hi)):
            raise RuntimeError(f"K12 character {c}: differs from its plain "
                               "version")
    for picked, what in [([sg], f"character {sg[0]}") for sg in segs] + [
            (segs, f"all {len(segs)} characters")]:
        m = sum(lo.shape[0] for _, lo, _ in picked)
        covered = sum(int((hi - lo + 1).sum()) for _, lo, hi in picked)
        longest = max(int((hi - lo).max()) + 1 for _, lo, hi in picked)
        bound, by = least_ms(4 * covered + 24 * m, 4 * covered)
        designs = {name: design(lib, name == "parent", picked)
                   for name, lib in libs.items()}
        compare(f"K12 {cols['label']} {what}: {m} segments over {covered} "
                f"positions (longest {longest}), bound {bound:.4f} ms "
                f"({by})", designs, reps)


def sweep_tk(torch, libs: dict, compare, bench: dict) -> None:
    """K13d for shard 0 of T3 at (dp, ip) = (1, 2), G-pos's shape, against
    its plain version first."""
    from colbwt_tpu_torch.ops import _kernels as K
    from colbwt_tpu_torch.ops import query_pos as TQ
    from colbwt_tpu_torch.parallel import query_sharded_pos as TSP

    dev = torch.device("cuda")
    stream = torch.cuda.current_stream(dev).cuda_stream
    index = bench["index"]
    n, A, k = index.n, index.sigma + 1, 3
    n_local = -(-n // 2)
    C = min(n, TQ._T1_CHUNK)
    t1 = TQ.build_t1(index, np.arange(A), TQ.t1_inputs(index, C, dev), C)
    args = (t1, n, n_local, 0, A, k)
    got = TSP.compose_sharded_tk(*args)
    if not torch.equal(got, TSP.compose_sharded_tk_ref(*args)):
        raise RuntimeError("K13d differs from its plain version")
    del got

    def compose(lib):
        out = torch.empty((A ** k * n_local, 2), dtype=torch.int32,
                          device=dev)
        K.check("compose_sharded_tk", lib.colbwt_compose_sharded_tk(
            t1.data_ptr(), t1.shape[0], n, n_local, 0, A, k, out.data_ptr(),
            stream))
        return (out,)

    designs = {name: (lambda lib=lib: compose(lib))
               for name, lib in libs.items()}
    compare(f"K13d shard 0 of T{k}, {A ** k * n_local} rows, A={A}",
            designs, 10)
    del t1
    torch.cuda.empty_cache()


def sweep_scans(torch, libs: dict, compare, bench: dict) -> None:
    """K7 on the run-split indexes (when one of its variants is built), K5
    and K6a on the scaled ones, the K13b/K13c chunk scan at cells G's
    shapes."""
    from chip_smoke import scale_table
    from colbwt_tpu_torch.models.index import ColPmlIndex
    from colbwt_tpu_torch.models.tensors import to_device
    from colbwt_tpu_torch.ops import _kernels as K
    from colbwt_tpu_torch.ops import query_fused as TF
    from colbwt_tpu_torch.ops import query_mega as TM
    from colbwt_tpu_torch.ops import query_mega_wide as TW

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    tbl = bench["tbl"]
    reads, n_reads, long_reads = bench["reads"]
    split = ColPmlIndex.build(tbl, ff_bound=2)
    mega = ColPmlIndex.build(scale_table(tbl, 256), ff_bound=2)
    wide = ColPmlIndex.build(scale_table(tbl, 1024), ff_bound=2)
    log(f"[designs] scan indexes in {time.perf_counter() - t0:.1f}s")

    stream = lambda: torch.cuda.current_stream(dev).cuda_stream  # noqa: E731
    sample = reads[:8192 - 256] + n_reads[:256]
    streamed = reads[:32768 - 256] + n_reads[:256]
    # K7
    def fused(lib, ft, pats, lens, ff, row_major=False):
        B, M = pats.shape
        shape = (B, M) if row_major else (M, B)
        pml = torch.empty(shape, dtype=torch.int32, device=dev)
        cid = torch.empty(shape, dtype=torch.int32, device=dev)
        K.check("query_batch_fused", lib.colbwt_query_batch_fused(
            ft["run_rows"].data_ptr(), ft["jump_rows"].data_ptr(),
            ft["length"].data_ptr(), ft["r"], ft["jump_rows"].shape[0],
            ft["n"], pats.data_ptr(), lens.data_ptr(), B, M, ff,
            pml.data_ptr(), cid.data_ptr(), stream()))
        if row_major:
            return pml, cid
        return pml.t().contiguous(), cid.t().contiguous()

    fused_cells = ()
    if any(name in libs for name in FUSED_VARIANTS):
        fused_cells = ((split, (("E long reads", long_reads, 8192, 3),
                                ("E dispatch", sample, 256, 20),
                                ("S-E dispatch", streamed, 256, 20))),
                       (ColPmlIndex.build(tbl, ff_bound=1),
                        (("F long reads", long_reads, 8192, 3),
                         ("F dispatch", sample, 256, 20))))
    for idx, cells in fused_cells:
        ft = TF.build_fused_tables(idx, dev)
        ff = idx.ff_bound
        for label, batch, M, reps in cells:
            enc, ln = idx.encode_patterns(batch, M)
            pats = to_device(enc, dev, np.uint8)
            pats32 = to_device(enc, dev)
            lens = to_device(ln, dev)
            designs = {
                name: (lambda lib=lib, rm=name in ("row-major", "parent"),
                       p=pats32 if name == "parent" else pats:
                       fused(lib, ft, p, lens, ff, row_major=rm))
                for name, lib in libs.items()
                if name in ("shipped", "parent") + FUSED_VARIANTS}
            compare(f"K7 {label} {len(batch)}x{M} ff_bound={ff}", designs,
                    reps)
        del ft

    # K5, K6a
    def scan(lib, mt, ff, pats, lens, state, step_offset, masked, mode,
             row_major):
        B, M = pats.shape
        shape = (B, M) if row_major else (M, B)
        out0 = torch.empty(shape, dtype=torch.uint16 if mode == 2
                           else torch.int32, device=dev)
        out1 = (torch.empty(shape, dtype=torch.int32, device=dev)
                if mode == 0 else None)
        final = [torch.empty(B, dtype=torch.int32, device=dev)
                 for _ in state]
        common = (pats.data_ptr(), lens.data_ptr(),
                  *(t.data_ptr() for t in state), step_offset, B, M, ff,
                  int(masked), mode, out0.data_ptr(),
                  None if out1 is None else out1.data_ptr(),
                  *(t.data_ptr() for t in final), stream())
        if "percha" in mt:
            K.check("query_chunk_mega_wide", lib.colbwt_query_chunk_mega_wide(
                1, mt["percha"].data_ptr(), mt["percha"].shape[0],
                mt["shared"].data_ptr(), mt["length"].data_ptr(), mt["r"],
                mt["n_hi"] * TW.LIMB + mt["n_lo"], *common))
        elif "n_hi" in mt:
            K.check("query_chunk_mega_wide", lib.colbwt_query_chunk_mega_wide(
                0, mt["mega"].data_ptr(), mt["mega"].shape[0], None,
                mt["length"].data_ptr(), mt["r"],
                mt["n_hi"] * TW.LIMB + mt["n_lo"], *common))
        else:
            K.check("query_chunk_mega", lib.colbwt_query_chunk_mega(
                mt["mega"].data_ptr(), mt["mega"].shape[0],
                mt["length"].data_ptr(), mt["r"], mt["n"], *common))
        if row_major:
            return out0, out1, *final
        return rows(torch, out0), rows(torch, out1), *final

    def designs_of(fn):
        return {name: (lambda lib=lib, name=name: fn(lib, name))
                for name, lib in libs.items()
                if name in ("shipped", "parent") + MEGA_VARIANTS}

    for label, idx, mt, init in (
            ("C", mega, TM.build_mega_table(mega, device=dev),
             TM.initial_state),
            ("D full", wide,
             TW.build_mega_table_wide(wide, compact=False, device=dev),
             TW.initial_state_wide),
            ("D compact", wide,
             TW.build_mega_table_wide(wide, compact=True, device=dev),
             TW.initial_state_wide)):
        kern = (TM.query_chunk_mega if label == "C"
                else TW.query_chunk_mega_wide)
        ff = idx.ff_bound
        enc, ln = idx.encode_patterns(sample, 255)
        disp = (to_device(enc, dev, np.uint8), to_device(ln, dev),
                init(mt, len(sample)), 0)
        # the 16 long reads (5,000 bp) in chunks of 2,048: the second chunk
        # (every lane full) and the third (904 real columns a lane), each
        # from the state the chunks right of it leave
        enc, ln = idx.encode_patterns(long_reads, 3 * 2048)
        pat = to_device(enc, dev, np.uint8)
        lt = to_device(ln, dev)
        chunks, st = {}, init(mt, len(long_reads))
        for j in range(3):
            lo = (2 - j) * 2048
            chunks[j] = (pat[:, lo:lo + 2048].contiguous(), lt, st,
                         j * 2048)
            _, st = kern(mt, *chunks[j], ff_bound=ff, packed_out=True)
        cells = [("dispatch 8192x255 u16 unmasked", disp, False, 2, 20),
                 ("dispatch 8192x255 u16 masked", disp, True, 2, 20)]
        if label == "C":
            cells += [("dispatch 8192x255 two planes unmasked", disp, False,
                       0, 20),
                      ("dispatch 8192x255 two planes masked", disp, True, 0,
                       20)]
        cells += [(f"long-read chunk 16x2048 packed int32 step_offset "
                   f"{j * 2048}", chunks[j], True, 1, 5) for j in (1, 2)]
        for what, a, masked, mode, reps in cells:
            compare(f"{'K5' if label == 'C' else 'K6a'} {label} {what}",
                    designs_of(lambda lib, name, a=a, masked=masked,
                               mode=mode: scan(
                                   lib, mt, ff, *a[:4], masked, mode,
                                   name != "column-major")), reps)
        del mt
    torch.cuda.empty_cache()
    sweep_sharded_scans(torch, designs_of, compare, split, wide,
                        reads + n_reads, long_reads)


def sweep_sharded_scans(torch, designs_of, compare, split, wide, batch,
                        long_reads) -> None:
    """The K13b/K13c chunk scan at G-mega's batch (263,168 reads, E's
    ff_bound-2 split) and at G-wide's second and third long-read chunks
    (D's index), both at (dp, ip) = (1, 2) on one card: the calls the
    shipped routes make, captured, then each design's kernel on them (the
    state cloned a call, the planes column-major as the kernel stores
    them)."""
    from unittest import mock

    from colbwt_tpu_torch.ops import _kernels as K
    from colbwt_tpu_torch.ops import query_mega as TM
    from colbwt_tpu_torch.parallel import make_mesh
    from colbwt_tpu_torch.parallel import query_sharded_mega as TSM
    from colbwt_tpu_torch.parallel import query_sharded_mega_wide as TSW
    from colbwt_tpu_torch.parallel.mesh import shard_pointers

    m = make_mesh(1, 2, devices=["cuda:0"] * 2)
    calls = []
    real = TSM.sharded_scan_mega

    def capture(*a):
        calls.append(a[:6] + (tuple(t.clone() for t in a[6]),) + a[7:])
        return real(*a)

    with mock.patch.object(TSM, "sharded_scan_mega", capture):
        st = TSM.shard_mega(split, m,
                            mt=TM.build_mega_table(split, device="cpu"))
        TSM.query_batch_sharded_mega(split, batch, mesh=m, st=st)
        del st
        st = TSW.shard_mega_wide(wide, m)
        TSW.query_long_reads_sharded_mega_wide(wide, long_reads, mesh=m,
                                               chunk=2048, st=st)
    stream = torch.cuda.current_stream().cuda_stream

    def scan(lib, a):
        shards, L, length, r, n_lo, n_hi, state0, pats, lens, off, ff, w = a
        state = [t.clone() for t in state0]
        B, C = pats.shape
        dev = pats.device
        pml = torch.empty((C, B), dtype=torch.int32, device=dev)
        cid = torch.empty((C, B), dtype=torch.int32, device=dev)
        ptrs = [t.data_ptr() for t in state]
        if not w:
            ptrs.insert(3, None)
        K.check("sharded_scan_mega", lib.colbwt_sharded_scan_mega(
            int(w), shard_pointers(shards, dev, 16).data_ptr(), len(shards),
            int(L), length.data_ptr(), int(r),
            int(n_hi) * TSW.LIMB + int(n_lo) if w else int(n_lo),
            pats.data_ptr(), lens.data_ptr(), *ptrs, int(off), B, C,
            int(ff), pml.data_ptr(), cid.data_ptr(), stream))
        return pml, cid, *state

    shapes = [(f"K13b G-mega {calls[0][7].shape[0]}x{calls[0][7].shape[1]}"
               f", ip = 2", calls[0], 5)]
    shapes += [(f"K13c G-wide long-read chunk 16x2048 step_offset "
                f"{calls[j][9]}, ip = 2", calls[j], 5) for j in (2, 3)]
    for what, a, reps in shapes:
        compare(what, designs_of(lambda lib, name, a=a: scan(lib, a)), reps)
    del calls
    torch.cuda.empty_cache()


def sweep_pos(torch, libs: dict, compare, bench: dict) -> None:
    """K3 at the four shapes the main path gives it on bench's index: cell
    A's dispatch batch, S-A's streamed batch, the N reads' general-T1 batch
    and a long-read chunk with carried state; the shipped kernel against
    its plain version first."""
    from colbwt_tpu_torch.models.tensors import to_device
    from colbwt_tpu_torch.ops import _kernels as K
    from colbwt_tpu_torch.ops import query_pos as TQ

    dev = torch.device("cuda")
    stream = torch.cuda.current_stream(dev).cuda_stream
    index = bench["index"]
    reads, n_reads, long_reads = bench["reads"]
    t0 = time.perf_counter()
    pt = TQ.build_pos_tables(index, 4, alphabet=b"ACGT", device=dev)
    n = pt["n"]
    log(f"[designs] pos tables (k = 4, ACGT keys) in "
        f"{time.perf_counter() - t0:.1f}s")

    def fresh(B):
        return (torch.full((B,), n - 1, dtype=torch.int32, device=dev),
                torch.zeros((B,), dtype=torch.int32, device=dev))

    def scan(lib, table, pats, lens, pos0, mlen0, off, k, A, pack, masked,
             mode, row_major):
        B, W = pats.shape
        M = W * (8 // pack) if pack else W
        shape = (B, M) if row_major else (M, B)
        out0 = torch.empty(shape, dtype=torch.uint16 if mode == 2
                           else torch.int32, device=dev)
        out1 = (torch.empty(shape, dtype=torch.int32, device=dev)
                if mode == 0 else None)
        final = [torch.empty(B, dtype=torch.int32, device=dev)
                 for _ in range(2)]
        K.check("query_chunk_pos", lib.colbwt_query_chunk_pos(
            table.data_ptr(), table.shape[0], n, pats.data_ptr(), W,
            lens.data_ptr(), pos0.data_ptr(), mlen0.data_ptr(), off, B, M, k,
            A, pack, int(masked), mode, out0.data_ptr(),
            None if out1 is None else out1.data_ptr(),
            *(t.data_ptr() for t in final), stream))
        if row_major:
            return out0, out1, *final
        return rows(torch, out0), rows(torch, out1), *final

    cells = []
    for label, batch, reps in (("A dispatch", reads[:8192], 20),
                               ("S-A dispatch", reads[:32768], 20)):
        dig, ln, _ = TQ._encode_digits(index, pt, batch, 252)
        pat, pack = TQ.pack_digits(dig, pt["A"])
        cells.append((f"{label} {len(batch)}x252 k=4 pack={pack} u16",
                      (pt["table"], to_device(pat, dev, np.uint8),
                       to_device(ln, dev), *fresh(len(batch)), 0, 4,
                       pt["A"], pack, False, 2), reps))
    enc, ln = index.encode_patterns(n_reads[:1024], 252)
    cells.append((f"N reads {len(enc)}x252 general T1 k=1 A={pt['A_full']}",
                  (pt["t1"], to_device(enc, dev, np.uint8),
                   to_device(ln, dev), *fresh(len(enc)), 0, 1, pt["A_full"],
                   0, False, 0), 20))
    # the long reads' second chunk as query_long_reads scans it: masked,
    # two planes, the state the first chunk left
    dig, ln, _ = TQ._encode_digits(index, pt, long_reads, 3 * 2048)
    pat = to_device(dig, dev, np.uint8)
    lt = to_device(ln, dev)
    L = len(long_reads)
    _, st = TQ.query_chunk_pos(pt["table"], n, pat[:, 4096:].contiguous(),
                               lt, *fresh(L), 0, 4, pt["A"], masked=True)
    cells.append((f"long-read chunk {L}x2048 masked, carried state",
                  (pt["table"], pat[:, 2048:4096].contiguous(), lt, *st,
                   2048, 4, pt["A"], 0, True, 0), 5))
    for label, a, reps in cells:
        kw = dict(masked=a[9], packed_out=a[10] != 0,
                  fresh_state=a[10] == 2, pack=a[8])
        got = scan(libs["shipped"], *a, True)
        (wp, wc), (wpos, wml) = TQ.query_chunk_pos_ref(
            a[0], n, *a[1:5], a[5], a[6], a[7], **kw)
        for g, w in zip(got, (wp, wc, wpos, wml)):
            if w is None:
                continue
            if w.dtype == torch.uint16:
                g, w = g.view(torch.int16), w.view(torch.int16)
            if not torch.equal(g, w):
                raise RuntimeError(f"K3 {label}: differs from its plain "
                                   "version")
        del got, wp, wc
        designs = {name: (lambda lib=lib, a=a, rm=name != "pos-column-major":
                          scan(lib, *a, rm))
                   for name, lib in libs.items() if not name.startswith("t1-")}
        compare(f"K3 {label}", designs, reps)
    del pt, cells
    torch.cuda.empty_cache()
    sweep_t1(torch, {name: lib for name, lib in libs.items()
                     if not name.startswith("pos-")}, compare,
             (("bench's index", index, 20),
              ("the pangenome's index", pangenome_index(torch), 5)))


PANGENOME_PREFIX = WORK / "pangenome"
_pangenome: list = []


def pangenome_index(torch):
    """chip_smoke.py's phase 8 index: its 16 x 4.5 Mbp pangenome through
    `col-bwt-torch build -m tunnels -s 10 -l 20 --keep` on the card, built
    once a run (its artifacts kept at PANGENOME_PREFIX)."""
    from chip_smoke import pangenome_docs, write_reads
    from colbwt_tpu_torch.cli import main as cli_main
    from colbwt_tpu_torch.models.index import ColPmlIndex

    if _pangenome:
        return _pangenome[0]
    t0 = time.perf_counter()
    fastas = []
    for i, d in enumerate(pangenome_docs()):
        fastas.append(str(WORK / f"pan{i}.fa"))
        write_reads(Path(fastas[-1]), [(f"hap{i}", d)])
    prefix = str(PANGENOME_PREFIX)
    if cli_main(["build", "-o", prefix, "-m", "tunnels", "-s", "10", "-l",
                 "20", "--keep", "--device", "cuda", *fastas]):
        raise RuntimeError("the pangenome's build failed")
    _pangenome.append(ColPmlIndex.load(f"{prefix}.colpml.npz"))
    log(f"[designs] the pangenome's index (n = {_pangenome[0].n}, r = "
        f"{_pangenome[0].r}) in {time.perf_counter() - t0:.1f}s")
    return _pangenome[0]


def sweep_t1(torch, libs: dict, compare, cells) -> None:
    """K1 for one chunk of the first ACGT char (s = 0, C = min(n, 2**25))
    at each index of `cells` ((label, index, reps)), the shipped kernel
    against its plain version first; each design writes a buffer of its
    own.  The shape's label carries its bound (chip_smoke.py `t1_bytes`)."""
    from chip_smoke import least_ms, t1_bytes
    from colbwt_tpu_torch.models.tensors import to_device
    from colbwt_tpu_torch.ops import _kernels as K
    from colbwt_tpu_torch.ops import query_pos as TQ

    dev = torch.device("cuda")
    stream = torch.cuda.current_stream(dev).cuda_stream
    for label, index, reps in cells:
        n, r = index.n, index.r
        C = min(n, TQ._T1_CHUNK)
        c = int(index.char_map[ord("A")])
        a = TQ.t1_inputs(index, C, dev)
        arrays = (a["char"], a["idx_pad"], a["length"], a["lf_pos0"],
                  a["threshold"], to_device(index.pred_jump[c], dev),
                  to_device(index.succ_jump[c], dev), a["col_id"])

        def build(lib, buf):
            K.check("build_t1_chunk", lib.colbwt_build_t1_chunk(
                buf.data_ptr(), *(t.data_ptr() for t in arrays), r, c, 0, 0,
                n, C, stream))
            return (buf,)

        def fresh():
            return torch.empty((C, 2), dtype=torch.int32, device=dev)

        got = build(libs["shipped"], fresh())[0]
        if not torch.equal(got, TQ.build_t1_chunk_ref(fresh(), *arrays, c,
                                                      0, 0, n, C)):
            raise RuntimeError(f"K1 {label}: differs from its plain version")
        del got
        designs = {name: (lambda lib=lib, buf=fresh(): build(lib, buf))
                   for name, lib in libs.items()}
        bound, by = least_ms(t1_bytes(index, c, 0, C), C * 40)
        compare(f"K1 {label}: one chunk of C={C} positions, n={n}, r={r}, "
                f"bound {bound:.4f} ms ({by})", designs, reps)
        del a, arrays, designs
        torch.cuda.empty_cache()


def sweep_walk(torch, libs: dict, compare, bench: dict) -> None:
    """K10a on the first bucket of bench's MUMs (as chip_smoke.py's phase
    3 takes it) and on 16 of its MUMs, the chain floor; the shipped kernel
    against its plain version first."""
    from chip_smoke import forward_rows
    from colbwt_tpu_torch.io import formats as F
    from colbwt_tpu_torch.ops import colsplit as TCS
    from colbwt_tpu_torch.ops import oracle as O
    from colbwt_tpu_torch.ops import _kernels as K

    dev = torch.device("cuda")
    stream = torch.cuda.current_stream(dev).cuda_stream
    prefix = bench["prefix"]
    N, ml, mp = F.read_col_mums(f"{prefix}.fa.col_mums")
    fl = O.build_fl_table(*F.read_rlbwt(f"{prefix}.fa"))
    fd = TCS.fl_tensors(fl, dev)
    r = fl.r
    order = np.argsort(mp, kind="stable")
    ls = ml[order]
    sel = next(TCS.buckets(ls, np.argsort(ls, kind="stable"), True, N,
                           1 << 24))
    T, rate = int(ls[sel].max()), 10

    def walk(lib, p0, lt):
        M = p0.shape[0]
        pos = torch.empty((T, M), dtype=torch.int32, device=dev)
        valid = torch.empty((T, M), dtype=torch.bool, device=dev)
        K.check("tunneled_walk", lib.colbwt_tunneled_walk(
            fd["idx"].data_ptr(), fd["rows"].data_ptr(), r, p0.data_ptr(),
            lt.data_ptr(), M, T, rate, N, pos.data_ptr(), valid.data_ptr(),
            stream))
        return pos, valid

    p0 = torch.from_numpy(mp[order][sel].astype(np.int32)).to(dev)
    log("[designs] K10a fast-forward rows a step on bench's first bucket: "
        + json.dumps(forward_rows(torch, fd, p0, T)))
    for label, m, reps in (("bench's first bucket", sel.size, 20),
                           ("16 MUMs, the chain floor", 16, 20)):
        p0 = torch.from_numpy(mp[order][sel][:m].astype(np.int32)).to(dev)
        lt = torch.from_numpy(ls[sel][:m].astype(np.int32)).to(dev)
        got = walk(libs["shipped"], p0, lt)
        want = TCS.tunneled_walk_ref(fd, p0, lt, T, rate, N)
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise RuntimeError(f"K10a {label}: differs from its plain "
                               "version")
        del got, want
        designs = {name: (lambda lib=lib: walk(lib, p0, lt))
                   for name, lib in libs.items()}
        compare(f"K10a {label}, {m} MUMs x T={T}, rate {rate}, N={N}, "
                f"r={r}", designs, reps)
    del fd
    torch.cuda.empty_cache()
    sweep_all_walk(torch, libs, compare, bench)


def all_walk_shapes(torch, prefix: str, label: str, tunnels_too: bool):
    """The FL tensors of the index built at `prefix` and K10b's shapes
    there, (label, fd, p0, lens, T, N, reps): the first bucket col_split
    walks in all mode and its 16 longest MUMs, the chain floor; with
    `tunnels_too`, also the first tunnels-mode bucket, the shape
    chip_smoke.py's phase 3 times, and the first all-mode bucket's starts
    walked with N = 48 walkers a MUM (no collection of 48 documents is
    built: the walk is defined for any start, and N = 48 takes the
    kernel's two walkers a lane), as many MUMs as the step budget allows."""
    from colbwt_tpu_torch.io import formats as F
    from colbwt_tpu_torch.ops import colsplit as TCS
    from colbwt_tpu_torch.ops import oracle as O

    dev = torch.device("cuda")
    N, ml, mp = F.read_col_mums(f"{prefix}.fa.col_mums")
    fd = TCS.fl_tensors(O.build_fl_table(*F.read_rlbwt(f"{prefix}.fa")), dev)
    order = np.argsort(mp, kind="stable")
    ls = ml[order]
    by_len = np.argsort(ls, kind="stable")
    first = next(TCS.buckets(ls, by_len, False, N, 1 << 24))
    cuts = [("the first all-mode bucket", first, N)]
    if tunnels_too:
        cuts.append(("the first tunnels-mode bucket",
                     next(TCS.buckets(ls, by_len, True, N, 1 << 24)), N))
        wide = 48
        cut = (1 << 24) // (wide * int(ls[first].max()))
        cuts.append((f"the first all-mode bucket's {cut} longest MUMs' "
                     f"starts at N = {wide}", first[-cut:], wide))
    cuts.append(("the first all-mode bucket's 16 longest MUMs, the chain "
                 "floor", first[-16:], N))
    out = []
    for what, sel, walkers in cuts:
        T = int(ls[sel].max())
        p0 = torch.from_numpy(mp[order][sel].astype(np.int32)).to(dev)
        lt = torch.from_numpy(ls[sel].astype(np.int32)).to(dev)
        out.append((f"{label}, {what}", fd, p0, lt, T, walkers, 20))
    return out


def xla_peaks(bench: dict, parent: Path | None, times: dict) -> None:
    """Cell B's query (chip_smoke.py's phase 5: every 44th of bench's
    reads, 32 N reads, 8 long reads) through `col-bwt-torch query` on
    bench's index, the compact engine's path, each run in a process of its
    own with one tree's package (the parent's, the shipped, the shipped
    again, the parent's again): the device memory peak of each."""
    from bench import N_READS
    from chip_smoke import write_reads

    reads, n_reads, long_reads = bench["reads"]
    batch = ([reads[44 * i] for i in range(N_READS // 44)] + n_reads[:32]
             + long_reads[:8])
    pat = WORK / "reads_b.fa"
    write_reads(pat, [(f"r{i}", x) for i, x in enumerate(batch)])
    code = ("import sys, torch; from colbwt_tpu_torch.cli import main; "
            "torch.cuda.reset_peak_memory_stats(); "
            "rc = main(['query', sys.argv[1], '-p', sys.argv[2]]); "
            "print('PEAK', rc, torch.cuda.max_memory_allocated())")
    trees = [("shipped", REPO)]
    if parent is not None:
        trees = [("parent", parent.resolve()), ("shipped", REPO),
                 ("shipped (again)", REPO),
                 ("parent (again)", parent.resolve())]
    peaks = {}
    for name, root in trees:
        out = subprocess.run(
            [sys.executable, "-c", code, bench["prefix"], str(pat)],
            cwd=root, capture_output=True, text=True, timeout=900,
            env=dict(os.environ, PYTHONPATH=str(root)))
        line = [x for x in out.stdout.splitlines() if x.startswith("PEAK")]
        if out.returncode or not line or line[-1].split()[1] != "0":
            raise RuntimeError(f"cell B's query, {name}: "
                               f"{out.stderr[-2000:]}")
        peaks[name] = int(line[-1].split()[2])
    times["B query device memory peak, bytes"] = peaks
    log(f"[designs] cell B's query ({len(batch)} reads), device memory "
        "peak: " + ", ".join(f"{k} {v} B" for k, v in peaks.items()))


def sweep_all_walk(torch, libs: dict, compare, bench: dict) -> None:
    """K10b on bench's first all-mode bucket (N = 4), on the first
    tunnels-mode bucket (the shape of chip_smoke.py's phase 3), on 16 MUMs
    (the chain floor) and on the pangenome's first all-mode bucket (N =
    16); the shipped kernel against its plain version first.  The parent
    is called with its own arguments (the FL arrays, not the rows)."""
    from colbwt_tpu_torch.ops import colsplit as TCS
    from colbwt_tpu_torch.ops import _kernels as K

    dev = torch.device("cuda")
    stream = torch.cuda.current_stream(dev).cuda_stream
    rate = 10

    def walk(lib, parent, fd, p0, lt, T, N):
        M = p0.shape[0]
        pos = torch.empty((T, M, N), dtype=torch.int32, device=dev)
        height = torch.empty_like(pos)
        valid = torch.empty((T, M, N), dtype=torch.bool, device=dev)
        tables = ((fd["idx"].data_ptr(), fd["dest_interval"].data_ptr(),
                   fd["dest_offset"].data_ptr()) if parent
                  else (fd["idx"].data_ptr(), fd["rows"].data_ptr()))
        K.check("all_walk", lib.colbwt_all_walk(
            *tables, fd["idx"].shape[0], p0.data_ptr(), lt.data_ptr(), M, T,
            rate, N, pos.data_ptr(), height.data_ptr(), valid.data_ptr(),
            stream))
        return pos, height, valid

    shapes = all_walk_shapes(torch, bench["prefix"], "bench", True)
    pangenome_index(torch)
    shapes += all_walk_shapes(torch, str(PANGENOME_PREFIX), "the pangenome",
                              False)[:1]
    for label, fd, p0, lt, T, N, reps in shapes:
        got = walk(libs["shipped"], False, fd, p0, lt, T, N)
        want = TCS.all_walk_ref(fd, p0, lt, T, rate, N)
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise RuntimeError(f"K10b {label}: differs from its plain "
                               "version")
        del got, want
        designs = {name: (lambda lib=lib, par=name == "parent":
                          walk(lib, par, fd, p0, lt, T, N))
                   for name, lib in libs.items()}
        compare(f"K10b {label}, {p0.shape[0]} MUMs x T={T}, rate {rate}, "
                f"N={N}, r={fd['idx'].shape[0]}", designs, reps)
    del shapes
    torch.cuda.empty_cache()


def sweep_xla(torch, libs: dict, compare, bench: dict) -> None:
    """K4 at the shapes chip_smoke.py gives it: the main-path batch (8,192
    x 256: 7,936 of bench's reads and 256 N reads) on the unsplit index at
    ff_bound 0 and on its ff_bound-2 split at 2 and 0; the 16 long reads
    cut to their last 2,048 characters (the chain floor); and cell B's two
    batches as phase 5 dispatches them (5,989 reads x 256, 8 long reads x
    8,192).  The shipped kernel against its plain version first; the
    parent called with its own arguments (the structure-of-arrays
    fields)."""
    from colbwt_tpu_torch.models.index import ColPmlIndex
    from colbwt_tpu_torch.models.tensors import (SOA_FIELDS, index_tensors,
                                                 to_device)
    from colbwt_tpu_torch.ops import _kernels as K
    from colbwt_tpu_torch.ops import query_xla as TX
    from bench import N_READS

    dev = torch.device("cuda")
    stream = torch.cuda.current_stream(dev).cuda_stream
    index = bench["index"]
    split = ColPmlIndex.build(bench["tbl"], ff_bound=2)
    reads, n_reads, long_reads = bench["reads"]
    sample = reads[:8192 - 256] + n_reads[:256]
    # phase 5's reads: every 44th read, 32 N reads, 8 long reads, in the
    # two batches of their padded lengths
    short5 = [reads[44 * i] for i in range(N_READS // 44)] + n_reads[:32]

    def scan(lib, parent, tb, soa, pats, lens, ff, col_major=False):
        B, M = pats.shape
        shape = (M, B) if col_major else (B, M)
        pml = torch.empty(shape, dtype=torch.int32, device=dev)
        cid = torch.empty(shape, dtype=torch.int32, device=dev)
        tables = ((*(soa[f].data_ptr() for f in SOA_FIELDS), tb["r"],
                   soa["pred_jump"].numel()) if parent
                  else (tb["rows"].data_ptr(), tb["pairs"].data_ptr(),
                        tb["r"], tb["pairs"].shape[0]))
        K.check("query_batch_xla", lib.colbwt_query_batch_xla(
            *tables, tb["n"], pats.data_ptr(), lens.data_ptr(), B, M, ff,
            pml.data_ptr(), cid.data_ptr(), stream))
        if col_major:
            return pml.t().contiguous(), cid.t().contiguous()
        return pml, cid

    cells = ((index, 0, "16 long reads' last 2,048, the chain floor",
              [x[-2048:] for x in long_reads], 2048, 20),
             (index, 0, "main-path batch", sample, 256, 20),
             (split, 2, "main-path batch", sample, 256, 20),
             (split, 0, "main-path batch", sample, 256, 20),
             (index, 0, "B's first batch", short5, 256, 20),
             (index, 0, "B's second batch", long_reads[:8], 8192, 5))
    for idx, ff, label, batch, M, reps in cells:
        tb = index_tensors(idx, dev)
        # the parent's kernel reads each field as its own array
        soa = ({f: tb[f].contiguous() for f in SOA_FIELDS}
               if "parent" in libs else None)
        enc, ln = idx.encode_patterns(batch, M)
        pats, lens = to_device(enc, dev), to_device(ln, dev)
        got = scan(libs["shipped"], False, tb, soa, pats, lens, ff)
        want = TX.query_batch_device_ref(tb, pats, lens, ff_bound=ff)
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise RuntimeError(f"K4 {label}: differs from its plain version")
        del got, want
        designs = {name: (lambda lib=lib, par=name == "parent",
                          cm=name == "xla-column-major":
                          scan(lib, par, tb, soa, pats, lens, ff, cm))
                   for name, lib in libs.items()}
        compare(f"K4 {label} {len(batch)}x{M}, r={idx.r}, ff_bound={ff}",
                designs, reps)
        del tb, soa
    torch.cuda.empty_cache()


def parent_tree(parent: Path, lib):
    """The parent checkout's sharded engines: its parallel/ mesh, compact
    and mega modules loaded from `parent` and run as they are (its
    wrappers' checks, ctypes calls and routes), each launch through its own
    query_sharded.cu in `lib`; the port's other modules serve them."""
    import importlib.util
    import types
    from collections import Counter

    import torch

    from colbwt_tpu_torch.ops import _kernels as K

    class OnParent:
        """The parent's `_kernels.on(dev)` over its own library."""

        def __init__(self, dev):
            self._dev = dev

        def __getattr__(self, name):
            fn = getattr(lib, name)

            def call(*args):
                with torch.cuda.device(self._dev):
                    return fn(*args)
            return call

    def launcher(device, entry, kernel, *fixed, keep=None):
        """The parent's `_kernels.Launcher`, bound to its own library."""
        return K.Launcher(device, entry, kernel, *fixed, lib=lib, keep=keep)

    shim = types.SimpleNamespace(
        require=K.require, require_aligned=K.require_aligned,
        check=K.check, stream_handle=K.stream_handle, launches=Counter(),
        on=OnParent, Launcher=launcher)
    mods = {}
    for name in ("mesh", "query_sharded", "query_sharded_mega",
                 "query_sharded_mega_wide", "query_sharded_pos"):
        spec = importlib.util.spec_from_file_location(
            f"parent_{name}",
            parent / "colbwt_tpu_torch" / "parallel" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        mod.K = shim
        mods[name] = mod
    mods["query_sharded_mega_wide"].SM = mods["query_sharded_mega"]
    return types.SimpleNamespace(
        make_mesh=mods["mesh"].make_mesh, compact=mods["query_sharded"],
        mega=mods["query_sharded_mega"],
        wide=mods["query_sharded_mega_wide"], pos=mods["query_sharded_pos"])


def shipped_tree():
    import types

    from colbwt_tpu_torch.parallel import make_mesh
    from colbwt_tpu_torch.parallel import query_sharded as TS
    from colbwt_tpu_torch.parallel import query_sharded_mega as TSM
    from colbwt_tpu_torch.parallel import query_sharded_mega_wide as TSW
    from colbwt_tpu_torch.parallel import query_sharded_pos as TSP

    return types.SimpleNamespace(make_mesh=make_mesh, compact=TS, mega=TSM,
                                 wide=TSW, pos=TSP)


# the public arguments of the two step functions: (patterns, pml, cid) and
# the step's index, in sharded_step_compact's and sharded_step_mega's
_COMPACT_AT = (6, 12, 13, 8)
_MEGA_AT = (6, 11, 12, 8)


def sweep_step(torch, libs: dict, bench: dict, parent: Path | None,
               timed: set | None, times: dict) -> None:
    """K13a's round kernel, K13b/K13c's step and K13e's step at the five
    shapes of phase 12's per-step routes, the K13e scan of G-pos's batch,
    and the walls (G-pos, G-pos step, G-round, G-step narrow, G-step wide
    with the long reads), the parent's against the shipped code."""
    from unittest import mock

    from chip_smoke import Checks, Twins, scale_table
    from colbwt_tpu_torch.models.index import ColPmlIndex
    from colbwt_tpu_torch.ops import _kernels as K
    from colbwt_tpu_torch.ops import query_mega as TM

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    tbl, index = bench["tbl"], bench["index"]
    reads, n_reads, long_reads = bench["reads"]
    batch = reads + n_reads
    split = ColPmlIndex.build(tbl, ff_bound=2)
    wide = ColPmlIndex.build(scale_table(tbl, 1024), ff_bound=2)
    mt = TM.build_mega_table(split, device="cpu")
    log(f"[designs] step indexes in {time.perf_counter() - t0:.1f}s")

    def wanted(name):
        return timed is None or name in timed

    trees = {}
    if parent is not None and wanted("parent"):
        trees["parent"] = parent_tree(parent, libs["parent"])
    if any(wanted(d) for d in libs if d != "parent") or wanted(
            "step-wrapper"):
        trees["shipped"] = shipped_tree()
    source = "parent" if "parent" in trees else "shipped"

    def routes(name: str, tw) -> tuple[dict, dict]:
        """G-pos (its tables and the batch, as phase 12 runs it: the
        parent's per-step loop, the shipped chunk scan), G-pos step (the
        shipped tree's per-step route), G-round, G-step narrow and G-step
        wide through `name`'s routes of shards on other cards, on a (1, 2)
        mesh over cuda:0; each synchronised and timed."""
        tree = trees[name]
        m = tree.make_mesh(1, 2, devices=["cuda:0"] * 2)
        st_mega = tree.mega.shard_mega(split, m, mt=mt)
        st_wide = tree.wide.shard_mega_wide(wide, m)

        def pos_run():
            st = tree.pos.shard_pos_tables(index, m)
            return tree.pos.query_batch_sharded_pos(index, batch, mesh=m,
                                                    st=st)

        routed = [(tree.compact, "scan_row", tree.compact.round_row),
                  (tree.mega, "scan_chunk", tree.mega.step_chunk)]
        runs = [("G-pos", pos_run, [])]
        if hasattr(tree.pos, "step_row"):
            runs.append(("G-pos step", pos_run,
                         [(tree.pos, "scan_row", tree.pos.step_row)]))
        runs += [
            ("G-round", lambda: tree.compact.query_batch_sharded(
                split, batch, mesh=m), routed),
            ("G-step narrow", lambda: tree.mega.query_batch_sharded_mega(
                split, batch, mesh=m, st=st_mega), routed),
            ("G-step wide", lambda: (
                tree.wide.query_batch_sharded_mega_wide(
                    wide, batch, mesh=m, st=st_wide),
                tree.wide.query_long_reads_sharded_mega_wide(
                    wide, long_reads, mesh=m, chunk=2048, st=st_wide)),
             routed)]
        outs, walls = {}, {}
        for label, fn, patches in runs:
            with contextlib.ExitStack() as stack:
                for obj, attr, value in patches:
                    stack.enter_context(mock.patch.object(obj, attr, value))
                tw.tag = label
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                outs[label] = fn()
                torch.cuda.synchronize()
                walls[label] = time.perf_counter() - t1
            torch.cuda.empty_cache()
        del st_mega, st_wide
        return outs, walls

    # the walls in turns, each run's outputs equal to the first's; the
    # first run of the source tree captures the ninth call of each shape
    # (a tree without StepPos calls K13e's per-call wrapper on (B, M)
    # patterns and plane in its per-step loop, G-pos)
    cap = Twins(torch, Checks(torch), False)
    tree = trees[source]
    cap.wrap_launcher(tree.compact, "RoundCompact", "sharded_step_compact",
                      None, key=lambda a: a[0])
    cap.wrap_launcher(tree.mega, "StepMega", "sharded_step_mega", None,
                      key=lambda a: a[0].shape[0], shared=(1,))
    pos_rows = not hasattr(tree.pos, "StepPos")
    if pos_rows:
        cap.wrap(tree.pos, "sharded_step_pos", None)
    else:
        cap.wrap_launcher(tree.pos, "StepPos", "sharded_step_pos", None)
    order = list(trees) + list(reversed(trees))
    walls: dict = {name: [] for name in trees}
    first = None
    for j, name in enumerate(order):
        if j == 0:
            with cap:
                outs, w = routes(name, cap)
        else:
            outs, w = routes(name, Twins(torch, Checks(torch), False))
        first = first or outs
        for label in outs:
            # the parent has no per-step pos route: its G-pos is one
            got, want = outs[label], first.get(label, first["G-pos"])
            if label == "G-step wide":
                got, want = got[0] + got[1], want[0] + want[1]
            for g, x in zip(got, want):
                if not all(np.array_equal(a, b) for a, b in zip(g, x)):
                    raise RuntimeError(f"{label}: {name}'s outputs differ")
        del outs
        walls[name].append(w)
        log(f"[designs] {name} walls: " + json.dumps(w))
    times["walls"] = walls
    caps = cap.first

    shapes = (
        ("K13a rounds 1-4 (one character step), 263,168 lanes", True,
         [caps[("sharded_step_compact", "G-round", rnd)]
          for rnd in (1, 2, 3, 4)], 20),
        ("K13b one step, 263,168 lanes", False,
         [caps[("sharded_step_mega", "G-step narrow", len(batch))]], 20),
        ("K13c one step, 263,168 lanes", False,
         [caps[("sharded_step_mega", "G-step wide", len(batch))]], 20),
        ("K13c one step, 16 long-read lanes", False,
         [caps[("sharded_step_mega", "G-step wide", len(long_reads))]],
         200))
    for shape, compact, calls, reps in shapes:
        at = _COMPACT_AT if compact else _MEGA_AT
        time_step_designs(torch, shape, step_designs(
            torch, libs, trees, compact, calls, at, wanted), reps, times)
    pos_call = caps[("sharded_step_pos",
                     "G-pos" if pos_rows else "G-pos step", None)]
    time_step_designs(torch, "K13e one step, 263,168 lanes, k = 3",
                      pos_step_designs(torch, libs, trees, pos_call,
                                       pos_rows, wanted), 20, times)
    del caps, cap, pos_call
    K.reset_launches()
    torch.cuda.empty_cache()
    sweep_pos_scan(torch, libs, trees, index, batch, source, wanted, times)
    torch.cuda.empty_cache()


def time_step_designs(torch, shape: str, designs: dict, reps: int,
                      times: dict) -> None:
    """Hold every design of `designs` ({name: (make, run, out)}) to the
    first, then time each from fresh clones, as the host calls it and on
    the card alone (the shipped design first and last)."""
    from chip_smoke import cuda_ms, gpu_ms

    ref_name, ref = None, None
    for name, (make, run, out) in designs.items():
        obj = make()
        run(obj)
        got = [x.clone() for x in out(obj)]
        if ref is None:
            ref_name, ref = name, got
        elif not all(torch.equal(g, w) for g, w in zip(got, ref)):
            raise RuntimeError(f"{shape}: {name} differs from {ref_name}")
    del ref
    names = list(designs) + (["shipped"] if "shipped" in designs else [])
    ms = {}
    for name in names:
        key = "shipped (again)" if name in ms else name
        make, run, _ = designs[name]
        obj = make()
        ms[key] = {"ms": cuda_ms(torch, lambda: run(obj), reps),
                   "gpu_ms": gpu_ms(torch, lambda: run(obj), reps)}
        del obj
    times[shape] = ms
    log(f"[designs] {shape}: " + ", ".join(
        f"{k} {v['ms']:.4f} ms ({v['gpu_ms']:.4f} on the card)"
        for k, v in ms.items()))


def pos_step_designs(torch, libs: dict, trees: dict, call: tuple,
                     rows_captured: bool, wanted) -> dict:
    """{design: (make, run, out)} for K13e's step from the captured call
    (`sharded_step_pos`'s arguments, (B, M) patterns and plane where
    `rows_captured`, else (M, B)): the parent's step as its route calls it
    (its StepPos, else its per-call wrapper), the shipped StepPos
    launcher, the public per-call wrapper and the row-major variant under
    `K.Launcher`; out() gives the step's k output columns as (k, B), the
    state and the next position and key."""
    import ctypes as C

    from chip_smoke import clone_args
    from colbwt_tpu_torch.ops import _kernels as K
    from colbwt_tpu_torch.parallel import query_sharded_pos as TSP

    def flip(c):
        """Patterns and plane between (B, M) and (M, B)."""
        c = list(c)
        c[3], c[7] = c[3].t().contiguous(), c[7].t().contiguous()
        return tuple(c)

    rows_call = call if rows_captured else flip(call)
    cols_call = flip(call) if rows_captured else call
    t, k = call[4], call[5]

    def out(c, layout: str) -> list:
        M = c[3].shape[1 if layout == "rows" else 0]
        cols = [M - 1 - (t * k + j) for j in range(k)]
        plane = c[7][:, cols].t() if layout == "rows" else c[7][cols]
        return [plane.contiguous(), c[1], c[2], c[8], c[9]]

    def fresh(c):
        return lambda: clone_args(torch, c)

    def launcher(lib, mod=TSP):
        """mod's StepPos (lib None) on (M, B) columns, or a variant's
        library under `K.Launcher` on (B, M) memory in (M, B) shapes."""
        def make():
            if lib is None:
                c = clone_args(torch, cols_call)
                return c, mod.StepPos(*c[:4], *c[5:])
            c = clone_args(torch, rows_call)
            B, M = c[3].shape
            v = list(c)
            v[3], v[7] = c[3].view(M, B), c[7].view(M, B)
            params = TSP.step_pos_params(*v[:4], *v[5:])
            return c, K.Launcher(c[3].device, "colbwt_sharded_step_pos",
                                 "sharded_step_pos", C.addressof(params),
                                 lib=lib, keep=params)
        return (make, lambda o: o[1](t),
                lambda o: out(o[0], "cols" if lib is None else "rows"))

    designs = {}
    if "parent" in trees and wanted("parent"):
        pmod = trees["parent"].pos
        if hasattr(pmod, "StepPos"):
            designs["parent"] = launcher(None, pmod)
        else:
            designs["parent"] = (fresh(rows_call),
                                 lambda c: pmod.sharded_step_pos(*c),
                                 lambda c: out(c, "rows"))
    if "shipped" not in trees:
        return designs
    if wanted("shipped"):
        designs["shipped"] = launcher(None)
    if wanted("step-wrapper"):
        designs["step-wrapper"] = (fresh(cols_call),
                                   lambda c: TSP.sharded_step_pos(*c),
                                   lambda c: out(c, "cols"))
    if "step-row-major" in libs:
        designs["step-row-major"] = launcher(libs["step-row-major"])
    return designs


def sweep_pos_scan(torch, libs: dict, trees: dict, index, batch: list,
                   source: str, wanted, times: dict) -> None:
    """K13e's scan of G-pos's batch (263,168 reads, k = 3, 51 steps) on the
    T3 shards of a (1, 2) mesh over cuda:0: the parent's scan as its route
    makes it (51 fetches and 51 steps through its wrappers), the shipped
    chunk scan as the route calls it (the kernel and the wrapper's
    transpose), the kernel alone ("shipped-kernel"), the row-major variant
    ("scan-pos-row-major") and the shipped per-step route ("step-route":
    51 fetches and 51 StepPos steps); every design's packed (B, M) outputs
    equal to the first's, each timed as the host calls it and on the card
    alone (the shipped design first and last)."""
    from chip_smoke import cuda_ms, gpu_ms
    from colbwt_tpu_torch.ops import _kernels as K
    from colbwt_tpu_torch.parallel import query_sharded_pos as TSP
    from colbwt_tpu_torch.parallel.mesh import shard_pointers

    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    meshes = {name: tree.make_mesh(1, 2, devices=["cuda:0"] * 2)
              for name, tree in trees.items()}
    st = trees[source].pos.shard_pos_tables(index, meshes[source])
    k, A, n, L = st["k"], st["A"], st["n"], st["n_local"]
    M = -(-max(len(x) for x in batch) // k) * k
    enc, _ = index.encode_patterns(batch, M)
    pats = torch.from_numpy(enc.astype(np.uint8)).to(dev)
    B = pats.shape[0]
    shards = [st["table"][("cuda:0", i)] for i in range(2)]
    tab = shard_pointers(shards, dev, 2)

    def direct(lib, col_major: bool):
        plane = torch.empty((M, B) if col_major else (B, M),
                            dtype=torch.int32, device=dev)

        def run():
            K.check("sharded_scan_pos", lib.colbwt_sharded_scan_pos(
                tab.data_ptr(), 2, L, pats.data_ptr(), B, M, k, A, n,
                plane.data_ptr(), stream))
            return plane.t() if col_major else plane
        return run

    designs = {}
    if "parent" in trees and wanted("parent"):
        designs["parent"] = lambda: trees["parent"].pos.scan_row(
            meshes["parent"], st, 0, pats)
    if "shipped" in trees:
        if wanted("shipped"):
            designs["shipped"] = lambda: TSP.sharded_scan_pos(
                shards, L, pats, k, A, n)
        if wanted("shipped-kernel"):
            designs["shipped-kernel"] = direct(libs["shipped"], True)
        if "scan-pos-row-major" in libs:
            designs["scan-pos-row-major"] = direct(
                libs["scan-pos-row-major"], False)
        if wanted("step-route"):
            designs["step-route"] = lambda: TSP.step_row(
                meshes["shipped"], st, 0, pats)
    shape = (f"K13e scan of G-pos's batch, {B} lanes x {M // k} steps, "
             f"k = {k}, 2 shards")
    ref_name, ref = None, None
    for name, fn in designs.items():
        got = fn().clone()
        if ref is None:
            ref_name, ref = name, got
        elif not torch.equal(got, ref):
            raise RuntimeError(f"{shape}: {name} differs from {ref_name}")
    del ref
    ms = {}
    for name in list(designs) + (["shipped"] if "shipped" in designs
                                 else []):
        key = "shipped (again)" if name in ms else name
        ms[key] = {"ms": cuda_ms(torch, designs[name], 5),
                   "gpu_ms": gpu_ms(torch, designs[name], 5)}
    times[shape] = ms
    log(f"[designs] {shape}: " + ", ".join(
        f"{k_} {v['ms']:.4f} ms ({v['gpu_ms']:.4f} on the card)"
        for k_, v in ms.items()))
    del st, shards, designs


def step_designs(torch, libs: dict, trees: dict, compact: bool, calls: list,
                 at: tuple, wanted) -> dict:
    """{design: (make, run, out)} for one shape: make() prepares fresh
    clones of the captured calls ((C, B) patterns and planes) and the
    design's launchers, run(obj) makes the calls (and nothing else: it is
    what is timed), out(obj) returns the step's outputs (its pml and cid
    column, the state and the next indices) in one layout for every
    design."""
    import ctypes as C

    from chip_smoke import clone_args
    from colbwt_tpu_torch.ops import _kernels as K

    p_at, pl_at, ci_at, s_at = at
    shared = () if compact else (1,)
    col_of = [c[p_at].shape[0] - 1 - c[s_at] for c in calls]

    def outputs(cs, layout: str) -> list:
        out = []
        for c, col in zip(cs, col_of):
            pl, ci = c[pl_at], c[ci_at]
            if layout == "rows":
                pl, ci = pl[:, col], ci[:, col]
            elif layout == "cols":
                pl, ci = pl[col], ci[col]
            else:  # interleaved (M, B, 2)
                pl, ci = pl[col, :, 0], pl[col, :, 1]
            state = c[5]
            nexts = c[14:17] if compact else (c[13],)
            out += [pl, ci, *state, *nexts]
        return out

    def rows_of(c):
        """Captured arguments on (B, C) patterns and planes (the planes'
        contents carried over: a round that writes no outputs leaves its
        column as it found it)."""
        c = list(c)
        for j in (p_at, pl_at, ci_at):
            c[j] = c[j].t().contiguous()
        return tuple(c)

    def fresh(row_layout: bool):
        def make():
            cs = [clone_args(torch, c, shared) for c in calls]
            return [rows_of(c) for c in cs] if row_layout else cs
        return make

    from colbwt_tpu_torch.parallel import query_sharded as TS
    from colbwt_tpu_torch.parallel import query_sharded_mega as TSM

    def launcher(c, tree):
        """`tree`'s launcher of call c (its public arguments)."""
        if compact:
            rnd = c[0]
            return tree.compact.RoundCompact(
                c[2], c[3] if rnd == 1 else None, c[3] if rnd == 2 else None,
                *c[4:8], *c[9:]), (c[0], c[1], c[8])
        return tree.mega.StepMega(*c[:8], *c[9:]), (c[8],)

    def launched(lib, layout: str, tree=None):
        """A design of a launch path: `tree`'s launchers (lib None), or a
        variant's library under `K.Launcher` over a parameter block made
        once, the row-major and interleaved variants given their planes as
        the kernel reads them, past the launchers' shape checks."""
        def make():
            cs = fresh(layout == "rows")()
            ls = []
            for j, c in enumerate(cs):
                if lib is None:
                    ls.append(launcher(c, tree))
                    continue
                c = list(c)
                B = c[pl_at].shape[layout != "rows"]
                M = c[p_at].numel() // B
                if layout == "rows":  # (B, M) memory in (M, B) shapes
                    view = [c[p_at].view(M, B), c[pl_at].view(M, B),
                            c[ci_at].view(M, B)]
                elif layout == "cols":
                    view = [c[p_at], c[pl_at], c[ci_at]]
                else:  # one (M, B, 2) plane for pml and cid
                    c[pl_at] = torch.zeros((M, B, 2), dtype=torch.int32,
                                           device=c[pl_at].device)
                    c[ci_at] = c[pl_at]
                    view = [c[p_at], c[pl_at], c[pl_at]]
                cs[j] = tuple(c)
                v = list(c)
                v[p_at], v[pl_at], v[ci_at] = view
                if compact:
                    rnd = v[0]
                    params = TS.round_compact_params(
                        v[2], v[3] if rnd == 1 else None,
                        v[3] if rnd == 2 else None, *v[4:8], *v[9:])
                    entry, name, call = ("colbwt_sharded_step_compact",
                                         "sharded_step_compact",
                                         (v[0], v[1], v[8]))
                else:
                    params = TSM.step_mega_params(*v[:8], *v[9:])
                    entry, name, call = ("colbwt_sharded_step_mega",
                                         "sharded_step_mega", (v[8],))
                ls.append((K.Launcher(v[6].device, entry, name,
                                      C.addressof(params), lib=lib,
                                      keep=params), call))
            return cs, ls

        def run(obj):
            for go, call in obj[1]:
                go(*call)
        return make, run, lambda obj: outputs(obj[0], layout)

    designs = {}
    if "parent" in trees:
        designs["parent"] = launched(None, "cols", trees["parent"])
    if "shipped" not in trees:
        return designs
    if wanted("shipped"):
        designs["shipped"] = launched(None, "cols", trees["shipped"])
    if wanted("step-wrapper"):
        wrapper_fn = (TS.sharded_step_compact if compact
                      else TSM.sharded_step_mega)

        def run_wrapper(cs):
            for c in cs:
                wrapper_fn(*c)
        designs["step-wrapper"] = (fresh(False), run_wrapper,
                                   lambda cs: outputs(cs, "cols"))
    if "step-row-major" in libs:
        designs["step-row-major"] = launched(libs["step-row-major"], "rows")
    if "step-interleaved" in libs and not compact:
        designs["step-interleaved"] = launched(libs["step-interleaved"],
                                               "pairs")
    return designs


if __name__ == "__main__":
    sys.exit(main())
