#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's two entry points.  `col-bwt-torch build` on bench.py's
collection (4 x 1 Mbp haplotypes, seed 0xBE7C, 20,000 mutations each,
min-MUM 20, split rate 10) and on a pangenome of 16 x 4.5 Mbp haplotypes
(n = 72,000,016), in both SA lanes and both split modes, with the native
library and without it (the device suffix array), and on config #3's
10,000 genomes given as a file list (the large-N multi-MUM route);
`col-bwt-torch query` on bench's index, on two indexes made from it by
scaling every run length (n ~ 1.0e9 and ~ 4.1e9, the mega and mega-wide
paths), on two run-split builds of it (the fused path), one-shot and
`--stream`, and `--stream` on config #3's index and config #4's (8
haplotypes given as a file list, the compact fallback past the general
T1's int32 bound).

    python3 chip_smoke.py --config3     # phases 1, 2 and 14 alone, whole
    python3 chip_smoke.py --config4     # phases 1, 2 and 15 alone, whole
    python3 chip_smoke.py --config4 --sa-mode chunked
        # then, in the same machine: config #4 through the chunked SA lane,
        # byte-equal to the build --config4 left
Every CUDA kernel of those paths is checked against its plain PyTorch
version on the card.  Phases:

1. the card's name and power limit (nvidia-smi); exits nonzero without CUDA
2. build the CUDA kernels from colbwt_tpu_torch/csrc and the host library
   of native/ (SA-IS, Kasai, the chunked SA lane)
3. build bench's index with build_pipeline on the card (the device lane:
   the one-shot multi-MUM scan K9, the tunnels walk K10a), and hold its
   .col_mums, .col_runs and .col_ids against the host functions on the
   same arrays (O.find_multi_mums; col_split_tunneled_numpy and the
   find_col_runs_uniform sweep); K8-K10b against their plain versions at
   bench's shapes (K10a also on 16 MUMs of the bucket, its chain floor,
   beside the time of its row build and its fast-forward rows a step);
   K1-K4 at the main path's shapes; then the scaled
   indexes (run lengths x256 and x1024, ColPmlIndex.build with ff_bound 2,
   r = 1.37M) and K5, K6a-K6c at the shapes of phases 6-7 (the dispatch
   batch masked, as the engines scan it, and unmasked; the long reads'
   second and third chunks of 2,048); then bench's
   table run-split with ff_bound 2 and 1 (saved for phases 9-10), K7 at
   the fused path's shapes (8,192 x 256 and 16 x 8,192) on both and at
   the streamed batch (32,768 x 256, cell S-E) on the first, and K14
   on the ff_bound 2 jump rows, pageable and pinned (byte-equal to the
   plain copy, timed beside one pinned and one pageable copy_ of the same
   bytes and the host threads' memcpy alone); K11a every round of bench's
   suffix array as suffix_array runs it (the previous order, one
   workspace; rounds 2-3 also without the order), order, ranks and largest
   rank; the widest round timed beside one stable torch.sort of PR 5's
   packed keys and of the 32-bit ranks, every round's time logged; K11b's
   LCP and K12's thresholds against their plain versions, the native Kasai
   LCP and O.compute_thresholds_fast
4. main path, a large query: `query` of bench.py's 262,144 x 150 bp reads,
   1,024 of them with one N inserted, and 16 reads of 5,000 bp; the engine
   must be pos(k=4), 256 sampled records must equal the oracle
   (query_pml_oracle) on the unsplit table, and K1-K3 must have launched
5. main path, a small query: `query` with the default engine choice of
   every 44th bench read, 32 of the N reads and 8 long reads (5,997
   reads, under 1M characters, so the ladder picks the compact engine):
   the engine must be xla, records equal phase 4's, and K4 must have
   launched
6. the mega path: phase 4's reads through `query` on the x256 index (4·n
   > 2**31 - 1, so no positional table fits): the engine must be mega, the
   256 sampled records must equal the oracle on the scaled table, and K5
   must have launched
7. the mega-wide path: the same on the x1024 index (n > 2**31): the engine
   must be mega-wide (full layout) and K6a, K6b must have launched; then
   7b, phase 5's reads through query_pipeline with a memory budget one byte
   under the full table, so the compact layout is built: records equal
   phase 7's and K6a-K6c must have launched
8. the build path at full size: `build -m tunnels -s 10 -l 20` of the
   pangenome (one random base, seed 0xB11D, 90,000 substitutions a
   haplotype, bench's 2% density): K8 runs two chunks of 2**26 with
   N = 16, then K10a (each launch timed in the build between CUDA events,
   then held to its plain version, the first also timed beside it); both
   chunks equal the plain version, the oracle's
   window conditions agree with the scan on 256 reported MUMs and 100,000
   unreported window starts, and a query of 2,000 reads drawn from the
   haplotypes answers, 64 sampled records equal to the oracle
   8b. bench's collection through `build --sa-mode chunked --chunk-chars
   1000000` (K8 through the in-process streamed driver): every artifact
   byte-equal to phase 3's
   8c. bench's collection through `build -m all` (K10b): .col_runs and
   .col_ids byte-equal to the host col_split_all_numpy on the same MUMs
9. the fused path (run after 7b): phase 4's reads through `query --engine
   fused` on the ff_bound 2 index: the engine must be fused, the 256
   sampled records must equal the oracle on the unsplit table, and K7 and
   K14 must have launched
   9b. phase 5's reads under the default engine on the ff_bound 1 index:
   the ladder must pick fused, records equal phase 5's
10. `query --stream` of phase 4's reads on bench's index (pos, k=4): both
   files byte-equal to phase 4's, reads/s beside phase 4's; K3 at each
   shape the stream gave it, held to its plain version and timed; 10b
   the same with --engine fused on phase 9's index, byte-equal to phase
   9's
11. the build without the native library (`native.available` patched to
   False for the phase, as on a host without native/): bench's collection
   through `build -m tunnels -s 10 -l 20` (K11a, K11b; every artifact and
   the index byte-equal to phase 3's); 11b phase 8's pangenome through
   stage_mums (its four artifacts byte-equal to phase 8's; rounds,
   sa_lcp_s and the device memory peak logged), then its suffix array and
   pyramid once more: every K11a round timed with its passes and bound
   (the last beside one stable torch.sort of its packed pair keys), K11b
   against its plain version and timed, and sa_lcp_s split into
   rounds, K11b, copies and host; 11c bench.py's index-build
   sequence (bench.py:83-98) through the port's ops, thresholds by K12
   (the table equal to phase 3's field by field, the ff_bound-2 index to
   phase 3's)
12. the sharded query API (colbwt_tpu_torch/parallel/), its ip shards as
   separate tensors on the one card (make_mesh over ["cuda:0"] * dp·ip):
   phase 4's 263,168 reads of <= 152 bp in one batch at (dp, ip) = (1, 2)
   through sharded-pos (k = 3 on bench's index: K1, K13d, the K13e chunk
   scan, one launch), sharded compact (the K13a chunk scan, one launch) and
   sharded-mega (the K13b chunk scan, one launch) on phase 9's ff_bound-2
   split, and sharded-mega-wide (K6b slices, the K13c chunk scan) on phase
   7's index at (1, 2), (2, 2) and (1, 4), with the 16 long reads in
   chunks of 2,048 (each wall split into shard placement, batch and long
   reads); then the route of shards on other cards once at (1, 2): the
   pos engine's per-step route (a fetch and a K13e step a step), the
   compact engine's per-round route (a fetch and a K13a round kernel a
   gather round) on the split, and the mega engines' per-step route (the
   fetch and the per-step kernel K13b/K13c), narrow on the split and wide
   on phase 7's index; every output equal to the single-card engine's on
   the same reads (phase 4's pos records, K4, K5, phase 7's mega-wide
   records), every launch count the one its route gives; each kernel
   equal to its plain version call by call, K1 among them (the compact
   engine's per-round route on 8,192 of the reads; every engine through
   both routes, the wide long reads too)
13. the persisted table cache and the build's prewarm (every query above
   went through the cache under "auto"): stage_prewarm on the mega
   index; phase 6's reads through `query` again, which must load the
   mega table (K14) and write records byte-equal to phase 6's, the loaded
   tables equal to a fresh build; each "auto" decision held where build
   and cache lie far apart: phase 6's save of C's table (its save and
   load must beat its build), phase 7's skipped save of D's (its save and
   load, measured in a scratch directory, must not beat its build) and
   phases 4 and 10's skipped save of A's pos tables (the copy of its
   tables to the host, the first step of any save, must take longer than
   their build); D's full table built and loaded five times each, and
   "auto" on the saved entry reported, not held (the two lie within
   their runs' spread); a compact-layout engine must miss the full entry;
   then phase 4's
   query under utils/profiling.trace, records byte-equal to phase 4's,
   and the device's busy share of its wall
14. config #3 (BASELINE.json: 10,000 near-identical SARS-CoV-2-sized
   genomes, scripts/validate_config3.py's generator, seed 0xC0F3), cut to
   genomes of CONFIG3_SMOKE["doc_len"] bp and CONFIG3_SMOKE["reads"]
   reads (`--config3` runs it whole, 30,000 bp and 1,000,000 reads,
   alone): the genomes written as 10,000 FASTA files and a file list,
   `build -i LIST -m tunnels -s 10 -l 20` (the large-N route of K8,
   N = 10,000, in chunks of 2**26; K10a; at full size n, the BWT's r and
   the multi-MUM count must be logs/config3_all_r3.log's), the route's
   first and last chunks equal to its plain version and the first timed
   beside it, the same positions at N = 1,025 with uint16 and int32 ids
   likewise; then `query --stream` of validate_config3.py's reads: 512
   sampled records equal to the C++ serial engine (io/native) on the
   index's table, 8 of them to the oracle; engine, tables' bytes, memory
   peak, stage seconds and reads/s logged
15. config #4 (BASELINE.json: 8 human-chr21-scale haplotypes, one random
   base and 25,000 substitutions per 46,000,000 bp, min-MUM 100,
   scripts/validate_config4.py's generator, seed 0xC4), cut to haplotypes
   of CONFIG4_SMOKE["doc_len"] bp and CONFIG4_SMOKE["reads"] reads
   (`--config4` runs it whole, 46,000,000 bp and 5,000,000 reads, alone),
   with 1,024 reads with an N added: the haplotypes written as FASTA files
   and a file list, `build -i LIST -m tunnels -s 10 -l 100` (K8's tile
   route, N = 8; K10a; the prewarm's K1), then `query --stream`, pos at
   k = 1 over ACGT keys without the general T1, whose N reads K4 serves on
   the run-split index.  At full size config #4's n makes those decisions
   and the run split; the cut forces them through ColBwtConfig (run_split
   "always", a pos_hbm_budget of 5·n·8 bytes), calls build_pipeline and
   query_stream with it and prints them, and any other decision fails it.
   K8's chunks, K10a's buckets, K1's chunks and K3's and K4's shapes from
   the query equal to their plain versions and timed; 256 sampled records
   equal to the C++ serial engine, 8 of them and the 4 N reads among them
   to the oracle; at full size n, the BWT's r, the multi-MUMs, the col-split
   marks and the col runs must be logs/config4_r3.log's; engine, tables'
   bytes, memory peak, stage seconds and reads/s logged.  `--config4
   --sa-mode chunked` builds it again with `--sa-mode chunked --chunk-chars
   100000000` (4 chunks): every artifact and the index byte-equal to the
   monolithic build's

Each query scan (K3-K7, the chunk scans) is also timed on 16 lanes of
long reads, whose time a step is that of a chain of dependent loads that
no other lane hides; its [time] lines at larger batches give the chain
floor, the batch's longest lane's steps times that time, beside the byte
bound.

Launch counts are reset just before each build and query and read just
after it; a kernel's "launches" is the sum over all of them.  The last
lines are a [cache and profile] line of phase 13's values, phase 14's
[config3] line, phase 15's [config4] line, a [build path] line of stage
seconds, the card line, one
{"kernels": [...]} JSON line and {"ok": true, "device": {...}}.
Everything is written under build/chip_smoke/ of the checkout.  Imports
nothing of JAX and nothing of the JAX package colbwt_tpu (from bench.py
only make_docs and make_reads, which need numpy alone).
"""

from __future__ import annotations

import contextlib
import json
import logging
import shutil
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

import numpy as np

REPO = Path(__file__).resolve().parent
WORK = REPO / "build" / "chip_smoke"

KERNEL_INFO = {
    "build_t1_chunk": ("K1", "colbwt_tpu_torch/csrc/query_pos.cu",
                       "colbwt_tpu/ops/query_pos.py:93"),
    "compose_tables": ("K2", "colbwt_tpu_torch/csrc/query_pos.cu",
                       "colbwt_tpu/ops/query_pos.py:153"),
    "query_chunk_pos": ("K3", "colbwt_tpu_torch/csrc/query_pos.cu",
                        "colbwt_tpu/ops/query_pos.py:309"),
    "query_batch_xla": ("K4", "colbwt_tpu_torch/csrc/query_xla.cu",
                        "colbwt_tpu/ops/query_xla.py:153"),
    "query_chunk_mega": ("K5", "colbwt_tpu_torch/csrc/query_mega.cu",
                         "colbwt_tpu/ops/query_mega.py:116"),
    "query_chunk_mega_wide": ("K6a", "colbwt_tpu_torch/csrc/query_mega.cu",
                              "colbwt_tpu/ops/query_mega_wide.py:369"),
    "fill_block_wide": ("K6b", "colbwt_tpu_torch/csrc/query_mega_wide.cu",
                        "colbwt_tpu/ops/query_mega_wide.py:160"),
    "shared_table_wide": ("K6c", "colbwt_tpu_torch/csrc/query_mega_wide.cu",
                          "colbwt_tpu/ops/query_mega_wide.py:183"),
    "mum_window": ("K8/K9", "colbwt_tpu_torch/csrc/construct.cu",
                   "colbwt_tpu/ops/construct_jax.py:245"),
    "mum_window_two_pass": ("K8/K9 large-N route",
                            "colbwt_tpu_torch/csrc/construct.cu",
                            "colbwt_tpu/ops/construct_jax.py:245"),
    "tunneled_walk": ("K10a", "colbwt_tpu_torch/csrc/colsplit.cu",
                      "colbwt_tpu/ops/colsplit_jax.py:59"),
    "all_walk": ("K10b", "colbwt_tpu_torch/csrc/colsplit.cu",
                 "colbwt_tpu/ops/colsplit_jax.py:84"),
    "query_batch_fused": ("K7", "colbwt_tpu_torch/csrc/query_fused.cu",
                          "colbwt_tpu/ops/query_fused.py:108"),
    "upload_rows": ("K14", "colbwt_tpu_torch/csrc/xfer.cu",
                    "colbwt_tpu/utils/xfer.py:27"),
    "doubling_round": ("K11a", "colbwt_tpu_torch/csrc/suffix.cu",
                       "colbwt_tpu/ops/construct_jax.py:51"),
    "lcp_lift": ("K11b", "colbwt_tpu_torch/csrc/suffix.cu",
                 "colbwt_tpu/ops/construct_jax.py:106"),
    "segmented_argmin": ("K12", "colbwt_tpu_torch/csrc/suffix.cu",
                         "colbwt_tpu/ops/construct_jax.py:494"),
    "sharded_fetch": ("K13a/b/c/e", "colbwt_tpu_torch/csrc/query_sharded.cu",
                      "colbwt_tpu/parallel/query_sharded.py:33"),
    "sharded_scan_compact": ("K13a", "colbwt_tpu_torch/csrc/query_sharded.cu",
                             "colbwt_tpu/parallel/query_sharded.py:56"),
    "sharded_step_compact": ("K13a", "colbwt_tpu_torch/csrc/query_sharded.cu",
                             "colbwt_tpu/parallel/query_sharded.py:56"),
    "sharded_step_mega": ("K13b/K13c",
                          "colbwt_tpu_torch/csrc/query_sharded.cu",
                          "colbwt_tpu/parallel/query_sharded_mega.py:53"),
    "compose_sharded_tk": ("K13d", "colbwt_tpu_torch/csrc/query_sharded.cu",
                           "colbwt_tpu/parallel/query_sharded_pos.py:67"),
    "sharded_step_pos": ("K13e", "colbwt_tpu_torch/csrc/query_sharded.cu",
                         "colbwt_tpu/parallel/query_sharded_pos.py:163"),
    "sharded_scan_pos": ("K13e", "colbwt_tpu_torch/csrc/query_sharded.cu",
                         "colbwt_tpu/parallel/query_sharded_pos.py:163"),
    "sharded_scan_mega": (
        "K13b/K13c", "colbwt_tpu_torch/csrc/query_mega.cu",
        "colbwt_tpu/parallel/query_sharded_mega_wide.py:101"),
}
# the least time of a kernel's work: its bytes (each input read once, each
# output written once; a gathered table counted at the bytes its gathers
# take, at most the whole table) over the H100 SXM's 3.35 TB/s, or its
# integer operations over 67e12 a second (the data sheet's rate outside the
# tensor cores; these kernels do int32 ALU work), whichever is longer
HBM_BYTES_PER_S = 3.35e12
ALU_OPS_PER_S = 67e12
BUILD_KEYS = ("sa_lcp_s", "bwt_s", "mums_s", "thresholds_s", "colsplit_s",
              "index_s", "table_cache", "prewarm_s", "build_s", "mums",
              "marks")
QUERY_KEYS = ("engine", "read_s", "table_cache", "table_build_s",
              "table_save_s", "scan_s", "write_s", "query_s", "reads")
STREAM_KEYS = ("engine", "table_cache", "table_build_s", "table_save_s",
               "reads", "query_s")
# a device interval of a torch.profiler Chrome trace: kernels and copies
BUSY_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
# phase 8's pangenome: haplotypes, haplotype length, substitutions each
PANGENOME = (16, 4_500_000, 90_000)
ARTIFACTS = ("fa.bwt.heads", "fa.bwt.len", "fa.thr_pos", "fa.col_mums",
             "lengths", "fa.col_runs", "fa.col_ids", "fa.col_pml")
# run-length scales of the mega (n ~ 1.0e9) and mega-wide (n ~ 4.1e9) indexes
MEGA_SCALE, WIDE_SCALE = 256, 1024
# BASELINE.json config #3 as scripts/validate_config3.py makes it (seed
# 0xC0F3): genomes, genome length, hotspot sites, substitutions a genome,
# reads of 150 bp; and what logs/config3_all_r3.log reports at that size
CONFIG3 = {"docs": 10_000, "doc_len": 30_000, "hotspots": 600, "muts": 12,
           "reads": 1_000_000}
CONFIG3_LOG = {"n": 300_010_000, "bwt_r": 211_440, "mums": 410}
# phase 14's cuts of it within the smoke's time (PERF.md section 4): the
# reads first, then the genome length; `--config3` runs it whole
CONFIG3_SMOKE = {"doc_len": 7_000, "reads": 262_144}
# BASELINE.json config #4 as scripts/validate_config4.py makes it (seed
# 0xC4): haplotypes, haplotype length, substitutions a haplotype, min-MUM,
# reads of 150 bp, and the reads with an N added to them as to cell A's
# (without them no read leaves the pos engine's ACGT keys); and what
# logs/config4_r3.log reports at that size (col runs: the table's rows)
CONFIG4 = {"docs": 8, "doc_len": 46_000_000, "muts": 25_000, "min_mum": 100,
           "reads": 5_000_000, "n_reads": 1_024}
CONFIG4_LOG = {"n": 368_000_008, "bwt_r": 36_212_696, "mums": 108_106,
               "marks": 4_298_137, "col_runs": 38_265_504}
# phase 15's cut of it within the smoke's time (PERF.md section 4): the
# reads first, then the haplotype length (n > 2**26: K8 runs two chunks);
# `--config4` runs it whole
CONFIG4_SMOKE = {"doc_len": 8_500_000, "reads": 262_144}
# the chunked SA lane's chunk at config #4: two haplotypes a chunk, 4 chunks
CONFIG4_CHUNK_CHARS = 100_000_000
# phase 12's counted runs of the per-step and per-round routes, by cell
CELLS_G = {"sharded-pos (1,2) step route": "G-pos step",
           "sharded-compact (1,2) round route": "G-round",
           "sharded-mega (1,2) step route": "G-step narrow",
           "sharded-mega-wide (1,2) step route": "G-step wide"}


def log(msg: str) -> None:
    print(msg, flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def scale_table(tbl, s: int):
    """`tbl` with every run length (and threshold) multiplied by s: every
    rank coordinate scales by s while r and the LF structure stay, so the
    int64 oracle runs it exactly (the trick of tests/test_query_wide.py)."""
    from colbwt_tpu_torch.ops import oracle as O

    out = O.build_lf_table(np.asarray(tbl.char),
                           np.asarray(tbl.length, dtype=np.int64) * s)
    out.col_id = tbl.col_id
    out.threshold = (None if tbl.threshold is None
                     else np.asarray(tbl.threshold, dtype=np.int64) * s)
    out.bwt_r = tbl.bwt_r
    return out


def nbytes(*xs) -> int:
    """Bytes of the tensors and arrays in `xs` (dicts and tuples walked;
    other values count 0)."""
    total = 0
    for x in xs:
        if isinstance(x, dict):
            total += nbytes(*x.values())
        elif isinstance(x, (tuple, list)):
            total += nbytes(*x)
        elif hasattr(x, "nbytes"):
            total += int(x.nbytes)
    return total


def least_ms(nbytes: int, ops: int) -> tuple[float, str]:
    """The least time of work moving `nbytes` and doing `ops` integer
    operations, and which of the two sets it ("bytes", "operations")."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ALU_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def t1_bytes(index, c: int, s: int, C: int) -> int:
    """The bytes K1 must move for positions [s, s + C) and key char c:
    each element of the r-sized arrays that the chunk's runs need, read
    once, and its C 8-byte rows, written once.  The runs are those from
    the run of s to that of s + C - 1: their idx, char, pred, succ, col_id
    and lf_pos0; for the runs that do not match c, threshold and lf_pos0
    at their clamped successors and length and lf_pos0 at their clamped
    predecessors.  idx's C + 1 padding values are no part of it."""
    idx = np.asarray(index.idx, dtype=np.int64)
    r = idx.size
    lo, hi = np.searchsorted(idx, [s, s + C - 1], side="right") - 1
    runs = np.arange(lo, hi + 1)
    other = runs[np.asarray(index.char)[runs] != c]
    si = np.asarray(index.succ_jump[c], dtype=np.int64)[other]
    pi = np.asarray(index.pred_jump[c], dtype=np.int64)[other]
    succ = np.unique(np.minimum(si[si < r], r - 1))
    pred = np.unique(np.maximum(pi[pi >= 0], 0))
    lf = np.union1d(np.union1d(runs, succ), pred)
    return 4 * (5 * runs.size + lf.size + succ.size + pred.size) + 8 * C


def gathered(table, gathers: int, row_bytes: int) -> int:
    """The bytes a gather scan needs from `table`: its gathers' bytes, at
    most the whole table."""
    return min(nbytes(table), int(gathers) * row_bytes)


def mega_row_bytes(torch, pml, lane, first: int, second: int) -> int:
    """The table bytes a mega scan's steps need: each step the first
    `first` bytes of its row (what decides a match and its LF path), and a
    mismatched step `second` bytes more (the threshold and the succ/pred
    outcomes).  A lane walks the last `lane` columns of its row of the
    (B, M) plane `pml` (the plain version's); a walked column holds pml 0
    exactly where its step mismatched."""
    M = pml.shape[1]
    walked = torch.arange(M, device=pml.device) >= (M - lane)[:, None]
    mismatches = int(((pml == 0) & walked).sum())
    return int(lane.sum()) * first + mismatches * second


def cuda_ms(torch, fn, reps: int = 3, slow_s: float | None = None
            ) -> float:
    """Mean milliseconds per call on the current stream (one warm-up); a
    call whose warm-up took over `slow_s` seconds is timed by the warm-up
    alone, on the host's clock between two synchronisations."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    if slow_s is not None and warm_s > slow_s:
        return warm_s * 1e3
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def gpu_ms(torch, fn, reps: int = 3) -> float:
    """Mean milliseconds per call on the card alone: the calls are queued
    behind a sleep kernel, so the host has enqueued all of them before the
    card starts the first, and the CUDA events time them back to back (the
    sleep grows until the host wins).  Where `cuda_ms` of a small launch
    is the host's enqueue rate, this is the kernel's."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    cycles = 1 << 22
    while True:
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        late = start.query()  # the card reached the calls before the host
        torch.cuda.synchronize()
        if not late:
            return start.elapsed_time(end) / reps
        require(cycles < 1 << 36, "gpu_ms: the host never got ahead")
        cycles *= 4


class Checks:
    """Per-kernel max |kernel - plain|, the timed pair, the bound and the
    library call's time at the first timed shape; the scans' per-step times
    of their 16-lane calls, for the chain floors."""

    def __init__(self, torch):
        self.torch = torch
        self.err = {k: 0 for k in KERNEL_INFO}
        self.ms = {}
        self.step_ms = {}

    def equal(self, name: str, got, want, what: str) -> None:
        t = self.torch
        require(got is not None and want is not None
                and got.dtype == want.dtype and got.shape == want.shape,
                f"{name} {what}: dtype/shape {getattr(got, 'dtype', None)}"
                f"{tuple(getattr(got, 'shape', ()))} vs "
                f"{getattr(want, 'dtype', None)}"
                f"{tuple(getattr(want, 'shape', ()))}")
        u16 = got.dtype == t.uint16
        if u16:  # few ops take uint16: compare the bit patterns as int16
            got, want = got.view(t.int16), want.view(t.int16)
        diff = got != want  # a mask, not int64 copies: T4 is 8 GB
        err = 0
        if bool(diff.any()):
            g, w = got[diff].to(t.int64), want[diff].to(t.int64)
            if u16:
                g, w = g & 0xFFFF, w & 0xFFFF
            err = int((g - w).abs().max())
        self.err[name] = max(self.err[name], err)
        require(err == 0, f"{name} {what}: kernel differs from its plain "
                f"version (max abs err {err})")

    def time(self, name: str, kernel_fn, plain_fn, what: str,
             reps: int = 3, bound: tuple[int, int] | None = None,
             bound_ms: float | None = None,
             library_ms: float | None = None,
             chain: tuple[str, int, bool] | None = None) -> float:
        """Time the kernel and its plain version, and return the kernel's
        ms; `bound` is (bytes, integer operations) of the work, or
        `bound_ms` a measured least time;
        `library_ms` the time of one PyTorch call computing the same
        function.  A scan gives `chain` = (key, steps, lanes16): its longest
        lane's steps, and whether this is the key's 16-lane call, whose time
        a step (ms / steps, a chain of dependent loads that nothing hides)
        sets the key's; the others log their chain floor, steps times that
        time, the least time the longest lane's chain can take.  The first
        timed shape of each kernel goes in the JSON line."""
        ms = cuda_ms(self.torch, kernel_fn, reps)
        # a plain version of over 50 ms a call is timed by its first call
        # alone: the 16-lane chains take seconds, and repeats of the plain
        # versions cost about a minute of the smoke's 1,200 s
        plain = cuda_ms(self.torch, plain_fn, reps, slow_s=0.05)
        lib = library_ms
        by = "bytes"
        if bound is not None:
            bound_ms, by = least_ms(*bound)
        floor = ""
        if chain is not None:
            key, steps, lanes16 = chain
            if lanes16:
                self.step_ms[key] = ms / max(steps, 1)
                floor = (f", {ms / max(steps, 1) * 1e3:.4f} us a step of "
                         f"{steps} (the chain floor's step)")
            else:
                floor = (f", chain floor {steps * self.step_ms[key]:.4f} ms "
                         f"({steps} steps x "
                         f"{self.step_ms[key] * 1e3:.4f} us)")
        log(f"[time] {name} {what}: kernel {ms:.4f} ms, plain {plain:.4f} ms"
            + ("" if bound_ms is None else
               f", bound {bound_ms:.4f} ms ({by}"
               + (f", {bound[0]} B, {bound[1]} ops)" if bound else ")"))
            + floor
            + ("" if lib is None else f", library call {lib:.4f} ms"))
        if name not in self.ms and not (chain and chain[2]):
            require(bound_ms is not None,
                    f"{name}: the first timed shape needs its bound")
            self.ms[name] = {"ms": ms, "plain_ms": plain,
                             "bound_ms": bound_ms, "bound_by": by,
                             "library_ms": lib}
        return ms


def check_kernels(torch, dev, index, tbl, reads, n_reads, long_reads,
                  chk: Checks) -> None:
    from colbwt_tpu_torch.models.index import ColPmlIndex
    from colbwt_tpu_torch.models.tensors import index_tensors, to_device
    from colbwt_tpu_torch.ops import query_pos as TQ
    from colbwt_tpu_torch.ops import query_xla as TX

    n, A_full = index.n, index.sigma + 1
    digits = index.char_map[np.frombuffer(b"ACGT", np.uint8)]

    # K1: one full chunk (C = min(n, 2**25)) per char, then 2**20-position
    # chunks whose tail overlaps the chunk before it
    C = min(n, TQ._T1_CHUNK)
    a = TQ.t1_inputs(index, C, dev)
    full = {}
    for c in range(A_full):
        pred = to_device(index.pred_jump[c], dev)
        succ = to_device(index.succ_jump[c], dev)
        args = (a["char"], a["idx_pad"], a["length"], a["lf_pos0"],
                a["threshold"], pred, succ, a["col_id"], c, 0, 0, n, C)
        got = TQ.build_t1_chunk(torch.empty((n, 2), dtype=torch.int32,
                                            device=dev), *args)
        want = TQ.build_t1_chunk_ref(torch.empty((n, 2), dtype=torch.int32,
                                                 device=dev), *args)
        chk.equal("build_t1_chunk", got, want, f"char {c} C={C}")
        full[c] = got
        if c == int(digits[0]):
            buf = torch.empty((n, 2), dtype=torch.int32, device=dev)
            chk.time("build_t1_chunk",
                     lambda: TQ.build_t1_chunk(buf, *args),
                     lambda: TQ.build_t1_chunk_ref(buf, *args),
                     f"one chunk of C={C} positions",
                     bound=(t1_bytes(index, c, 0, C), C * 40))
    C2 = min(n, 1 << 20)
    a2 = TQ.t1_inputs(index, C2, dev)
    for c in (int(digits[0]), A_full - 1):
        pred = to_device(index.pred_jump[c], dev)
        succ = to_device(index.succ_jump[c], dev)
        got = torch.empty((n, 2), dtype=torch.int32, device=dev)
        want = torch.empty((n, 2), dtype=torch.int32, device=dev)
        for s in range(0, n, C2):
            s = min(s, n - C2)
            args = (a2["char"], a2["idx_pad"], a2["length"], a2["lf_pos0"],
                    a2["threshold"], pred, succ, a2["col_id"], c, s, s, n, C2)
            TQ.build_t1_chunk(got, *args)
            TQ.build_t1_chunk_ref(want, *args)
        chk.equal("build_t1_chunk", got, want, f"char {c} C={C2} with tail")
        chk.equal("build_t1_chunk", got, full[c], f"char {c} chunk-invariant")
    del full, a2

    # K2: T2 = T1.T1 and T4 = T2.T2 over ACGT keys
    t1 = TQ.build_t1(index, digits, a, C)
    t2 = TQ.compose_tables(t1, t1, n, 4, 1, 1)
    chk.equal("compose_tables", t2, TQ.compose_tables_ref(t1, t1, n, 4, 1, 1),
              "(1,1)")
    t4 = TQ.compose_tables(t2, t2, n, 4, 2, 2)
    chk.equal("compose_tables", t4, TQ.compose_tables_ref(t2, t2, n, 4, 2, 2),
              "(2,2)")
    torch.cuda.empty_cache()
    for ka, kb, ta, tb, made in ((2, 2, t2, t2, t4), (1, 1, t1, t1, t2)):
        rows = 4 ** (ka + kb) * n
        chk.time("compose_tables",
                 lambda: TQ.compose_tables(ta, tb, n, 4, ka, kb),
                 lambda: TQ.compose_tables_ref(ta, tb, n, 4, ka, kb),
                 f"({ka},{kb}): T{ka + kb} of {rows} rows", reps=10,
                 bound=(nbytes(ta, made) + (0 if tb is ta else nbytes(tb)),
                        rows * 10))
        torch.cuda.empty_cache()
    t3 = TQ.compose_tables(t2, t1, n, 4, 2, 1)
    tables = {1: t1, 2: t2, 3: t3, 4: t4}

    # K3: k = 1..4, unpacked and 2-bit packed digits, fresh and carried
    # state, at bench.py's scan shape (B = 262,144, M = 152; 156 at k = 3)
    dod = np.full(A_full + 1, -1, dtype=np.int32)
    dod[digits] = np.arange(4, dtype=np.int32)
    dig156, lens, bad = TQ._encode_digits(index, {"digit_of_dense": dod},
                                          reads, 156)
    require(not bad.any(), "bench reads must be pure ACGT")
    B = dig156.shape[0]
    rng = np.random.default_rng(0xC3)
    lens_t = to_device(lens, dev)
    fresh_pos = torch.full((B,), n - 1, dtype=torch.int32, device=dev)
    fresh_ml = torch.zeros((B,), dtype=torch.int32, device=dev)
    pos_c = to_device(rng.integers(0, n, B), dev)
    ml_c = to_device(rng.integers(0, 1000, B), dev)
    for k, tab in tables.items():
        M = 156 if k == 3 else 152
        dig = dig156[:, 156 - M:]
        for pack in (0, 2):
            pat = to_device(TQ.pack_digits(dig, 4)[0] if pack else dig, dev,
                            np.uint8)
            for fresh, packed_out in ((True, True), (True, False),
                                      (False, False), (False, True)):
                args = (tab, n, pat, lens_t,
                        fresh_pos if fresh else pos_c,
                        fresh_ml if fresh else ml_c, 0 if fresh else 4, k, 4)
                kw = dict(masked=not fresh, packed_out=packed_out,
                          fresh_state=fresh, pack=pack)
                (gp, gc), (gpos, gml) = TQ.query_chunk_pos(*args, **kw)
                (wp, wc), (wpos, wml) = TQ.query_chunk_pos_ref(*args, **kw)
                what = (f"k={k} pack={pack} fresh={fresh} "
                        f"packed_out={packed_out}")
                chk.equal("query_chunk_pos", gp, wp, what)
                if not packed_out:
                    chk.equal("query_chunk_pos", gc, wc, what)
                chk.equal("query_chunk_pos", gpos, wpos, what + " pos")
                chk.equal("query_chunk_pos", gml, wml, what + " mlen")
    # the long reads' first chunk as query_long_reads scans it (16 x 2,048,
    # masked, fresh state): the per-step time of K3's chain floors
    ldig, llens, lbad = TQ._encode_digits(index, {"digit_of_dense": dod},
                                          long_reads, 3 * 2048)
    require(not lbad.any(), "the long reads must be pure ACGT")
    L = len(long_reads)
    args = (t4, n, to_device(ldig[:, 4096:], dev, np.uint8),
            to_device(llens, dev), fresh_pos[:L], fresh_ml[:L], 0, 4, 4)
    kw = dict(masked=True)
    (gp, gc), (gpos, gml) = TQ.query_chunk_pos(*args, **kw)
    (wp, wc), (wpos, wml) = TQ.query_chunk_pos_ref(*args, **kw)
    what = f"k=4 long-read chunk {L}x2048 masked"
    for g, w, part in ((gp, wp, "pml"), (gc, wc, "cid"), (gpos, wpos, "pos"),
                       (gml, wml, "mlen")):
        chk.equal("query_chunk_pos", g, w, f"{what} {part}")
    steps = -(-np.minimum(llens, 2048) // 4)
    chk.time("query_chunk_pos", lambda: TQ.query_chunk_pos(*args, **kw),
             lambda: TQ.query_chunk_pos_ref(*args, **kw), what,
             bound=(nbytes(args[2:6], gp, gc, gpos, gml)
                    + gathered(t4, steps.sum(), 8), int(steps.sum()) * 20),
             chain=("query_chunk_pos k=4", int(steps.max()), True))
    # the main path's batch (8,192 reads padded to 252, 2-bit digits,
    # packed u16 plane) and bench.py's whole-set shape: checked, then timed
    dig252 = np.pad(dig156, ((0, 0), (96, 0)))
    for label, dg in (("main-path batch", dig252[:8192]),
                      ("bench set", dig156[:, 4:])):
        b = dg.shape[0]
        label = f"{label} {b}x{dg.shape[1]}"
        pat = to_device(TQ.pack_digits(dg, 4)[0], dev, np.uint8)
        args = (t4, n, pat, lens_t[:b].contiguous(), fresh_pos[:b],
                fresh_ml[:b], 0, 4, 4)
        kw = dict(packed_out=True, fresh_state=True, pack=2)
        (gp, _), (gpos, gml) = TQ.query_chunk_pos(*args, **kw)
        (wp, _), (wpos, wml) = TQ.query_chunk_pos_ref(*args, **kw)
        chk.equal("query_chunk_pos", gp, wp, f"k=4 {label}")
        chk.equal("query_chunk_pos", gpos, wpos, f"k=4 {label} pos")
        chk.equal("query_chunk_pos", gml, wml, f"k=4 {label} mlen")
        lane = np.ceil(np.minimum(lens[:b], dg.shape[1]) / 4)
        steps = int(lane.sum())
        chk.time("query_chunk_pos",
                 lambda: TQ.query_chunk_pos(*args, **kw),
                 lambda: TQ.query_chunk_pos_ref(*args, **kw),
                 f"k=4 {label}",
                 bound=(nbytes(args[2:6], gp, gpos, gml)
                        + gathered(t4, steps, 8), steps * 20),
                 chain=("query_chunk_pos k=4", int(lane.max()), False))
    del tables, t1, t2, t3, t4
    torch.cuda.empty_cache()

    # the general-T1 fallback that every read with an N takes on the main
    # path: T1 over all A_full chars, k = 1, dense ids (not digits),
    # unpacked, pml and cid planes, at the 252 columns of dispatch
    tg = TQ.build_t1(index, np.arange(A_full), a, C)
    enc, ln = index.encode_patterns(n_reads, 252)
    b = enc.shape[0]
    args = (tg, n, to_device(enc, dev, np.uint8), to_device(ln, dev),
            fresh_pos[:b], fresh_ml[:b], 0, 1, A_full)
    kw = dict(packed_out=False, fresh_state=True, pack=0)
    (gp, gc), (gpos, gml) = TQ.query_chunk_pos(*args, **kw)
    (wp, wc), (wpos, wml) = TQ.query_chunk_pos_ref(*args, **kw)
    what = f"general T1 k=1 A={A_full} {b}x252 N reads"
    chk.equal("query_chunk_pos", gp, wp, what + " pml")
    chk.equal("query_chunk_pos", gc, wc, what + " cid")
    chk.equal("query_chunk_pos", gpos, wpos, what + " pos")
    chk.equal("query_chunk_pos", gml, wml, what + " mlen")
    steps = int(np.minimum(ln, 252).sum())
    chk.time("query_chunk_pos", lambda: TQ.query_chunk_pos(*args, **kw),
             lambda: TQ.query_chunk_pos_ref(*args, **kw), what,
             bound=(nbytes(args[2:6], gp, gc, gpos, gml)
                    + gathered(tg, steps, 8), steps * 20))
    del tg, args
    torch.cuda.empty_cache()

    # K4: ff_bound 0 on the unsplit index; on a run-split index
    # (ColPmlIndex.build(tbl, ff_bound=2)) its recorded bound and 0
    t0 = time.perf_counter()
    split = ColPmlIndex.build(tbl, ff_bound=2)
    log(f"[index] run-split index for K4: r={split.r} ff_bound="
        f"{split.ff_bound} in {time.perf_counter() - t0:.1f}s")
    sample = reads[:8192 - 256] + n_reads[:256]
    # on the unsplit index also the long reads cut to their last 2,048
    # characters, the 16 lanes of K4's chain floor (the compact engine takes
    # long reads in one padded batch)
    long16 = (("16-lane", [x[-2048:] for x in long_reads], 2048),)
    for idx, ff in ((index, 0), (split, split.ff_bound), (split, 0)):
        tb = index_tensors(idx, dev)
        for label, batch, M in ((long16 if idx is index else ())
                                + (("main-path batch", sample, 256),)):
            enc, ln = idx.encode_patterns(batch, M)
            args = (tb, to_device(enc, dev), to_device(ln, dev))
            got = TX.query_batch_device(*args, ff_bound=ff)
            want = TX.query_batch_device_ref(*args, ff_bound=ff)
            what = f"r={idx.r} ff_bound={ff} {label} {len(batch)}x{M}"
            chk.equal("query_batch_xla", got[0], want[0], what + " pml")
            chk.equal("query_batch_xla", got[1], want[1], what + " cid")
            if idx is index:
                # the bound counts 40 B gathered a valid step (about ten
                # 4-byte gathers of the first-port design, the
                # fast-forward's data-dependent reads counted as one); the
                # kernel reads a 32-byte run row and an 8-byte pair a step,
                # two rows (64 B) more on a mismatch and a row's length a
                # fast-forward round past the first
                lane = np.minimum(ln, M)
                steps = int(lane.sum())
                chk.time("query_batch_xla",
                         lambda: TX.query_batch_device(*args, ff_bound=0),
                         lambda: TX.query_batch_device_ref(*args, ff_bound=0),
                         f"{label} {len(batch)}x{M}, unsplit, ff_bound=0",
                         reps=1 if len(batch) <= 16 else 3,
                         bound=(nbytes(args[1:], got)
                                + gathered(tb, steps, 40), steps * 30),
                         chain=("query_batch_xla unsplit", int(lane.max()),
                                len(batch) <= 16))
                if len(batch) <= 16:
                    log("[time] query_batch_xla chain floor reference: the "
                        "first-port design (nine 4-byte fields, four or "
                        "five dependent loads a step) took 1.8941 us a step "
                        "on these 16 lanes, 0.2860 ms for the main-path "
                        "batch's 151 steps, on an H100 80GB HBM3 at 700 W")
    torch.cuda.empty_cache()
    return split


def check_mega_kernels(torch, dev, mega_tbl, wide_tbl, reads, n_reads,
                       long_reads, chk: Checks):
    """Build the mega and mega-wide indexes from the scaled tables (saved
    for phases 6-7), then hold K5 and K6a-K6c equal to their plain versions
    at the shapes of those phases; returns the wide index."""
    from colbwt_tpu_torch.models.index import ColPmlIndex
    from colbwt_tpu_torch.models.tensors import to_device
    from colbwt_tpu_torch.ops import query_mega as TM
    from colbwt_tpu_torch.ops.query_mega_wide import wide_table_bytes
    from colbwt_tpu_torch.ops import query_mega_wide as TW

    t0 = time.perf_counter()
    mega = ColPmlIndex.build(mega_tbl, ff_bound=2)
    wide = ColPmlIndex.build(wide_tbl, ff_bound=2)
    require(not mega.wide and wide.wide, "scaled indexes: wrong width")
    mega.save(WORK / "mega.colpml")  # the CLI loads PREFIX.colpml.npz
    wide.save(WORK / "megawide.colpml")
    log(f"[index] scaled indexes in {time.perf_counter() - t0:.1f}s: mega "
        f"n={mega.n} r={mega.r} ff_bound={mega.ff_bound}; mega-wide "
        f"n={wide.n} r={wide.r} ff_bound={wide.ff_bound}; full wide table "
        f"{TW.wide_table_bytes(wide)} B")

    # K6b: every char block of both layouts; K6c: the shared table
    a = TW.run_arrays(wide, dev)
    meta = TW._meta(wide)
    rows = (wide.sigma + 1) * wide.r
    tables = {}
    for compact in (False, True):
        layout = "compact" if compact else "full"
        got = torch.empty((rows, 10 if compact else 16), dtype=torch.int32,
                          device=dev)
        want = torch.empty_like(got)
        for c in range(wide.sigma + 1):
            args = (c, a, to_device(wide.succ_jump[c], dev),
                    to_device(wide.pred_jump[c], dev), meta["n_lo"],
                    meta["n_hi"], wide.ff_bound, compact, c * wide.r)
            TW.fill_block(got, *args)
            TW.fill_block_ref(want, *args)
            if c == 0:
                args0 = args
        chk.equal("fill_block_wide", got, want,
                  f"{layout}, all {wide.sigma + 1} blocks")
        chk.time("fill_block_wide", lambda: TW.fill_block(got, *args0),
                 lambda: TW.fill_block_ref(want, *args0),
                 f"{layout} block c=0, {wide.r} rows",
                 bound=(nbytes(args0) + wide.r * got.shape[1] * 4,
                        wide.r * 40))
        tables[layout] = got
        del want
    shared = TW.shared_table(a)
    chk.equal("shared_table_wide", shared, TW.shared_table_ref(a),
              f"{wide.r} rows")
    chk.time("shared_table_wide", lambda: TW.shared_table(a),
             lambda: TW.shared_table_ref(a), f"{wide.r} rows",
             bound=(nbytes(a, shared), wide.r * 20))
    base = {"length": a["length"], **meta}
    scans = [("query_chunk_mega", "mega", mega,
              TM.build_mega_table(mega, device=dev), TM.query_chunk_mega,
              TM.query_chunk_mega_ref, TM.initial_state),
             ("query_chunk_mega_wide", "wide full", wide,
              {"mega": tables["full"], **base}, TW.query_chunk_mega_wide,
              TW.query_chunk_mega_wide_ref, TW.initial_state_wide),
             ("query_chunk_mega_wide", "wide compact", wide,
              {"shared": shared, "percha": tables["compact"], **base},
              TW.query_chunk_mega_wide, TW.query_chunk_mega_wide_ref,
              TW.initial_state_wide)]
    del tables, shared

    # K5, K6a: the long-read chunks (16 x 2,048, masked, int32 packed
    # plane, state carried from the chunks right of them): the second
    # (every lane full), its time a step the chain floors', and the third
    # (904 real columns a lane); the dispatch batch (8,192 reads, 255
    # columns, uint8, fresh state, u16 plane) masked, as the engines scan
    # it, and unmasked; K5 also with two planes
    sample = reads[:8192 - 256] + n_reads[:256]
    for name, label, idx, mt, kern, ref, init in scans:
        enc, ln = idx.encode_patterns(sample, 255)
        disp = (mt, to_device(enc, dev, np.uint8), to_device(ln, dev),
                init(mt, len(sample)), 0)
        enc, ln = idx.encode_patterns(long_reads, 3 * 2048)
        pat = to_device(enc, dev, np.uint8)
        lt = to_device(ln, dev)
        chunks, st = [], init(mt, len(long_reads))
        for j in range(3):
            lo = (2 - j) * 2048
            chunks.append((mt, pat[:, lo:lo + 2048].contiguous(), lt, st,
                           j * 2048))
            _, st = ref(*chunks[-1], ff_bound=idx.ff_bound, packed_out=True)
        long = dict(ff_bound=idx.ff_bound, masked=True, packed_out=True)
        fresh = dict(ff_bound=idx.ff_bound, masked=True, packed_out=True,
                     fresh_state=True)
        cases = [(f"{label} long-read chunk 16x2048 masked int32 "
                  f"step_offset 2048", chunks[1], long),
                 (f"{label} dispatch 8192x255 u16 masked (the engine's "
                  f"call)", disp, fresh),
                 (f"{label} dispatch 8192x255 u16 unmasked", disp,
                  dict(fresh, masked=False))]
        if name == "query_chunk_mega":
            cases.append((f"{label} dispatch 8192x255 two planes masked",
                          disp, dict(fresh, packed_out=False)))
        cases.append((f"{label} long-read chunk 16x2048 masked int32 "
                      f"step_offset 4096", chunks[2], long))
        for what, args, kw in cases:
            (gp, gc), gst = kern(*args, **kw)
            (wp, wc), wst = ref(*args, **kw)
            chk.equal(name, gp, wp, what)
            require((gc is None) == (wc is None), f"{name} {what}: planes")
            if gc is not None:
                chk.equal(name, gc, wc, what + " cid")
            for j, (g, w) in enumerate(zip(gst, wst)):
                chk.equal(name, g, w, f"{what} state[{j}]")
            # the steps the function takes: a masked lane its read's, an
            # unmasked one all M.  What they need: a walked column's
            # character, the lengths and state read, the planes and state
            # written, and a step's rows: the first 32 B of the 64-byte row
            # (narrow, wide full) or the 32-byte shared row (wide compact),
            # and on a mismatch the row's other 32 B or the 40-byte
            # per-char row
            M = args[1].shape[1]
            lane = ((args[2].long() - args[4]).clamp(0, M) if kw["masked"]
                    else torch.full_like(args[2], M, dtype=torch.int64))
            steps = int(lane.sum())
            pml = (wp.view(torch.int16).to(torch.int32) & 0xFFFF
                   if wp.dtype == torch.uint16 else wp)
            pml = pml if wc is not None else pml >> 8
            table_bytes = min(nbytes(args[0]), mega_row_bytes(
                torch, pml, lane, 32, 40 if "shared" in args[0] else 32)
                + steps * 4 * max(idx.ff_bound - 2, 0))
            chk.time(name, lambda: kern(*args, **kw),
                     lambda: ref(*args, **kw), what,
                     bound=(steps + nbytes(args[2:4], gp, gc, gst)
                            + table_bytes, steps * 25),
                     chain=(f"{name} {label}", int(lane.max()),
                            args[4] == 2048))
    del scans
    torch.cuda.empty_cache()
    return wide


def check_fused_kernels(torch, dev, tbl, split, reads, n_reads, long_reads,
                        chk: Checks) -> None:
    """K7 against its plain version at the fused path's shapes (the 16 x
    8,192 batch the long reads take, the dispatch batch, 8,192 x 256, and
    on the split the streamed batch, 32,768 x 256; uint8 ids as the engine
    uploads them) on the ff_bound 2 index `split` and on an ff_bound 1
    build; K14
    against the plain copy on jump_rows, with one pinned copy_ of the same
    bytes beside it.  Saves both indexes for phases 9-10."""
    from colbwt_tpu_torch.models.index import ColPmlIndex
    from colbwt_tpu_torch.models.tensors import to_device
    from colbwt_tpu_torch.ops import _kernels as K
    from colbwt_tpu_torch.ops import query_fused as TF
    from colbwt_tpu_torch.utils.xfer import (CHUNK_BYTES, upload_chunked,
                                             upload_chunked_ref)

    t0 = time.perf_counter()
    ff1 = ColPmlIndex.build(tbl, ff_bound=1)
    split.save(WORK / "fused.colpml")
    ff1.save(WORK / "fused1.colpml")
    log(f"[index] fused indexes: r={split.r} ff_bound={split.ff_bound}; "
        f"r={ff1.r} ff_bound={ff1.ff_bound} ({time.perf_counter() - t0:.1f}s)")

    # K14 on the largest table the fused path uploads
    _, jump_rows = TF.fused_rows(split)
    got = upload_chunked(jump_rows, dev)
    want = upload_chunked_ref(jump_rows, dev)
    chk.equal("upload_rows", got, want, f"jump_rows {jump_rows.shape}")
    pinned = torch.from_numpy(jump_rows).pin_memory()
    chk.equal("upload_rows", upload_chunked(pinned.numpy(), dev), want,
              "jump_rows from pinned memory")
    nb = jump_rows.nbytes
    pin_ms = cuda_ms(torch, lambda: got.copy_(pinned, non_blocking=True))
    page_ms = cuda_ms(torch, lambda: got.copy_(torch.from_numpy(jump_rows)))
    lib = K.on(dev)
    threads = lib.colbwt_upload_threads()
    stage_s = []
    for _ in range(3):  # the pool's memcpy into its pinned staging alone
        t0 = time.perf_counter()
        K.check("host_stage", lib.colbwt_host_stage(
            jump_rows.ctypes.data, nb, CHUNK_BYTES))
        stage_s.append(time.perf_counter() - t0)
    chk.time("upload_rows", lambda: upload_chunked(jump_rows, dev),
             lambda: upload_chunked_ref(jump_rows, dev),
             f"jump_rows {jump_rows.shape}, {nb} B, {threads} host threads, "
             f"2 MB slices (host memcpy alone {min(stage_s) * 1e3:.4f} ms = "
             f"{nb / min(stage_s) / 1e9:.1f} GB/s; one pinned copy_ "
             f"{pin_ms:.4f} ms = {nb / pin_ms / 1e6:.1f} GB/s; one pageable "
             f"copy_ {page_ms:.4f} ms = {nb / page_ms / 1e6:.1f} GB/s)",
             bound_ms=pin_ms, library_ms=pin_ms)
    del got, want, pinned

    # the long reads' batch first (its time a step the chain floors'), the
    # dispatch batch, and on the ff_bound 2 split the streamed one (S-E)
    sample = reads[:8192 - 256] + n_reads[:256]
    streamed = reads[:32768 - 256] + n_reads[:256]
    for idx in (split, ff1):
        ft = TF.build_fused_tables(idx, dev)
        for label, batch, M, reps in (
                ("long reads", long_reads, 8192, 1),
                ("dispatch", sample, 256, 3),
                ("streamed dispatch", streamed if idx is split else [], 256,
                 3)):
            if not batch:
                continue
            enc, ln = idx.encode_patterns(batch, M)
            args = (ft, to_device(enc, dev, np.uint8), to_device(ln, dev))
            kw = dict(ff_bound=idx.ff_bound)
            gp, gc = TF.query_batch_fused(*args, **kw)
            wp, wc = TF.query_batch_fused_ref(*args, **kw)
            what = (f"ff_bound={idx.ff_bound} r={idx.r} {label} "
                    f"{len(batch)}x{M}")
            chk.equal("query_batch_fused", gp, wp, what + " pml")
            chk.equal("query_batch_fused", gc, wc, what + " cid")
            # a run row and a jump row (32 B each) and ff_bound - 2 run
            # lengths a valid step (the first round's is in the run row)
            lane = np.minimum(ln, M)
            steps = int(lane.sum())
            chk.time("query_batch_fused",
                     lambda: TF.query_batch_fused(*args, **kw),
                     lambda: TF.query_batch_fused_ref(*args, **kw), what,
                     reps=reps,
                     bound=(nbytes(args[1:], gp, gc) + gathered(
                         ft, steps, 64 + 4 * max(idx.ff_bound - 2, 0)),
                         steps * 30),
                     chain=(f"query_batch_fused ff_bound={idx.ff_bound}",
                            int(lane.max()), len(batch) <= 16))
        del ft
    torch.cuda.empty_cache()


class Records(logging.Handler):
    """Collects the values a pipeline attaches to its log records."""

    def __init__(self, keys: tuple[str, ...]):
        super().__init__()
        self.keys = keys
        self.values: dict = {}

    def emit(self, record: logging.LogRecord) -> None:
        for key in self.keys:
            if hasattr(record, key):
                self.values[key] = getattr(record, key)


def write_reads(path: Path, records: list[tuple[str, bytes]]) -> None:
    with path.open("wb") as fh:
        fh.write(b"".join(b">" + name.encode() + b"\n" + seq + b"\n"
                          for name, seq in records))


def run_logged(call, logger_name: str, keys: tuple[str, ...]) -> dict:
    """Run `call()` (a CLI call returning its exit code) and collect the
    values the records of `logger_name` carry, with its wall time."""
    rec = Records(keys)
    logger = logging.getLogger(logger_name)
    logger.addHandler(rec)
    try:
        t0 = time.perf_counter()
        rc = call()
        rec.values["wall_s"] = time.perf_counter() - t0
    finally:
        logger.removeHandler(rec)
    require(rc == 0, f"{logger_name} call exited {rc}")
    return rec.values


def run_query(query) -> dict:
    return run_logged(query, "colbwt_torch.query", QUERY_KEYS)


def mega_phase(torch, tag: str, query, pat: Path, names: list[str],
               check, engine: str, needed: tuple[str, ...]):
    """One query of a mega path with launch counts reset just before it:
    the engine must be `engine`, every kernel in `needed` must have
    launched, and `check(pmls, cids)` checks the records.  Returns the
    metrics, the launch counts and the records."""
    from colbwt_tpu_torch.io.pml_out import read_pml_cid_binary
    from colbwt_tpu_torch.ops import _kernels as K

    K.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    v = run_query(query)
    launches = dict(K.launches)
    peak = torch.cuda.max_memory_allocated()
    require(v.get("engine") == engine,
            f"phase {tag} engine {v.get('engine')}, expected {engine}")
    for name in needed:
        require(launches[name] > 0, f"{name} never launched in phase {tag}")
    got_names, pmls = read_pml_cid_binary(f"{pat}.split.pml.bin")
    _, cids = read_pml_cid_binary(f"{pat}.split.cid.bin")
    require(got_names == names, f"phase {tag}: record names/order differ")
    t0 = time.perf_counter()
    what = check(pmls, cids)
    m = {"engine": v["engine"], "reads": len(names), "read_s": v["read_s"],
         "table_cache": v.get("table_cache"),
         "table_build_s": v["table_build_s"],
         "table_save_s": v["table_save_s"], "scan_s": v["scan_s"],
         "write_s": v["write_s"], "query_wall_s": v["wall_s"],
         "reads_per_s": len(names) / v["wall_s"],
         "scan_reads_per_s": len(names) / v["scan_s"],
         "device_mem_peak_bytes": peak}
    log(f"[phase {tag}] engine {v['engine']}: {len(names)} reads, table "
        f"build {v['table_build_s']:.3f}s (cache: "
        f"{json.dumps(v.get('table_cache'))}, save {v['table_save_s']:.3f}s)"
        f", scan {v['scan_s']:.3f}s, query "
        f"wall {v['wall_s']:.3f}s -> {m['reads_per_s']:.0f} reads/s (scan "
        f"only {m['scan_reads_per_s']:.0f} reads/s), device memory peak {peak} "
        f"B; {what} ({time.perf_counter() - t0:.1f}s); launches "
        f"{json.dumps(launches)}")
    return m, launches, pmls, cids


def stream_phase(torch, tag: str, query, pat: Path, ref: Path, engine: str,
                 needed: tuple[str, ...], one_shot_reads_per_s: float
                 ) -> tuple[dict, dict]:
    """One `query --stream` with launch counts reset just before it: the
    engine must be `engine`, every kernel in `needed` must have launched,
    and its two files must be byte-equal to the one-shot query's of
    `ref`.  Returns the metrics and the launch counts."""
    from colbwt_tpu_torch.ops import _kernels as K

    K.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    v = run_logged(query, "colbwt_torch.stream", STREAM_KEYS)
    launches = dict(K.launches)
    require(v.get("engine") == engine,
            f"phase {tag} engine {v.get('engine')}, expected {engine}")
    for name in needed:
        require(launches[name] > 0, f"{name} never launched in phase {tag}")
    for ext in ("pml", "cid"):
        require(same_bytes(f"{pat}.split.{ext}.bin",
                           f"{ref}.split.{ext}.bin"),
                f"phase {tag}: .split.{ext}.bin differs from {ref.name}'s")
    m = {"engine": v["engine"], "reads": v["reads"],
         "table_cache": v.get("table_cache"),
         "table_build_s": v["table_build_s"], "query_wall_s": v["wall_s"],
         "reads_per_s": v["reads"] / v["wall_s"],
         "one_shot_reads_per_s": one_shot_reads_per_s,
         "device_mem_peak_bytes": torch.cuda.max_memory_allocated()}
    log(f"[phase {tag}] --stream, engine {v['engine']}: {v['reads']} reads "
        f"in {v['wall_s']:.3f}s -> {m['reads_per_s']:.0f} reads/s (phase "
        f"4's one-shot query {one_shot_reads_per_s:.0f} reads/s), table "
        f"build {v['table_build_s']:.3f}s, device memory peak "
        f"{m['device_mem_peak_bytes']} B; files byte-equal to {ref.name}'s; "
        f"launches {json.dumps(launches)}")
    return m, launches


class Capture:
    """While active, keeps the arrays build_pipeline hands to the device
    multi-MUM scan (ops/construct.find_multi_mums): (ranks, sa, lcp,
    doc_ids), for the host checks on the build's own arrays."""

    def __enter__(self):
        from colbwt_tpu_torch.ops import construct as TC

        self.args = None
        self.real = TC.find_multi_mums

        def capture(ranks, sa, lcp, doc_ids, *a, **kw):
            self.args = (ranks, sa, lcp, doc_ids)
            return self.real(ranks, sa, lcp, doc_ids, *a, **kw)

        TC.find_multi_mums = capture
        return self

    def __exit__(self, *exc):
        from colbwt_tpu_torch.ops import construct as TC

        TC.find_multi_mums = self.real
        return False


class FirstCalls:
    """While active, counts the calls of module.name by the shapes of
    their tensor arguments and keeps the arguments of each shape's first
    call, to time the kernel at the shapes a run gave it."""

    def __init__(self, module: str, name: str):
        import importlib

        self.module, self.name = importlib.import_module(module), name

    def __enter__(self):
        self.real = getattr(self.module, self.name)
        self.first, self.count = {}, {}

        def spy(*args, **kw):
            key = (tuple(tuple(a.shape) for a in args if hasattr(a, "shape"))
                   + tuple(a for a in args if isinstance(a, int))
                   + tuple(sorted(kw.items())))
            self.first.setdefault(key, (args, kw))
            self.count[key] = self.count.get(key, 0) + 1
            return self.real(*args, **kw)

        setattr(self.module, self.name, spy)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.real)
        return False


class TimedCalls:
    """While active, keeps the arguments of every call of module.name and
    a pair of CUDA events recorded around it, to time each launch a run
    made where it made it."""

    def __init__(self, torch, module: str, name: str):
        import importlib

        self.torch = torch
        self.module, self.name = importlib.import_module(module), name

    def __enter__(self):
        self.real = getattr(self.module, self.name)
        self.calls = []

        def spy(*args, **kw):
            ev = [self.torch.cuda.Event(enable_timing=True)
                  for _ in range(2)]
            ev[0].record()
            out = self.real(*args, **kw)
            ev[1].record()
            self.calls.append((args, kw, ev))
            return out

        setattr(self.module, self.name, spy)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.real)
        return False

    def ms(self) -> list[float]:
        """Each call's milliseconds between its events."""
        self.torch.cuda.synchronize()
        return [ev[0].elapsed_time(ev[1]) for _, _, ev in self.calls]


def time_stream_scans(torch, k3: FirstCalls, launches: int, chk: Checks,
                      cell: str = "S-A") -> None:
    """K3 at each shape a streamed query of `cell` gave it (S-A: batches of
    32,768 reads, the N reads' general-T1 batch, the long reads' chunks):
    held to its plain version, timed, with each shape's launches and, where
    its k's 16-lane step was timed, its chain floor."""
    import inspect

    from colbwt_tpu_torch.ops import query_pos as TQ

    require(sum(k3.count.values()) == launches,
            f"{cell}: {sum(k3.count.values())} K3 calls seen, "
            f"{launches} launches counted")
    sig = inspect.signature(TQ.query_chunk_pos)
    for key, (args, kw) in k3.first.items():
        a = sig.bind(*args, **kw)
        a.apply_defaults()
        a = a.arguments
        got = TQ.query_chunk_pos(*args, **kw)
        want = TQ.query_chunk_pos_ref(*args, **kw)
        for g, w in zip((*got[0], *got[1]), (*want[0], *want[1])):
            if w is not None:
                chk.equal("query_chunk_pos", g, w, f"{cell} shape {key}")
        pats, k, off = a["patterns"], a["k"], a["step_offset"]
        B = pats.shape[0]
        M = pats.shape[1] * 8 // a["pack"] if a["pack"] else pats.shape[1]
        lane = (torch.clamp(a["lengths"].long() - off, 0, M) + k - 1) // k
        steps = int(lane.sum())
        floor = f"query_chunk_pos k={k}"
        chk.time("query_chunk_pos",
                 lambda: TQ.query_chunk_pos(*args, **kw),
                 lambda: TQ.query_chunk_pos_ref(*args, **kw),
                 f"{cell}: {k3.count[key]} launches of {B} x {M}, k={k}"
                 f"{', masked' if a['masked'] else ''}"
                 f"{f', step offset {off}' if off else ''}",
                 bound=(nbytes(pats, a["lengths"], a["pos0"], a["mlen0"],
                               got) + gathered(a["table"], steps, 8),
                        steps * 20),
                 chain=((floor, int(lane.max()), False)
                        if floor in chk.step_ms else None))


def run_build(tag: str, call, needed: tuple[str, ...]) -> tuple[dict, dict]:
    """One build with launch counts reset just before it: every kernel in
    `needed` must have launched.  Returns the stage seconds and counts its
    log records carry, and the launch counts."""
    from colbwt_tpu_torch.ops import _kernels as K

    K.reset_launches()
    v = run_logged(call, "colbwt_torch.build", BUILD_KEYS)
    launches = dict(K.launches)
    for name in needed:
        require(launches[name] > 0, f"{name} never launched in phase {tag}")
    log(f"[phase {tag}] build: " + json.dumps(v) + "; launches "
        + json.dumps(launches))
    return v, launches


def write_col_files(out: Path, bits: np.ndarray, ids: np.ndarray, n: int
                    ) -> None:
    from colbwt_tpu_torch.io import formats as F

    bv = np.zeros(n, dtype=bool)
    bv[bits] = True
    F.write_sdsl_bit_vector(f"{out}.col_runs", bv)
    F.write_col_ids(f"{out}.col_ids", ids, 1, 8)


def same_bytes(a: str, b: str) -> bool:
    return Path(a).read_bytes() == Path(b).read_bytes()


def host_col_split(prefix: str, mode: str, out: Path) -> float:
    """The host walk of `mode` on the MUMs of PREFIX.fa.col_mums with the
    shared interval sweep, written to OUT.col_runs/.col_ids (split rate 10,
    8-bit ids); returns its seconds."""
    from colbwt_tpu_torch.io import formats as F
    from colbwt_tpu_torch.ops import oracle as O
    from colbwt_tpu_torch.ops.colruns_vec import (find_col_runs_mixed,
                                                  find_col_runs_uniform)
    from colbwt_tpu_torch.ops import colsplit as TCS

    heads, lens = F.read_rlbwt(f"{prefix}.fa")
    num_docs, ml, mp = F.read_col_mums(f"{prefix}.fa.col_mums")
    t0 = time.perf_counter()
    fl = O.build_fl_table(heads, lens)
    walk = (TCS.col_split_tunneled_numpy if mode == "tunnels"
            else TCS.col_split_all_numpy)
    mpos, mids, mhts = walk(fl, ml, mp, num_docs, 10, 8)
    if mhts.size and (mhts == mhts[0]).all():
        bits, ids = find_col_runs_uniform(mpos, mids, int(mhts[0]),
                                          fl.l_heads, fl.n)
    else:
        bits, ids = find_col_runs_mixed(mpos, mids, mhts, fl.l_heads, fl.n)
    secs = time.perf_counter() - t0
    write_col_files(out, bits, ids, fl.n)
    for ext in ("col_runs", "col_ids"):
        require(same_bytes(f"{out}.{ext}", f"{prefix}.fa.{ext}"),
                f"{prefix}.fa.{ext} differs from the host {mode} walk")
    return secs


def host_lane(prefix: str, arrays, num_docs: int) -> dict:
    """Phase 3's host lane on the build's own arrays: O.find_multi_mums
    must reproduce .col_mums, and the host tunnels walk with the shared
    sweep .col_runs/.col_ids, byte for byte.  Returns their seconds."""
    from colbwt_tpu_torch.io import formats as F
    from colbwt_tpu_torch.ops import oracle as O

    ranks, sa, lcp, doc_ids = arrays
    t0 = time.perf_counter()
    ml, mp = O.find_multi_mums(ranks, sa, lcp, doc_ids, num_docs, 20)
    mums_s = time.perf_counter() - t0
    _, dml, dmp = F.read_col_mums(f"{prefix}.fa.col_mums")
    require(np.array_equal(ml, dml) and np.array_equal(mp, dmp),
            "device multi-MUMs differ from O.find_multi_mums")
    colsplit_s = host_col_split(prefix, "tunnels", WORK / "host_tunnels")
    return {"mums_s": mums_s, "colsplit_s": colsplit_s, "mums": int(ml.size)}


def scan_inputs(arrays) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(lcp int32, per-rank document ids, run-change marks) as
    ops/construct.find_multi_mums derives them."""
    ranks, sa, lcp, doc_ids = arrays
    prev_rank = np.asarray(ranks)[sa - 1]
    run_change = np.ones(sa.size, dtype=np.uint8)
    run_change[1:] = prev_rank[1:] != prev_rank[:-1]
    return (np.asarray(lcp, dtype=np.int32),
            np.asarray(doc_ids)[sa].astype(np.int32), run_change)


def check_chunks(torch, dev, arrays, num_docs: int, C: int, chk: Checks,
                 what: str, name: str = "mum_window", timed: bool = True,
                 min_mum: int = 20) -> None:
    """mum_window equal to its plain version on every chunk of C positions
    (the slices find_multi_mums_chunked feeds it), its route's errors kept
    under `name`; the first and the last (the tail) are timed."""
    from colbwt_tpu_torch.ops import construct as TC

    lcp, sa_docs, rc = scan_inputs(arrays)
    n, N = lcp.size, num_docs
    halo = 2 * N + 2

    def sl(a, s, fill, dtype):
        x = a[s:s + C + halo].astype(dtype)
        return torch.from_numpy(np.concatenate(
            [x, np.full(C + halo - x.size, fill, dtype)])).to(dev)

    last = (n - 1) // C
    for k, s in enumerate(range(0, n, C)):
        args = (sl(lcp, s, 0, np.int32), sl(sa_docs, s, 65535, np.uint16),
                sl(rc, s, 1, np.uint8), min(n - N - s, C), min_mum, N)
        label = (f"{what} chunk {k} of {last + 1} (C = {C}, N = {N}, uint16 "
                 f"documents, {min(n - s, C)} positions in range)")
        got = TC.mum_scan_chunk(*args)
        want = TC.mum_scan_chunk_ref(*args)
        chk.equal(name, got[0], want[0], label + " hits")
        chk.equal(name, got[1], want[1], label + " ell")
        if timed and k in (0, last):
            chk.time(name, lambda: TC.mum_scan_chunk(*args),
                     lambda: TC.mum_scan_chunk_ref(*args), label,
                     bound=(nbytes(args[:3], got), args[3] * 6 * N))
        del got, want, args
    torch.cuda.empty_cache()


def check_build_kernels(torch, dev, prefix: str, arrays, chk: Checks
                        ) -> None:
    """K8-K10b against their plain versions at bench's shapes: the K9
    route over the whole array, K8 over four chunks of 2**20 (whose hits
    must equal the one-shot scan's), and both walks on the first bucket of
    bench's MUMs."""
    from colbwt_tpu_torch.io import formats as F
    from colbwt_tpu_torch.ops import oracle as O
    from colbwt_tpu_torch.ops import colsplit as TCS
    from colbwt_tpu_torch.ops import construct as TC

    num_docs, ml, mp = F.read_col_mums(f"{prefix}.fa.col_mums")
    lcp, sa_docs, rc = scan_inputs(arrays)
    prev_rank = np.asarray(arrays[0])[arrays[1] - 1].astype(np.int32)
    n = lcp.size
    t = [torch.from_numpy(a).to(dev) for a in (lcp, sa_docs, prev_rank)]
    got = TC.multi_mum_scan(*t, num_docs, 20)
    want = TC.multi_mum_scan_ref(*t, num_docs, 20)
    what = f"K9 route, n = {n}, N = {num_docs}"
    chk.equal("mum_window", got[0], want[0], what + " is_mum")
    chk.equal("mum_window", got[1], want[1], what + " ell")
    # the kernel alone on the padded array, then the wrapper around it
    padded = TC.pad_whole_array(*t, num_docs)
    args = (*padded, n - num_docs, 20, num_docs)
    packed, ell = TC.mum_scan_chunk(*args)
    kernel_ms = chk.time(
        "mum_window", lambda: TC.mum_scan_chunk(*args),
        lambda: TC.mum_scan_chunk_ref(*args),
        f"{what}: the kernel on the whole array padded as one chunk (int32 "
        "documents)", bound=(nbytes(padded, packed, ell), n * 6 * num_docs))
    wrapper_ms = cuda_ms(torch, lambda: TC.multi_mum_scan(*t, num_docs, 20))
    pad_ms = cuda_ms(torch, lambda: TC.pad_whole_array(*t, num_docs))
    unpack_ms = cuda_ms(torch, lambda: TC.unpackbits_little(packed, n))
    log(f"[time] mum_window {what}, multi_mum_scan: {wrapper_ms:.4f} ms = "
        f"the kernel {kernel_ms:.4f} + padding copies {pad_ms:.4f} + "
        f"unpackbits_little {unpack_ms:.4f} (each timed alone)")
    del got, want, t, padded, args, packed, ell
    check_chunks(torch, dev, arrays, num_docs, 1 << 20, chk, "bench")
    # the large-N route, its switch lowered, on bench's chunks (timed at
    # config #3's in phase 14)
    tile_max = TC._TILE_MAX_N
    TC._TILE_MAX_N = 1
    try:
        check_chunks(torch, dev, arrays, num_docs, 1 << 20, chk,
                     "bench, the large-N route (two passes),",
                     "mum_window_two_pass", timed=False)
    finally:
        TC._TILE_MAX_N = tile_max
    cl, cp = TC.find_multi_mums_chunked(lcp, sa_docs, rc, num_docs, 20,
                                        chunk=1 << 20, device=dev)
    require(np.array_equal(cl, ml) and np.array_equal(cp, mp),
            "K8 over chunks of 2**20 differs from the one-shot scan")

    heads, lens = F.read_rlbwt(f"{prefix}.fa")
    fl = O.build_fl_table(heads, lens)
    fd = TCS.fl_tensors(fl, dev)
    order = np.argsort(mp, kind="stable")
    ls = ml[order]
    sel = next(TCS.buckets(ls, np.argsort(ls, kind="stable"), True,
                           num_docs, 1 << 24))
    T = int(ls[sel].max())
    p0 = torch.from_numpy(mp[order][sel].astype(np.int32)).to(dev)
    lt = torch.from_numpy(ls[sel].astype(np.int32)).to(dev)
    what = f"first bucket, {sel.size} of {ml.size} MUMs, T = {T}"
    fl_arrays = [fd[f] for f in TCS.FL_FIELDS]
    rows_ms = cuda_ms(torch, lambda: TCS.walk_rows(fd), 20)
    log(f"[time] walk_rows (K10a's rows, PyTorch ops) r = {fl.r}: "
        f"{rows_ms:.4f} ms; fast-forward rows a step on the {what}: "
        + json.dumps(forward_rows(torch, fd, p0, T)))
    # K10a's chain floor first: 16 of the bucket's MUMs, all T steps
    a16 = (fd, p0[:16].contiguous(), lt[:16].contiguous(), T, 10, num_docs)
    for j, (g, w) in enumerate(zip(TCS.tunneled_walk(*a16),
                                   TCS.tunneled_walk_ref(*a16))):
        chk.equal("tunneled_walk", g, w, f"16 MUMs, output {j}")
    chk.time("tunneled_walk", lambda: TCS.tunneled_walk(*a16),
             lambda: TCS.tunneled_walk_ref(*a16),
             f"16 MUMs of the first bucket x T = {T}, rate 10, N = "
             f"{num_docs}", reps=20, chain=("tunneled_walk", T, True))
    # K10b's: the bucket's 16 longest MUMs (a walker moves only while t <
    # its MUM's length)
    b16 = (fd, p0[-16:].contiguous(), lt[-16:].contiguous(),
           int(lt[-16:].max()), 10, num_docs)
    for j, (g, w) in enumerate(zip(TCS.all_walk(*b16),
                                   TCS.all_walk_ref(*b16))):
        chk.equal("all_walk", g, w, f"16 longest MUMs, output {j}")
    chk.time("all_walk", lambda: TCS.all_walk(*b16),
             lambda: TCS.all_walk_ref(*b16),
             f"the first bucket's 16 longest MUMs x T = {b16[3]}, rate 10, "
             f"N = {num_docs}", reps=20, chain=("all_walk", b16[3], True))
    for name, kern, ref, rate in (
            ("tunneled_walk", TCS.tunneled_walk, TCS.tunneled_walk_ref, 10),
            ("all_walk", TCS.all_walk, TCS.all_walk_ref, 10)):
        got = kern(fd, p0, lt, T, rate, num_docs)
        want = ref(fd, p0, lt, T, rate, num_docs)
        for j, (g, w) in enumerate(zip(got, want)):
            chk.equal(name, g, w, f"{what}, rate {rate}, output {j}")
        walkers = sel.size * (num_docs if name == "all_walk" else 1)
        chk.time(name, lambda: kern(fd, p0, lt, T, rate, num_docs),
                 lambda: ref(fd, p0, lt, T, rate, num_docs),
                 f"{what}, rate {rate}, N = {num_docs}",
                 bound=(nbytes(fl_arrays, p0, lt, got), walkers * T * 100),
                 chain=(name, T, False))
    torch.cuda.empty_cache()


def forward_rows(torch, fd: dict, p0, num_steps: int) -> dict:
    """The rows K10a's fast-forward reads a step on this walk (the plain
    walk's positions, each step's destination run clip(dest_interval) to
    the run holding the next position), with PyTorch ops on the walk's
    device: their mean and maximum over the steps that fast-forward, and
    the share of steps that search instead (a run before the destination,
    or more than the kernel's 8 rows)."""
    from colbwt_tpu_torch.ops import colsplit as TCS

    idx = fd["idx"]
    r = idx.shape[0]
    p = p0
    total = count = worst = searched = 0
    for _ in range(num_steps):
        i = (torch.searchsorted(idx, p, right=True) - 1).clamp(0, r - 1)
        dest = fd["dest_interval"][i].long().clamp(0, r - 1)
        p = TCS.fl_unit_ref(fd, p)
        j = (torch.searchsorted(idx, p, right=True) - 1).clamp(0, r - 1)
        f = j - dest
        ok = (f >= 0) & (f <= 8)
        total += int(f[ok].sum())
        count += int(ok.sum())
        worst = max(worst, int(f[ok].max()) if bool(ok.any()) else 0)
        searched += int((~ok).sum())
    return {"mean": total / max(count, 1), "max": worst,
            "searched": searched / max(count + searched, 1)}


def check_build_walks(torch, walks: TimedCalls, launches: int,
                      chk: Checks, cell: str = "B8") -> None:
    """K10a at the buckets a build of `cell` gave it: each launch's time in
    the build, its outputs against the plain version's, its fast-forward
    rows; the first bucket timed against its plain version."""
    from colbwt_tpu_torch.ops import colsplit as TCS

    require(len(walks.calls) == launches,
            f"{cell}: {len(walks.calls)} K10a calls, {launches} launches")
    build_ms = walks.ms()
    for j, ((fd, p0, lens, T, rate, N), _, _) in enumerate(walks.calls):
        ms = build_ms[j]
        what = (f"{cell} bucket {j + 1} of {len(walks.calls)}, {p0.shape[0]} "
                f"MUMs x T = {T}, rate {rate}, N = {N}, "
                f"r = {fd['idx'].shape[0]}")
        got = TCS.tunneled_walk(fd, p0, lens, T, rate, N)
        want = TCS.tunneled_walk_ref(fd, p0, lens, T, rate, N)
        for g, w, part in zip(got, want, ("pos", "valid")):
            chk.equal("tunneled_walk", g, w, f"{what} {part}")
        log(f"[time] tunneled_walk {what}: {ms:.4f} ms in the build; "
            f"fast-forward rows a step "
            + json.dumps(forward_rows(torch, fd, p0, T)))
        if j == 0:
            chk.time("tunneled_walk",
                     lambda: TCS.tunneled_walk(fd, p0, lens, T, rate, N),
                     lambda: TCS.tunneled_walk_ref(fd, p0, lens, T, rate, N),
                     what, bound=(nbytes([fd[f] for f in TCS.FL_FIELDS],
                                         p0, lens, got),
                                  p0.shape[0] * T * 100))
        del got, want
    walks.calls.clear()
    torch.cuda.empty_cache()


def pair_keys(torch, rank, k: int, lo_bits: int):
    """The packed keys K11a sorts, as int64: rank[i] << lo_bits |
    (rank[i + k] + 1, or 0 past the end)."""
    r = rank.to(torch.int64)
    nxt = torch.zeros_like(r)
    if k < r.shape[0]:
        nxt[:r.shape[0] - k] = r[k:] + 1
    return (r << lo_bits) | nxt


def check_sa_kernels(torch, dev, prefix: str, arrays, chk: Checks) -> None:
    """K11a on every round of bench's suffix array, K11b on its pyramid and
    K12 on every character of its BWT, against their plain versions at
    bench's shapes; the suffix array, LCP and thresholds also against the
    native SA-IS and Kasai arrays phase 3 built with, and its .thr_pos."""
    from colbwt_tpu_torch.io import formats as F
    from colbwt_tpu_torch.ops import construct as TC
    from colbwt_tpu_torch.ops import oracle as O

    ranks, sa_native, lcp_native, _ = arrays
    n = ranks.size
    r0 = torch.from_numpy(ranks.astype(np.int32)).to(dev)
    ws = TC.DoublingWorkspace(n, dev)
    rank, max_rank, k, pyramid, sa = r0, int(ranks.max()), 1, [], None
    rounds = []  # (input ranks, k, their largest rank, order, packed passes)
    for rnd in range(1, int(np.ceil(np.log2(n))) + 1):
        # as suffix_array runs it: the previous order, one workspace
        got = TC.doubling_round(rank, k, max_rank, sa, ws)
        want = TC.doubling_round_ref(rank, k)
        for j, (g, w) in enumerate(zip(got, want)):
            chk.equal("doubling_round", g, w, f"round {rnd} (k = {k}) "
                      f"output {j}")
        if sa is not None and rnd <= 3:  # the kernel's own argsort
            for j, (g, w) in enumerate(zip(
                    TC.doubling_round(rank, k, max_rank), want)):
                chk.equal("doubling_round", g, w, f"round {rnd} (k = {k}) "
                          f"output {j}, no order given")
        lo_bits = (max_rank + 1).bit_length()
        rounds.append((rank, k, max_rank, sa,
                       -(-(max_rank.bit_length() + lo_bits) // 8)))
        sa, rank, top = got
        pyramid.append(rank)
        max_rank, k = int(top), 2 * k
        if max_rank == n - 1:
            break
    require(np.array_equal(sa.cpu().numpy(), sa_native),
            "K11a's suffix array differs from native SA-IS")
    R = len(pyramid)
    # timed: the first round whose packed keys were the widest (the most
    # passes of PR 5's design), as suffix_array runs it
    packed = max(r[4] for r in rounds)
    rnd = next(j for j, r in enumerate(rounds) if r[4] == packed)
    rank_in, k_in, top_in, order_in, _ = rounds[rnd]
    passes = TC.key_passes(top_in)
    keys = pair_keys(torch, rank_in, k_in, (top_in + 1).bit_length())
    lib = cuda_ms(torch, lambda: torch.sort(keys, stable=True))
    lib32 = cuda_ms(torch, lambda: torch.sort(rank_in, stable=True))
    chk.time("doubling_round",
             lambda: TC.doubling_round(rank_in, k_in, top_in, order_in, ws),
             lambda: TC.doubling_round_ref(rank_in, k_in),
             f"round {rnd + 1} of {R}, n = {n}, k = {k_in}, {passes} radix "
             f"passes of 8 bits ({packed} for PR 5's packed key), "
             f"{TC.round_launches(passes, True)} launches a round; stable "
             f"torch.sort of the 32-bit ranks {lib32:.4f} ms",
             bound=(12 * n + 4, 8 * packed * n), library_ms=lib)
    for rank_in, k_in, top_in, order_in, pk in rounds:
        ms = cuda_ms(torch, lambda: TC.doubling_round(rank_in, k_in, top_in,
                                                      order_in, ws))
        extra = ""
        if k_in == 2:  # the one-pass round: its plain and library times
            keys = pair_keys(torch, rank_in, k_in, (top_in + 1).bit_length())
            plain = cuda_ms(torch, lambda: TC.doubling_round_ref(rank_in,
                                                                 k_in))
            lib = cuda_ms(torch, lambda: torch.sort(keys, stable=True))
            lib32 = cuda_ms(torch, lambda: torch.sort(rank_in, stable=True))
            extra = (f", plain {plain:.4f} ms, stable torch.sort of PR 5's "
                     f"packed keys ({pk} bytes) {lib:.4f} ms, of the 32-bit "
                     f"ranks {lib32:.4f} ms")
        log(f"[time] doubling_round k = {k_in}: "
            f"{TC.key_passes(top_in)} passes, {ms:.4f} ms{extra}")
    del keys, rounds, ws
    lcp = TC.lcp_from_pyramid(r0, sa, pyramid)
    chk.equal("lcp_lift", lcp, TC.lcp_from_pyramid_ref(r0, sa, pyramid),
              f"n = {n}, R = {R}")
    require(np.array_equal(lcp.cpu().numpy(), lcp_native),
            "K11b's LCP differs from native Kasai")
    chk.time("lcp_lift", lambda: TC.lcp_from_pyramid(r0, sa, pyramid),
             lambda: TC.lcp_from_pyramid_ref(r0, sa, pyramid),
             f"n = {n}, R = {R}", bound=lcp_bound(n, R))
    del pyramid, rank

    heads, lens = F.read_rlbwt(f"{prefix}.fa")
    check_argmin(torch, dev, lcp, heads, lens, chk, "bench")
    thr = TC.compute_thresholds(heads, lens, lcp_native, device=dev)
    require(np.array_equal(thr, O.compute_thresholds_fast(heads, lens,
                                                          lcp_native))
            and np.array_equal(thr, F.read_thresholds_file(
                f"{prefix}.fa.thr_pos")),
            "K12's thresholds differ from O.compute_thresholds_fast")
    torch.cuda.empty_cache()


def check_argmin(torch, dev, lcp, heads, lens, chk: Checks, what: str
                 ) -> None:
    """K12 on every character's threshold segments of (heads, lens) against
    its plain version, then timed as compute_thresholds calls it: the five
    calls together (one workspace), then each character's call apart, the
    terminator's first; bound 4 bytes a covered position and 24 a
    segment."""
    from colbwt_tpu_torch.ops import construct as TC

    norm = TC.normalize_heads(heads)
    segs = [(int(norm[runs[0]]), torch.from_numpy(lo).to(dev),
             torch.from_numpy(hi).to(dev))
            for runs, lo, hi in TC.threshold_segments(heads, lens)]
    ws = TC.ArgminWorkspace(lcp.shape[0], dev)
    for c, lo, hi in segs:
        chk.equal("segmented_argmin", TC.segmented_argmin(lcp, lo, hi, ws),
                  TC.segmented_argmin_ref(lcp, lo, hi),
                  f"{what}, character {c}, {lo.shape[0]} segments")
    for picked in [segs] + [[sg] for sg in segs]:
        covered = sum(int((hi - lo + 1).sum()) for _, lo, hi in picked)
        m = sum(lo.shape[0] for _, lo, _ in picked)
        longest = max(int((hi - lo).max()) + 1 for _, lo, hi in picked)
        label = (f"{len(segs)} characters" if len(picked) > 1
                 else f"character {picked[0][0]}")
        chk.time("segmented_argmin",
                 lambda: [TC.segmented_argmin(lcp, lo, hi, ws)
                          for _, lo, hi in picked],
                 lambda: [TC.segmented_argmin_ref(lcp, lo, hi)
                          for _, lo, hi in picked],
                 f"{what}, {label}: {m} segments over {covered} positions "
                 f"(longest {longest}), {len(picked)} calls of two launches",
                 bound=(4 * covered + 24 * m, 4 * covered))


def window_conditions(arrays, starts: np.ndarray, N: int, min_mum: int
                      ) -> tuple[np.ndarray, np.ndarray]:
    """The oracle's window test (colbwt_tpu/ops/oracle.py:390-403) at the
    given window starts, vectorised: (is multi-MUM, ell)."""
    ranks, sa, lcp, doc_ids = arrays
    starts = np.asarray(starts, dtype=np.int64)
    lcp_ext = np.r_[np.asarray(lcp, dtype=np.int64), 0]
    off = np.arange(N)
    win = starts[:, None] + off[None, :]
    ell = lcp_ext[win[:, 1:]].min(axis=1)
    uniq = (lcp_ext[starts] < ell) & (lcp_ext[starts + N] < ell)
    docs = np.sort(np.asarray(doc_ids)[sa[win]], axis=1)
    distinct = (docs[:, 1:] != docs[:, :-1]).all(axis=1)
    pc = np.asarray(ranks)[sa[win] - 1]
    left_max = (pc != pc[:, :1]).any(axis=1)
    return (ell >= min_mum) & uniq & distinct & left_max, ell


def pangenome_docs() -> list[bytes]:
    """Phase 8's haplotypes, made as bench.make_docs makes its own: one
    random base sequence and random substitutions per haplotype."""
    n_haps, length, subs = PANGENOME
    rng = np.random.default_rng(0xB11D)
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    base = rng.choice(acgt, length)
    docs = []
    for _ in range(n_haps):
        a = base.copy()
        a[rng.integers(0, length, subs)] = rng.choice(acgt, subs)
        docs.append(a.tobytes())
    return docs


def phase8(torch, dev, cli_main, chk: Checks) -> tuple[dict, dict]:
    """The build path at full size on the pangenome, then its checks."""
    from colbwt_tpu_torch.io import formats as F
    from colbwt_tpu_torch.io.pml_out import read_pml_cid_binary
    from colbwt_tpu_torch.ops import oracle as O

    t0 = time.perf_counter()
    docs = pangenome_docs()
    fastas = []
    for i, d in enumerate(docs):
        fastas.append(str(WORK / f"pan{i}.fa"))
        write_reads(Path(fastas[-1]), [(f"hap{i}", d)])
    prefix = str(WORK / "pangenome")
    N = len(docs)
    log(f"[phase 8] {N} haplotypes of {len(docs[0])} bp made in "
        f"{time.perf_counter() - t0:.1f}s")
    with Capture() as cap, TimedCalls(
            torch, "colbwt_tpu_torch.ops.colsplit", "tunneled_walk") as walks:
        v, launches = run_build("8", lambda: cli_main(
            ["build", "-o", prefix, "-m", "tunnels", "-s", "10", "-l", "20",
             "--device", str(dev), *fastas]),
            ("mum_window", "tunneled_walk"))
    require(cap.args is not None, "phase 8 did not run the device scan")
    check_build_walks(torch, walks, launches["tunneled_walk"], chk)
    n = cap.args[1].size
    require(n > 1 << 26, f"phase 8 n = {n} must exceed 2**26")
    # the chunk size find_multi_mums_chunked takes at this n
    C = min(1 << 26, 1 << max(13, (n - 1).bit_length()))
    check_chunks(torch, dev, cap.args, N, C, chk, "pangenome")

    t0 = time.perf_counter()
    _, ml, mp = F.read_col_mums(f"{prefix}.fa.col_mums")
    rng = np.random.default_rng(0x8C8C)
    pick = rng.choice(mp.size, min(256, mp.size), replace=False)
    ok, ell = window_conditions(cap.args, mp[pick], N, 20)
    require(ok.all() and np.array_equal(ell, ml[pick]),
            "reported MUMs fail the oracle's window conditions")
    cand = rng.integers(0, n - N + 1, 150_000)
    cand = np.unique(cand[~np.isin(cand, mp)])[:100_000]
    require(cand.size == 100_000, "too few unreported window starts")
    ok, _ = window_conditions(cap.args, cand, N, 20)
    require(not ok.any(), f"{int(ok.sum())} unreported window starts pass "
            "the oracle's window conditions")
    spot_s = time.perf_counter() - t0
    del cap
    log(f"[phase 8] n={n}: {ml.size} multi-MUMs; the oracle's window "
        f"conditions agree on {pick.size} reported and {cand.size} "
        f"unreported starts ({spot_s:.1f}s)")

    reads = []
    for i in range(2000):
        d = docs[int(rng.integers(N))]
        s = int(rng.integers(0, len(d) - 150))
        arr = bytearray(d[s:s + 150])
        if i % 2:
            arr[int(rng.integers(150))] = int(rng.choice(list(b"ACGT")))
        reads.append((f"p{i}", bytes(arr)))
    pat = WORK / "pangenome_reads.fa"
    write_reads(pat, reads)
    q = run_query(lambda: cli_main(["query", prefix, "-p", str(pat),
                                           "--device", str(dev)]))
    names, pmls = read_pml_cid_binary(f"{pat}.split.pml.bin")
    _, cids = read_pml_cid_binary(f"{pat}.split.cid.bin")
    require(names == [r[0] for r in reads], "phase 8 query names differ")
    tbl = load_table(prefix)
    for i in rng.choice(len(reads), 64, replace=False):
        ep, ec = O.query_pml_oracle(tbl, reads[i][1])
        require(np.array_equal(pmls[i], ep) and np.array_equal(cids[i], ec),
                f"phase 8 record {reads[i][0]} differs from the oracle")
    log(f"[phase 8] query of {len(reads)} reads (engine "
        f"{q.get('engine')}, {q['wall_s']:.3f}s): 64 sampled "
        "records equal the oracle")
    v["n"] = int(n)
    v["query_wall_s"] = q["wall_s"]
    return v, launches


def phase8bc(dev, cli_main, fastas: list[str], bench_prefix: str
             ) -> tuple[dict, list[dict]]:
    """Bench's collection through the chunked SA lane (8b) and in all mode
    (8c), held against phase 3's artifacts and the host all-mode walk."""
    v, launches = {}, []
    pre_b = str(WORK / "bench_chunked")
    v["8b"], lc = run_build("8b", lambda: cli_main(
        ["build", "-o", pre_b, "-m", "tunnels", "-s", "10", "-l", "20",
         "--sa-mode", "chunked", "--chunk-chars", "1000000", "--keep",
         "--device", str(dev), *fastas]), ("mum_window", "tunneled_walk"))
    launches.append(lc)
    for ext in ARTIFACTS:
        require(same_bytes(f"{pre_b}.{ext}", f"{bench_prefix}.{ext}"),
                f"phase 8b: .{ext} differs from phase 3's")
    require(same_index(f"{pre_b}.colpml.npz", f"{bench_prefix}.colpml.npz"),
            "phase 8b: the index differs from phase 3's")
    log(f"[phase 8b] chunked SA lane: {len(ARTIFACTS)} artifacts and the "
        "index byte-equal to phase 3's")

    pre_c = str(WORK / "bench_all")
    v["8c"], lc = run_build("8c", lambda: cli_main(
        ["build", "-o", pre_c, "-m", "all", "-s", "10", "-l", "20",
         "--device", str(dev), *fastas]), ("mum_window", "all_walk"))
    launches.append(lc)
    v["8c"]["host_colsplit_s"] = host_col_split(pre_c, "all",
                                                WORK / "host_all")
    log("[phase 8c] all mode: .col_runs and .col_ids byte-equal to the "
        "host col_split_all_numpy")
    return v, launches


class NoNative:
    """While active, the port sees no native library (every caller asks
    colbwt_tpu_torch.io.native.available), as on a host without native/:
    the FASTA reader parses in Python and stage_mums takes the device
    suffix array."""

    def __enter__(self):
        from colbwt_tpu_torch.io import native

        self.real = native.available
        native.available = lambda: False
        return self

    def __exit__(self, *exc):
        from colbwt_tpu_torch.io import native

        native.available = self.real
        return False


def same_index(a: str, b: str) -> bool:
    za, zb = np.load(a), np.load(b)
    return (sorted(za.files) == sorted(zb.files)
            and all(np.array_equal(za[k], zb[k]) for k in za.files))


def phase11(dev, cli_main, fastas: list[str], bench_prefix: str,
            v3: dict) -> tuple[dict, dict]:
    """Bench's collection through the CLI build without the native
    library: every artifact and the index byte-equal to phase 3's."""
    pre = str(WORK / "bench_nonative")
    with NoNative():
        v, launches = run_build("11", lambda: cli_main(
            ["build", "-o", pre, "-m", "tunnels", "-s", "10", "-l", "20",
             "--keep", "--device", str(dev), *fastas]),
            ("doubling_round", "lcp_lift", "mum_window", "tunneled_walk"))
    for ext in ARTIFACTS:
        require(same_bytes(f"{pre}.{ext}", f"{bench_prefix}.{ext}"),
                f"phase 11: .{ext} differs from phase 3's")
    require(same_index(f"{pre}.colpml.npz", f"{bench_prefix}.colpml.npz"),
            "phase 11: the index differs from phase 3's")
    v["rounds"] = launches["doubling_round"]
    log(f"[phase 11] no native library: {len(ARTIFACTS)} artifacts and "
        f"the index byte-equal to phase 3's; {v['rounds']} doubling rounds, "
        f"sa_lcp_s {v['sa_lcp_s']:.3f} on the card against phase 3's "
        f"{v3['sa_lcp_s']:.3f} (native SA-IS + Kasai)")
    return v, launches


def phase11b(torch, dev, pan_prefix: str, v8: dict, chk: Checks
             ) -> tuple[dict, dict]:
    """Phase 8's pangenome through stage_mums without the native library
    (the full-size device suffix array): its four artifacts byte-equal to
    phase 8's; then its sa_lcp_s split into K11a's rounds, K11b, copies
    and host, K11b held to its plain version at this n."""
    from colbwt_tpu_torch.ops import _kernels as K
    from colbwt_tpu_torch.pipeline import build as TB
    from colbwt_tpu_torch.utils.config import ColBwtConfig, SplitMode
    from colbwt_tpu_torch.utils.log import get_logger

    docs = pangenome_docs()
    pre = str(WORK / "pangenome_nonative")
    cfg = ColBwtConfig(mode=SplitMode.TUNNELS, split_rate=10, min_mum=20)
    logger = get_logger("colbwt_torch.build")

    def stage():
        TB.stage_mums(docs, pre, cfg, logger, dev)
        return 0

    K.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    with NoNative():
        v = run_logged(stage, "colbwt_torch.build", BUILD_KEYS)
    launches = dict(K.launches)
    for name in ("doubling_round", "lcp_lift", "mum_window"):
        require(launches[name] > 0, f"{name} never launched in phase 11b")
    for ext in ("fa.bwt.heads", "fa.bwt.len", "fa.thr_pos", "fa.col_mums"):
        require(same_bytes(f"{pre}.{ext}", f"{pan_prefix}.{ext}"),
                f"phase 11b: .{ext} differs from phase 8's")
    v["rounds"] = launches["doubling_round"]
    v["device_mem_peak_bytes"] = torch.cuda.max_memory_allocated()
    log(f"[phase 11b] stage_mums without the native library, n = "
        f"{v8['n']}: .bwt.heads, .bwt.len, .thr_pos, .col_mums byte-equal "
        f"to phase 8's; {v['rounds']} doubling rounds, sa_lcp_s "
        f"{v['sa_lcp_s']:.3f} on the card against phase 8's "
        f"{v8['sa_lcp_s']:.3f} (native SA-IS + Kasai), device memory peak "
        f"{v['device_mem_peak_bytes']} B; " + json.dumps(v)
        + "; launches " + json.dumps(launches))
    v["sa_lcp_split"] = sa_lcp_split(torch, dev, docs, v["sa_lcp_s"], chk,
                                     pan_prefix)
    return v, launches


def lcp_bound(n: int, R: int) -> tuple[int, int]:
    """K11b's (bytes, operations): sa, the inverse suffix array (the top
    level) and ranks0 read once, lcp written once.  Its probes past the
    text-side one depend on the data and are not counted; the operations
    are the parent's descending lift, which do not set the bound."""
    return 16 * n, 10 * (R + 1) * n


def sa_lcp_split(torch, dev, docs: list[bytes], sa_lcp_s: float,
                 chk: Checks, pan_prefix: str) -> dict:
    """stage_mums's suffix array and LCP on the card once more at phase
    11b's n, as pipeline/build.py runs them (suffix_array, lcp_from_pyramid
    on the int64 ranks, lcp and sa copied back), each part synchronised and
    timed on the host clock in this one run: the ranks' int32 cast on the
    host and their upload, the K11a rounds (each with its read-back of the
    largest rank), the second upload (the int64 ranks, cast on the card),
    K11b, the copies of lcp and sa back; host is the run's wall less those
    parts.  Then each round is timed alone (with its radix passes and
    bound), K11b is held to its plain version and timed, and K12 at this
    lcp and phase 8's RLBWT (`pan_prefix`): held to its plain version and
    timed (check_argmin), its thresholds equal to phase 8's .thr_pos.
    Returns the split in seconds."""
    from colbwt_tpu_torch.io import formats as F
    from colbwt_tpu_torch.ops import construct as TC
    from colbwt_tpu_torch.ops import oracle as O

    ranks = O.concat_collection(docs)[1]
    n = ranks.size
    part = dict.fromkeys(("cast_s", "ranks_up_s", "rounds_s",
                          "ranks_up_again_s", "lcp_lift_s", "lcp_down_s",
                          "sa_down_s"), 0.0)

    def timed(key, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        part[key] += time.perf_counter() - t
        return out

    torch.cuda.synchronize()
    t_run = time.perf_counter()
    r32 = timed("cast_s", lambda: ranks.astype(np.int32))
    r0 = timed("ranks_up_s", lambda: torch.from_numpy(r32).to(dev))
    ws = TC.DoublingWorkspace(n, dev)
    rank, max_rank, k, pyramid, sa = r0, int(ranks.max()), 1, [], None
    rounds = []  # (input ranks, k, their largest rank, order)
    for _ in range(max(1, int(np.ceil(np.log2(n))))):
        rounds.append((rank, k, max_rank, sa))
        sa, rank, top = timed("rounds_s", lambda: TC.doubling_round(
            rank, k, max_rank, sa, ws))
        pyramid.append(rank)
        max_rank, k = timed("rounds_s", lambda: int(top)), 2 * k
        if max_rank == n - 1:
            break
    r0_again = timed("ranks_up_again_s", lambda: TC._int32_on(ranks, dev))
    lcp = timed("lcp_lift_s",
                lambda: TC.lcp_from_pyramid(r0_again, sa, pyramid))
    timed("lcp_down_s", lambda: lcp.cpu().numpy())
    timed("sa_down_s", lambda: sa.cpu().numpy())
    wall = time.perf_counter() - t_run
    del r0_again
    split = dict(part, wall_s=wall, host_s=wall - sum(part.values()))
    rounds_ms = []
    for j, (rank_in, k_in, top_in, order_in) in enumerate(rounds):
        ms = cuda_ms(torch, lambda: TC.doubling_round(rank_in, k_in, top_in,
                                                      order_in, ws))
        passes = TC.key_passes(top_in)
        bound = (12 * n + 4) / HBM_BYTES_PER_S * 1e3
        rounds_ms.append(ms)
        log(f"[time] doubling_round n = {n}, round {j + 1} of "
            f"{len(rounds)} (k = {k_in}): {passes} radix passes of 8 bits, "
            f"{TC.round_launches(passes, order_in is not None)} launches, "
            f"{ms:.4f} ms, bound {bound:.4f} ms (bytes, {12 * n + 4} B)")
    # the library call beside K11a's last (widest) round: one stable
    # torch.sort of its packed pair keys, and of the 32-bit ranks
    rank_in, k_in, top_in, _ = rounds[-1]
    keys = pair_keys(torch, rank_in, k_in, (top_in + 1).bit_length())
    lib = cuda_ms(torch, lambda: torch.sort(keys, stable=True))
    lib32 = cuda_ms(torch, lambda: torch.sort(rank_in, stable=True))
    log(f"[time] doubling_round n = {n}, round {len(rounds)} (k = {k_in}): "
        f"{rounds_ms[-1]:.4f} ms; library call, stable torch.sort of the "
        f"packed pair keys {lib:.4f} ms, of the 32-bit ranks {lib32:.4f} ms")
    del rounds, ws, keys
    R = len(pyramid)
    chk.equal("lcp_lift", lcp, TC.lcp_from_pyramid_ref(r0, sa, pyramid),
              f"n = {n}, R = {R}")
    lcp_ms = chk.time("lcp_lift",
                      lambda: TC.lcp_from_pyramid(r0, sa, pyramid),
                      lambda: TC.lcp_from_pyramid_ref(r0, sa, pyramid),
                      f"n = {n}, R = {R} (phase 11b)",
                      bound=lcp_bound(n, R))
    del sa, pyramid, rank, r0
    torch.cuda.empty_cache()
    heads, lens = F.read_rlbwt(f"{pan_prefix}.fa")
    check_argmin(torch, dev, lcp, heads, lens, chk, "pangenome")
    require(np.array_equal(
        TC.compute_thresholds(heads, lens, lcp, device=dev),
        F.read_thresholds_file(f"{pan_prefix}.fa.thr_pos")),
        "phase 11b: K12's thresholds differ from phase 8's .thr_pos")
    del lcp
    torch.cuda.empty_cache()
    split["rounds_warm_s"] = sum(rounds_ms) / 1e3
    split["lcp_lift_warm_s"] = lcp_ms / 1e3
    copies = (split["ranks_up_s"] + split["ranks_up_again_s"]
              + split["lcp_down_s"] + split["sa_down_s"])
    log(f"[phase 11b] suffix array + LCP as stage_mums runs them, n = {n}, "
        f"one run of {wall:.4f} s (the build's sa_lcp_s {sa_lcp_s:.4f} s): "
        f"{len(rounds_ms)} K11a rounds {split['rounds_s']:.4f} s (timed "
        f"alone {split['rounds_warm_s']:.4f}), K11b "
        f"{split['lcp_lift_s']:.4f} s (timed alone "
        f"{split['lcp_lift_warm_s']:.4f}), copies {copies:.4f} s (ranks up "
        f"{split['ranks_up_s']:.4f} as int32 and again "
        f"{split['ranks_up_again_s']:.4f} as int64, lcp down "
        f"{split['lcp_down_s']:.4f}, sa down {split['sa_down_s']:.4f}), "
        f"host {split['cast_s'] + split['host_s']:.4f} s (the int32 cast "
        f"{split['cast_s']:.4f}, the rest {split['host_s']:.4f}: allocation, "
        f"Python); " + json.dumps(split))
    return split


def phase11c(torch, dev, docs: list[bytes], tbl3) -> tuple[dict, dict]:
    """bench.py's index-build sequence (bench.py:83-98) through the port's
    ops without the native library, thresholds by K12: the table equal to
    phase 3's field by field and the ff_bound-2 index to phase 3's."""
    import dataclasses

    from colbwt_tpu_torch.models.index import ColPmlIndex
    from colbwt_tpu_torch.ops import _kernels as K
    from colbwt_tpu_torch.ops import colsplit as TCS
    from colbwt_tpu_torch.ops import construct as TC
    from colbwt_tpu_torch.ops import oracle as O

    N = len(docs)
    K.reset_launches()
    v = {}
    with NoNative():
        t0 = time.perf_counter()
        text, ranks, doc_ids = O.concat_collection(docs)
        sa_t, _, pyr = TC.suffix_array(ranks, with_pyramid=True, device=dev)
        lcp = TC.lcp_from_pyramid(ranks, sa_t, pyr).cpu().numpy()
        sa = sa_t.cpu().numpy()
        del sa_t, pyr
        v["sa_lcp_s"] = time.perf_counter() - t0
        heads, lens = O.rle(O.bwt_from_sa(text, sa))
        fl = O.build_fl_table(heads, lens)
        ml, mp = TC.find_multi_mums(ranks, sa, lcp, doc_ids, N, 20,
                                    device=dev)
        mpos, mids, mhts = TCS.col_split(fl, ml, mp, N, 10, "tunnels",
                                         device=dev)
        bits, ids = O.find_col_runs_oracle(mpos, mids, mhts, fl.l_heads,
                                           fl.n)
        t1 = time.perf_counter()
        thr = TC.compute_thresholds(heads, lens, lcp, device=dev)
        v["thresholds_s"] = time.perf_counter() - t1
        tbl = O.build_col_pml(heads, lens, bits, ids, thr)
        index = ColPmlIndex.build(tbl, ff_bound=2)
        v["sequence_s"] = time.perf_counter() - t0
    launches = dict(K.launches)
    for name in ("doubling_round", "lcp_lift", "mum_window", "tunneled_walk",
                 "segmented_argmin"):
        require(launches[name] > 0, f"{name} never launched in phase 11c")
    for f in dataclasses.fields(tbl):
        a, b = getattr(tbl, f.name), getattr(tbl3, f.name)
        require((a is None) == (b is None)
                and (a is None or np.array_equal(a, b)),
                f"phase 11c: table field {f.name} differs from phase 3's")
    index.save(WORK / "bench_sequence.colpml")
    require(same_index(str(WORK / "bench_sequence.colpml.npz"),
                       str(WORK / "fused.colpml.npz")),
            "phase 11c: the ff_bound-2 index differs from phase 3's")
    t0 = time.perf_counter()
    O.compute_thresholds_fast(heads, lens, lcp)
    v["host_thresholds_s"] = time.perf_counter() - t0
    log(f"[phase 11c] bench.py's build sequence without the native "
        f"library: table equal to phase 3's field by field, index to phase "
        f"3's ff_bound-2 split; " + json.dumps(v) + "; launches "
        + json.dumps(launches))
    return v, launches


def clone_args(torch, args, shared=()):
    """Tensors cloned, tuples walked, anything else as it is; the arguments
    at the positions `shared` (read-only tables) are kept as they are."""
    def clone(a):
        if isinstance(a, torch.Tensor):
            return a.clone()
        return tuple(clone(x) for x in a) if isinstance(a, tuple) else a

    return tuple(a if j in shared else clone(a) for j, a in enumerate(args))


class Twins:
    """While active, each wrapped kernel wrapper (a module attribute) runs
    as itself, and with `check` also as its plain version on clones of its
    arguments: its result (or each tensor of a tuple it returns) and every
    tensor argument (the outputs it writes in place) must then be equal.
    Keeps clones of the arguments of call number `nth` (from 0) of each
    (kernel, tag, key) for the timings."""

    def __init__(self, torch, chk: Checks, check: bool):
        self.torch, self.chk, self.check = torch, chk, check
        self.tag = ""
        self.calls: dict = {}
        self.first: dict = {}
        self.undo = []

    def _run(self, name: str, args: tuple, kern, ref, key, shared, nth):
        """One call of kernel `name` with the public arguments `args`:
        `kern()` launches it."""
        torch = self.torch
        k = (name, self.tag, key(args))
        self.calls[k] = self.calls.get(k, -1) + 1
        if self.calls[k] == nth:
            self.first[k] = clone_args(torch, args, shared)
        if not self.check:
            return kern()
        twins = clone_args(torch, args, shared)
        out = kern()
        want = ref(*twins)
        pairs = (list(zip(out, want)) if isinstance(out, tuple)
                 else [(out, want)])
        for a, b in zip(args, twins):
            pairs += (list(zip(a, b)) if isinstance(a, tuple)
                      else [(a, b)])
        for a, b in pairs:
            if isinstance(a, torch.Tensor) and a is not b:
                self.chk.equal(name, a, b, f"{self.tag} call")
        return out

    def wrap(self, module, name: str, ref, key=lambda args: None,
             shared=(), nth: int = 8) -> None:
        kern = getattr(module, name)

        def both(*args):
            return self._run(name, args, lambda: kern(*args), ref, key,
                             shared, nth)

        setattr(module, name, both)
        self.undo.append((module, name, kern))

    def wrap_launcher(self, module, cls: str, name: str, ref,
                      key=lambda args: None, shared=(), nth: int = 8
                      ) -> None:
        """As `wrap`, for a launcher class (module.cls, prepared once, a
        call per launch): each call is held and captured as kernel `name`
        with the public function's arguments, `launcher.args(*call)`."""
        base = getattr(module, cls)
        tw = self

        class Twin(base):
            def __call__(self, *call):
                return tw._run(name, self.args(*call),
                               lambda: base.__call__(self, *call), ref, key,
                               shared, nth)

        setattr(module, cls, Twin)
        self.undo.append((module, cls, base))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        for module, name, kern in reversed(self.undo):
            setattr(module, name, kern)
        return False


def phase12(torch, dev, index, wide, batch: list[bytes],
            long_reads: list[bytes], ref4, ref7, chk: Checks
            ) -> tuple[dict, list[dict]]:
    """The sharded query API on the card, the ip shards as separate tensors
    on cuda:0.  `batch` is phase 4's 263,168 reads of <= 152 bp, `ref4` and
    `ref7` phase 4's and phase 7's (pmls, cids) of all its records.  Each
    engine runs once with launch counts reset just before it (and held to
    the counts its route gives), its outputs held to the single-card
    engine's; the per-step route of the mega engines (the route of shards
    on other cards) runs once, narrow and wide, on the (1, 2) mesh.  Then
    every engine runs again with every kernel call held to its plain
    version.  Returns the walls and the launch counts."""
    from colbwt_tpu_torch.models.index import ColPmlIndex
    from colbwt_tpu_torch.ops import _kernels as K
    from colbwt_tpu_torch.ops import query_mega as TM
    from colbwt_tpu_torch.ops.query_mega_wide import wide_table_bytes
    from colbwt_tpu_torch.ops import query_pos as TQ
    from colbwt_tpu_torch.ops import query_xla as TX
    from colbwt_tpu_torch.parallel import make_mesh
    from colbwt_tpu_torch.parallel import mesh as PM
    from colbwt_tpu_torch.parallel import query_sharded as TS
    from colbwt_tpu_torch.parallel import query_sharded_mega as TSM
    from colbwt_tpu_torch.parallel import query_sharded_mega_wide as TSW
    from colbwt_tpu_torch.parallel import query_sharded_pos as TSP

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    split = ColPmlIndex.load(WORK / "fused.colpml.npz")
    B = len(batch)
    M = max(len(x) for x in batch)
    launches, walls = [], {}

    def mesh(dp, ip):
        return make_mesh(dp, ip, devices=["cuda:0"] * (dp * ip))

    def twins(check: bool) -> Twins:
        tw = Twins(torch, chk, check)
        # the fetch and the per-step kernels launch through launchers made
        # once a chunk (Fetch, RoundCompact, StepMega, StepPos); each call
        # is held and captured with its public function's arguments
        tw.wrap_launcher(PM, "Fetch", "sharded_fetch", PM.sharded_fetch_ref,
                         key=lambda a: (next(t for t in a[0] if t is not None
                                             ).shape[1], a[2] is None,
                                        a[1].shape[0]))
        tw.wrap_launcher(TS, "RoundCompact", "sharded_step_compact",
                         TS.sharded_step_compact_ref, key=lambda a: a[0])
        tw.wrap(TS, "sharded_scan_compact", TS.sharded_scan_compact_ref,
                key=lambda a: tuple(a[3].shape), nth=0)
        tw.wrap_launcher(TSM, "StepMega", "sharded_step_mega",
                         TSM.sharded_step_mega_ref,
                         key=lambda a: a[0].shape[0], shared=(1,))
        tw.wrap(TSM, "sharded_scan_mega", TSM.sharded_scan_mega_ref,
                key=lambda a: tuple(a[7].shape), shared=(0, 2), nth=0)
        tw.wrap_launcher(TSP, "StepPos", "sharded_step_pos",
                         TSP.sharded_step_pos_ref)
        tw.wrap(TSP, "sharded_scan_pos", TSP.sharded_scan_pos_ref,
                key=lambda a: tuple(a[2].shape), shared=(0,), nth=0)
        tw.wrap(TSP, "compose_sharded_tk", TSP.compose_sharded_tk_ref,
                shared=(0,), nth=0)
        # K1, six launches a table build (the buffer the only output)
        tw.wrap(TQ, "build_t1_chunk", TQ.build_t1_chunk_ref,
                shared=tuple(range(1, 9)), nth=0)
        return tw

    def pos_step_route():
        """Every sharded-pos row through the per-step route `step_row`,
        the route of a row whose shards sit on other cards."""
        return mock.patch.object(TSP, "scan_row", TSP.step_row)

    def step_route():
        """Every sharded mega chunk through the per-step route
        `step_chunk`, the route of a row whose shards sit on other cards."""
        return mock.patch.object(TSM, "scan_chunk", TSM.step_chunk)

    def round_route():
        """Every sharded compact row through the per-round route
        `round_row`, the route of a row whose shards sit on other cards."""
        return mock.patch.object(TS, "scan_row", TS.round_row)

    def counted(tw: Twins, tag: str, want: dict, fn):
        """Run fn with launch counts reset; every kernel of `want` must
        have launched (its count, where one is given; None: any > 0)."""
        tw.tag = tag
        K.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        walls[tag] = time.perf_counter() - t0
        if tag in CELLS_G:
            log(f"[time] {CELLS_G[tag]} wall: {walls[tag]:.4f} s")
        lc = dict(K.launches)
        for name, n in want.items():
            require(lc[name] > 0 if n is None else lc[name] == n,
                    f"phase 12 {tag}: {name} launched {lc[name]} times, "
                    f"expected {'> 0' if n is None else n}")
        launches.append(lc)
        log(f"[phase 12] {tag}: {walls[tag]:.3f}s; launches "
            + json.dumps({k: v for k, v in lc.items() if v}))
        return out

    def same(got, ref, lo: int, hi: int, what: str) -> None:
        (gp, gc), (wp, wc) = got, ref
        require([len(x) for x in gp] == [len(x) for x in wp[lo:hi]]
                and np.array_equal(np.concatenate(gp),
                                   np.concatenate(wp[lo:hi]))
                and np.array_equal(np.concatenate(gc),
                                   np.concatenate(wc[lo:hi])),
                f"phase 12 {what}: outputs differ from the single-card "
                f"engine's")

    def wide_run(mw, tag):
        """Shard the wide table, then the batch and the long reads, each
        part synchronised and timed (the short/long split of the wall)."""
        parts = {}
        t0 = time.perf_counter()
        st = TSW.shard_mega_wide(wide, mw)
        torch.cuda.synchronize()
        parts["shard_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        short = TSW.query_batch_sharded_mega_wide(wide, batch, mesh=mw, st=st)
        torch.cuda.synchronize()
        parts["short_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        lng = TSW.query_long_reads_sharded_mega_wide(wide, long_reads,
                                                     mesh=mw, chunk=2048,
                                                     st=st)
        torch.cuda.synchronize()
        parts["long_s"] = time.perf_counter() - t0
        walls[tag + " split"] = parts
        log(f"[phase 12] {tag}: " + json.dumps(parts))
        return short, lng

    m12 = mesh(1, 2)
    long_chunks = -(-max(len(x) for x in long_reads) // 2048)
    long_steps = long_chunks * 2048
    # K13d, K13e: sharded-pos on bench's index; k = 3 at ip = 2
    k = TSP.choose_k_sharded(index, 2)
    require(k == 3, f"choose_k_sharded gave k={k} at ip=2, expected 3")
    with twins(False) as cap:
        def pos_run():
            st = TSP.shard_pos_tables(index, m12)
            return TSP.query_batch_sharded_pos(index, batch, mesh=m12, st=st)

        # one chunk-scan launch for the whole batch (both shards on the
        # card), no fetch, no step; the tables: K1 once a char (A = 6, one
        # chunk each), K13d once a shard
        A = index.sigma + 1
        got = counted(cap, "sharded-pos (1,2) k=3", {
            "build_t1_chunk": A, "compose_sharded_tk": 2,
            "sharded_scan_pos": 1, "sharded_fetch": 0,
            "sharded_step_pos": 0}, pos_run)
        same(got, ref4, 0, B, "sharded-pos")
        # the per-step route: a fetch launch and a step launch a step
        with pos_step_route():
            tag = "sharded-pos (1,2) step route"
            got = counted(cap, tag, {
                "build_t1_chunk": A, "compose_sharded_tk": 2,
                "sharded_scan_pos": 0, "sharded_fetch": -(-M // 3),
                "sharded_step_pos": -(-M // 3)}, pos_run)
        same(got, ref4, 0, B, tag)
        # one chunk-scan launch for the whole batch and one fetch (the
        # start offset); then the per-round route: a fetch a card and a
        # round kernel a gather round (four rounds a step at ff_bound 2)
        got = counted(cap, "sharded-compact (1,2)", {
            "sharded_scan_compact": 1, "sharded_fetch": 1,
            "sharded_step_compact": 0},
            lambda: TS.query_batch_sharded(split, batch, mesh=m12))
        ref_compact = TX.query_batch(split, batch, device=dev)
        same(got, ref_compact, 0, B, "sharded compact")
        with round_route():
            tag = "sharded-compact (1,2) round route"
            got = counted(cap, tag, {
                "sharded_scan_compact": 0, "sharded_fetch": 1 + 6 * M,
                "sharded_step_compact": 4 * M},
                lambda: TS.query_batch_sharded(split, batch, mesh=m12))
        same(got, ref_compact, 0, B, tag)
        del ref_compact
        t0 = time.perf_counter()
        mt = TM.build_mega_table(split, device="cpu")  # host NumPy, as JAX
        st_mega = TSM.shard_mega(split, m12, mt=mt)
        log(f"[phase 12] mega table (host) and its shards in "
            f"{time.perf_counter() - t0:.3f}s")
        # one chunk-scan launch for the whole batch, no fetch, no step
        got = counted(cap, "sharded-mega (1,2)", {
            "sharded_scan_mega": 1, "sharded_fetch": 0,
            "sharded_step_mega": 0},
            lambda: TSM.query_batch_sharded_mega(split, batch, mesh=m12,
                                                 st=st_mega))
        mt_dev = {key: v.to(dev) if isinstance(v, torch.Tensor) else v
                  for key, v in mt.items()}
        ref_mega = TM.query_batch(split, batch, mt=mt_dev)
        same(got, ref_mega, 0, B, "sharded-mega")
        del mt, mt_dev
        for dp, ip in ((1, 2), (2, 2), (1, 4)):
            mw = mesh(dp, ip)
            tag = f"sharded-mega-wide ({dp},{ip})"
            # a launch a dp row for the batch and for each long-read chunk
            got, got_long = counted(cap, tag, {
                "fill_block_wide": None,
                "sharded_scan_mega": dp * (1 + long_chunks),
                "sharded_fetch": 0, "sharded_step_mega": 0},
                lambda: wide_run(mw, tag))
            same(got, ref7, 0, B, tag)
            same(got_long, ref7, B, B + len(long_reads), tag + " long reads")
        # the per-step route once, narrow and wide: a fetch launch and a
        # step launch a step
        with step_route():
            tag = "sharded-mega (1,2) step route"
            got = counted(cap, tag, {
                "sharded_scan_mega": 0, "sharded_fetch": M,
                "sharded_step_mega": M},
                lambda: TSM.query_batch_sharded_mega(split, batch, mesh=m12,
                                                     st=st_mega))
            same(got, ref_mega, 0, B, tag)
            del ref_mega
            tag = "sharded-mega-wide (1,2) step route"
            got, got_long = counted(cap, tag, {
                "fill_block_wide": None, "sharded_scan_mega": 0,
                "sharded_fetch": M + long_steps,
                "sharded_step_mega": M + long_steps},
                lambda: wide_run(m12, tag))
        same(got, ref7, 0, B, tag)
        same(got_long, ref7, B, B + len(long_reads), tag + " long reads")
    log("[phase 12] every sharded engine equals the single-card engine, "
        "both routes of the pos, compact and mega engines")

    # every kernel call against its plain version: the full batch (the
    # compact engine's per-round route: its first 8,192 reads, a round
    # call by call), the tables rebuilt under the check (K1, K13d); every
    # engine (the wide one with its long reads) through both routes
    t0 = time.perf_counter()
    with twins(True) as tw:
        for tag, route in (("pos", contextlib.nullcontext),
                           ("pos step route", pos_step_route)):
            tw.tag = tag
            with route():
                TSP.query_batch_sharded_pos(index, batch, mesh=m12)
        tw.tag = "compact"
        TS.query_batch_sharded(split, batch, mesh=m12)
        tw.tag = "compact round route"
        with round_route():
            TS.query_batch_sharded(split, batch[:8192], mesh=m12)
        for tag, route in (("mega", contextlib.nullcontext),
                           ("mega step route", step_route)):
            tw.tag = tag
            with route():
                TSM.query_batch_sharded_mega(split, batch, mesh=m12,
                                             st=st_mega)
        st_wide = TSW.shard_mega_wide(wide, m12)
        for tag, route in (("wide", contextlib.nullcontext),
                           ("wide step route", step_route)):
            tw.tag = tag
            with route():
                TSW.query_batch_sharded_mega_wide(wide, batch, mesh=m12,
                                                  st=st_wide)
                TSW.query_long_reads_sharded_mega_wide(
                    wide, long_reads, mesh=m12, chunk=2048, st=st_wide)
    del st_mega, st_wide
    torch.cuda.empty_cache()
    log(f"[phase 12] K1, K13a-K13e and the chunk scans equal to their "
        f"plain versions call by call ({time.perf_counter() - t0:.1f}s)")

    # times at the counted runs' shapes: each per-step kernel's ninth call
    # (step 8) of its shape, the chunk scan's first of its shape, K13d its
    # first
    first = cap.first

    def arg(name, tag, key=None):
        return first[(name, tag, key)]

    step_tag = "sharded-mega-wide (1,2) step route"
    for tag, key, what in (
            (step_tag, (16, True, B), "wide rows"),
            (step_tag, (16, True, len(long_reads)),
             "wide rows, the long reads' lanes"),
            ("sharded-pos (1,2) step route", (2, False, B),
             "pos rows, key selector"),
            ("sharded-compact (1,2) round route", (8, True, B),
             "compact run rows")):
        a = arg("sharded_fetch", tag, key)
        shards, g, s, L, _, _ = a
        W = shards[0].shape[1]
        lanes = g.shape[0]
        owned = int(((g >= 0) & (g < L * len(shards))).sum())
        chk.time("sharded_fetch", lambda: PM.sharded_fetch(*a),
                 lambda: PM.sharded_fetch_ref(*a),
                 f"{what}: {len(shards)} shards of {tuple(shards[0].shape)} "
                 f"in one launch, {lanes} lanes, {owned} owned",
                 reps=3 if lanes > 64 else 200,
                 bound=(nbytes(g, s) + lanes * W * 4
                        + min(nbytes(shards), owned * W * 4),
                        lanes * W * 4))
    a = arg("compose_sharded_tk", "sharded-pos (1,2) k=3")
    t1, n, n_local, lo, A, kk = a
    rows = A ** kk * n_local
    chk.time("compose_sharded_tk", lambda: TSP.compose_sharded_tk(*a),
             lambda: TSP.compose_sharded_tk_ref(*a),
             f"shard 0 of T{kk}: {rows} rows, A={A}, n_local={n_local}",
             bound=(rows * 8 + gathered(t1, rows * kk, 8), rows * kk * 12))
    a = arg("sharded_step_pos", "sharded-pos (1,2) step route")
    Bs = a[0].shape[0]
    what = f"one step of {Bs} lanes, k={kk}"
    chk.time("sharded_step_pos", lambda: TSP.sharded_step_pos(*a),
             lambda: TSP.sharded_step_pos_ref(*a),
             f"{what} (the public wrapper, checked in full)",
             bound=(a[0].nbytes + 2 * nbytes(a[1], a[2]) + Bs * kk * 5
                    + nbytes(a[8], a[9]), Bs * kk * 10))
    # the route's call: the launcher made once a batch, then on the card
    # alone
    step_pos = TSP.StepPos(*a[:4], *a[5:])
    log(f"[time] sharded_step_pos {what}: launcher "
        f"{cuda_ms(torch, lambda: step_pos(a[4])):.4f} ms, on the card "
        f"{gpu_ms(torch, lambda: step_pos(a[4])):.4f} ms")
    # the K13e chunk scan: 16 long-read lanes from the start state (their
    # last 2,049 characters, 683 steps: the chain floor's step), then the
    # counted run's batch; each call includes the wrapper's transpose
    a = arg("sharded_scan_pos", "sharded-pos (1,2) k=3", (B, -(-M // 3) * 3))
    enc, _ = index.encode_patterns([x[-2049:] for x in long_reads], 2049)
    pos16 = (a[0], a[1], torch.from_numpy(enc.astype(np.uint8)).to(dev),
             *a[3:])
    for b in (pos16, a):
        shards, _, pats, kk, _, _ = b
        steps = pats.shape[1] // kk
        lanes = pats.shape[0]
        chk.equal("sharded_scan_pos", TSP.sharded_scan_pos(*b),
                  TSP.sharded_scan_pos_ref(*b), f"{lanes} lanes")
        chk.time("sharded_scan_pos", lambda: TSP.sharded_scan_pos(*b),
                 lambda: TSP.sharded_scan_pos_ref(*b),
                 f"{lanes} lanes x {steps} steps of k={kk}, {len(shards)} "
                 f"shards, one launch and the wrapper's transpose",
                 reps=1 if lanes <= 16 else 3,
                 bound=(gathered(shards, lanes * steps, 8) + pats.numel() * 5,
                        pats.numel() * 10),
                 chain=("sharded_scan_pos", steps, lanes <= 16))
    for tag, lanes in (("sharded-mega (1,2) step route", B), (step_tag, B),
                       (step_tag, len(long_reads))):
        a = arg("sharded_step_mega", tag, lanes)
        reps = 3 if lanes > 64 else 200
        what = f"{tag}: one step of {lanes} lanes"
        chk.time("sharded_step_mega", lambda: TSM.sharded_step_mega(*a),
                 lambda: TSM.sharded_step_mega_ref(*a),
                 f"{what} (the public wrapper, checked in full)",
                 reps=reps,
                 bound=(nbytes(a[0], a[7]) + 2 * nbytes(a[5]) + lanes * 14,
                        lanes * 40))
        # the route's call: the launcher made once a chunk, then on the
        # card alone
        step = TSM.StepMega(*a[:8], *a[9:])
        log(f"[time] sharded_step_mega {what}: launcher "
            f"{cuda_ms(torch, lambda: step(a[8]), reps):.4f} ms, on the "
            f"card {gpu_ms(torch, lambda: step(a[8]), reps):.4f} ms")
    # the chunk scans: first on 16 lanes, the long reads cut to their last
    # 2,048 characters from the start state (the wide engine: its first
    # long-read chunk), whose time a step the chain floors'; then the
    # counted runs' batches
    enc, ln = split.encode_patterns([x[-2048:] for x in long_reads], 2048)
    pats16 = torch.from_numpy(enc.astype(np.uint8)).to(dev)
    lens16 = torch.from_numpy(ln).to(dev)

    def lanes16(a, at_state: int, at_pats: int):
        """The captured call `a` on the 16 long-read lanes, its state the
        first 16 lanes' start state; checked against the plain version."""
        a = list(a)
        a[at_state] = tuple(t[:len(ln)].clone() for t in a[at_state])
        a[at_pats], a[at_pats + 1] = pats16, lens16
        return tuple(a)

    mega16 = lanes16(arg("sharded_scan_mega", "sharded-mega (1,2)", (B, M)),
                     6, 7)
    compact16 = lanes16(arg("sharded_scan_compact", "sharded-compact (1,2)",
                            (B, M)), 5, 3)
    for name, mod, a, at_state in (("sharded_scan_mega", TSM, mega16, 6),
                                   ("sharded_scan_compact", TS, compact16,
                                    5)):
        ka, ra = clone_args(torch, a), clone_args(torch, a)
        got, want = getattr(mod, name)(*ka), getattr(mod, name + "_ref")(*ra)
        for g, w in zip(got + ka[at_state], want + ra[at_state]):
            chk.equal(name, g, w, "16 long-read lanes, outputs and state")
    for tag, shape, what, a in (
            ("sharded-mega-wide (1,2)", (len(long_reads), 2048),
             "wide, one long-read chunk", None),
            (None, None, "narrow, 16 long-read lanes of 2048", mega16),
            ("sharded-mega (1,2)", (B, M), "narrow", None),
            ("sharded-mega-wide (1,2)", (B, M), "wide", None)):
        a = a or arg("sharded_scan_mega", tag, shape)
        shards, _, length, _, _, _, state, pats, lens, step0, _, wide_ = a
        lane = (lens.long() - step0).clamp(0, pats.shape[1])
        lane_steps = int(lane.sum())
        # a step's rows: the first 32 B of its 64-byte row, and on a
        # mismatch (the plain version's pml 0) the other 32 B
        pml, _ = TSM.sharded_scan_mega_ref(*clone_args(torch, a))
        table_bytes = min(nbytes(shards),
                          mega_row_bytes(torch, pml, lane, 32, 32))
        del pml
        chk.time("sharded_scan_mega", lambda: TSM.sharded_scan_mega(*a),
                 lambda: TSM.sharded_scan_mega_ref(*a),
                 f"{what}: {pats.shape[0]} lanes x {pats.shape[1]} steps, "
                 f"{len(shards)} shards, {lane_steps} valid lane-steps, "
                 f"one launch", reps=1 if pats.shape[0] <= 16 else 3,
                 bound=(table_bytes + lane_steps + nbytes(lens)
                        + 2 * nbytes(state)
                        + 2 * pats.numel() * 4, lane_steps * 40),
                 chain=("sharded_scan_mega " + ("wide" if wide_
                                                else "narrow"),
                        int(lane.max()), pats.shape[0] <= 16))
    for a in (compact16, arg("sharded_scan_compact",
                             "sharded-compact (1,2)", (B, M))):
        soa, jump, _, pats, lens, state, _, _, ff = a
        lane = lens.long().clamp(0, pats.shape[1])
        lane_steps = int(lane.sum())
        row_reads = 5 + max(ff - 2, 0)  # run rows a step: rounds 1, 2, 2, 3-5
        chk.time("sharded_scan_compact", lambda: TS.sharded_scan_compact(*a),
                 lambda: TS.sharded_scan_compact_ref(*a),
                 f"{pats.shape[0]} lanes x {pats.shape[1]} steps, {len(soa)} "
                 f"shards, {lane_steps} valid lane-steps, ff_bound {ff}, one "
                 f"launch", reps=1 if pats.shape[0] <= 16 else 3,
                 bound=(gathered(soa, lane_steps * row_reads, 32)
                        + gathered(jump, lane_steps, 8) + nbytes(pats, lens)
                        + 2 * nbytes(state) + 2 * pats.numel() * 4,
                        lane_steps * 60),
                 chain=("sharded_scan_compact", int(lane.max()),
                        pats.shape[0] <= 16))
    caps = [arg("sharded_step_compact", "sharded-compact (1,2) round route",
                rnd) for rnd in (1, 2, 3, 4)]
    Bs = caps[0][2].shape[0]
    # the bytes of one character step: the fetched rows, the state read and
    # written, lengths, the pattern column and the pml/cid writes (not the
    # scratch and next-index traffic between one launch a round)
    what = f"one character step (rounds 1-4) of {Bs} lanes"
    chk.time("sharded_step_compact",
             lambda: [TS.sharded_step_compact(*c) for c in caps],
             lambda: [TS.sharded_step_compact_ref(*c) for c in caps],
             f"{what} (the public wrapper, checked in full)",
             bound=(sum(nbytes(c[2], c[3]) for c in caps)
                    + Bs * (16 * 2 + 4 + 1 + 8), Bs * 60))
    rounds = [(TS.RoundCompact(c[2], c[3] if c[0] == 1 else None,
                               c[3] if c[0] == 2 else None, *c[4:8],
                               *c[9:]), c[0], c[1], c[8]) for c in caps]

    def launched():
        for go, rnd, last, i in rounds:
            go(rnd, last, i)
    log(f"[time] sharded_step_compact {what}: launchers "
        f"{cuda_ms(torch, launched):.4f} ms, on the card "
        f"{gpu_ms(torch, launched):.4f} ms")
    del cap, first, caps, a, rounds, step, step_pos
    torch.cuda.empty_cache()
    log(f"[phase 12] done in {time.perf_counter() - t_phase:.1f}s")
    return walls, launches


def busy_seconds(trace_file: Path) -> tuple[float, dict]:
    """The union of the device's kernel and copy intervals in a
    torch.profiler Chrome trace, in seconds, and the device microseconds
    of its five busiest names."""
    data = json.loads(trace_file.read_text())
    events = data["traceEvents"] if isinstance(data, dict) else data
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
                   for e in events
                   if e.get("cat") in BUSY_CATEGORIES and e.get("ph") == "X")
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    by_name: dict = {}
    for e in events:
        if e.get("cat") in BUSY_CATEGORIES and e.get("ph") == "X":
            by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"]
    top = dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:5])
    return busy * 1e-6, top


def phase13(torch, dev, cli_main, bench_prefix: str, pat4: Path, wide,
            c_event: dict, d_event: dict, a_events: dict
            ) -> tuple[dict, list[dict]]:
    """The persisted table cache and the build's prewarm on the indexes
    phases 6-7 saved, then phase 4's query under the profiler:

    1. stage_prewarm on C's mega index: its cache event and prewarm_s;
    2. phase 6's reads through `query` on C's index again: a `load` event
       (K14 uploads), records byte-equal to phase 6's, and the loaded
       tables equal to a fresh build_mega_table on the card;
    3. D's full mega-wide table in a scratch directory, built five times
       (the first under "force", saving it, then under "off") and loaded
       five times under "force", in turns; phase 7's decision under
       "auto" (`d_event`, with no entry yet) must be the one the measured
       save and medians give (save when the save and the load beat the
       build); "auto" on the saved entry is reported and not held, since
       D's build and load lie within their runs' spread; an engine whose
       budget picks the compact layout must miss the full entry (K6b and
       K6c launch);
    4. the decisions where build and cache lie far apart: phase 6's save
       of C's table (`c_event`) must be followed by loads, and its save
       plus step 2's load must beat its build; phases 4 and 10's skipped
       save of A's pos tables (`a_events`) must be right: the copy of
       freshly built pos tables to the host, the first step of any save,
       must take longer than their build;
    5. phase 4's query again under utils/profiling.trace: records
       byte-equal to phase 4's, the device's busy share (the union of its
       kernel and copy intervals over the query wall).

    Returns the phase's values and the launch counts of steps 1-5."""
    from colbwt_tpu_torch.models.index import ColPmlIndex
    from colbwt_tpu_torch.ops import _kernels as K
    from colbwt_tpu_torch.ops import query_mega as TM
    from colbwt_tpu_torch.ops.query_mega_wide import wide_table_bytes
    from colbwt_tpu_torch.pipeline.build import stage_prewarm
    from colbwt_tpu_torch.pipeline import tables as TB
    from colbwt_tpu_torch.pipeline.engines import QueryEngines
    from colbwt_tpu_torch.utils import profiling
    from colbwt_tpu_torch.utils.config import ColBwtConfig
    from colbwt_tpu_torch.utils.log import get_logger

    out: dict = {}
    launches = []
    mega = str(WORK / "mega")

    # 1. prewarm C
    def prewarm():
        stage_prewarm(mega, ColBwtConfig(), get_logger("colbwt_torch.build"),
                      dev)
        return 0

    K.reset_launches()
    out["prewarm C"] = run_logged(prewarm, "colbwt_torch.build",
                                  ("table_cache", "prewarm_s"))
    launches.append(dict(K.launches))
    require("table_cache" in out["prewarm C"],
            "phase 13: the prewarm logged no table cache event")
    log("[phase 13] prewarm of C's mega index: "
        + json.dumps(out["prewarm C"]))

    # 2. C's second query loads its tables from the cache
    p13 = WORK / "reads_mega13.fa"
    shutil.copy(pat4, p13)
    K.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()  # what earlier phases still hold
    v = run_query(lambda: cli_main(["query", mega, "-p", str(p13)]))
    lc = dict(K.launches)
    peak = torch.cuda.max_memory_allocated()
    launches.append(lc)
    ev = v.get("table_cache") or {}
    require(v.get("engine") == "mega" and ev.get("event") == "load",
            f"phase 13: C's query {v.get('engine')} / {ev}, expected a load")
    for name in ("upload_rows", "query_chunk_mega"):
        require(lc[name] > 0, f"{name} never launched in phase 13's query")
    for ext in ("pml", "cid"):
        require(same_bytes(f"{p13}.split.{ext}.bin",
                           f"{WORK / 'reads_mega.fa'}.split.{ext}.bin"),
                f"phase 13: .split.{ext}.bin differs from phase 6's")
    index = ColPmlIndex.load(f"{mega}.colpml.npz")
    eng = QueryEngines(index, ColBwtConfig(engine="mega"), None,
                       table_dir=f"{mega}.torch_tables", device=dev)
    require(eng.cache_events[0]["event"] == "load",
            f"phase 13: {eng.cache_events}")
    fresh = TM.build_mega_table(index, device=dev)
    require(eng.mt.keys() == fresh.keys(), "phase 13: mega table keys")
    for key, want in fresh.items():
        got = eng.mt[key]
        require(torch.equal(got, want) if isinstance(want, torch.Tensor)
                else got == want,
                f"phase 13: the loaded {key} differs from a fresh build")
    del eng, fresh
    # phase 6's query or the prewarm saved the entry
    saved = [e for e in (c_event, out["prewarm C"]["table_cache"])
             if e and e["event"] == "build+save"]
    out["query C"] = {
        "table_cache": ev, "load_s": v["table_build_s"],
        "build_s": ev.get("replaced_build_seconds"),
        "save_s": saved[0]["save_seconds"] if saved else None,
        "query_wall_s": v["wall_s"], "device_mem_peak_bytes": peak,
        "device_mem_peak_above_start_bytes": peak - base}
    log("[phase 13] C's query from the cache: " + json.dumps(out["query C"])
        + "; records byte-equal to phase 6's, the loaded mega and length "
        "equal to a fresh build_mega_table; launches " + json.dumps(lc))

    # 3. D's full layout built and loaded both ways, then auto
    scratch = WORK / "d_cache"
    shutil.rmtree(scratch, ignore_errors=True)

    def engine(cache: str, **kw) -> tuple[str, float, float]:
        e = QueryEngines(wide, ColBwtConfig(table_cache=cache, **kw), None,
                         table_dir=str(scratch), device=dev)
        require(("mega" in e.mt) == ("pos_hbm_budget" not in kw),
                f"phase 13: D's engine chose the wrong layout ({kw})")
        got = ((e.cache_events or [{"event": "build"}])[0]["event"],
               e.table_build_seconds, e.table_save_seconds)
        del e
        return got

    K.reset_launches()
    # five builds and five loads in turns, the first build saving the entry
    runs = [engine("force")]
    for _ in range(4):
        runs += [engine("force"), engine("off")]
    runs.append(engine("force"))
    require([r[0] for r in runs] == ["build+save"] + ["load", "build"] * 4
            + ["load"], f"phase 13: D {runs}")
    builds = np.array([r[1] for r in runs if r[0] != "load"])
    loads = np.array([r[1] for r in runs if r[0] == "load"])
    build_s, load_s = float(np.median(builds)), float(np.median(loads))
    save_s = runs[0][2]
    # phase 7's decision, made before any entry existed
    d_save = save_s + load_s < build_s
    require(d_event["event"] == ("build+save" if d_save else
                                 "build+skip-save"),
            f"phase 13: phase 7 chose {d_event} at D, measured build "
            f"{build_s}, save {save_s}, load {load_s}")
    # auto on the saved entry: reported, not held (a tie by the spread)
    spread = max(float(np.subtract(*np.percentile(x, [75, 25])))
                 for x in (builds, loads))
    auto = engine("auto")[0]
    # the full entry is a miss for an engine that picks the compact layout
    if not (scratch / "megawide").exists():
        engine("force")
    launches.append(dict(K.launches))
    K.reset_launches()
    compact = engine("force", pos_hbm_budget=wide_table_bytes(wide) - 1)
    lc_compact = dict(K.launches)
    require(compact[0] == "build+save"
            and lc_compact["fill_block_wide"] > 0
            and lc_compact["shared_table_wide"] > 0,
            f"phase 13: the compact engine {compact}, launches {lc_compact}")
    launches.append(lc_compact)
    out["D"] = {"phase7_event": d_event, "build_s": builds.tolist(),
                "save_s": save_s, "load_s": loads.tolist(),
                "median_build_s": build_s, "median_load_s": load_s,
                "save_pays": d_save, "spread_s": spread,
                "auto_on_entry": auto,
                "auto_on_entry_faster": ("load" if load_s < build_s
                                         else "skip-load"),
                "compact_event": compact[0]}
    shutil.rmtree(scratch, ignore_errors=True)
    log("[phase 13] D's full mega-wide table: " + json.dumps(out["D"]))

    # 4. C's save and A's skipped saves, held to what they cost
    require(c_event and c_event["event"] == "build+save"
            and c_event["save_seconds"] + out["query C"]["load_s"]
            < c_event["seconds"],
            f"phase 13: phase 6 chose {c_event} at C, step 2 loaded in "
            f"{out['query C']['load_s']}")
    out["C"] = {"phase6_event": c_event,
                "save_plus_load_s": c_event["save_seconds"]
                + out["query C"]["load_s"]}
    require(all(e and e["event"] == "build+skip-save"
                for e in a_events.values()),
            f"phase 13: A's decisions {a_events}")
    index = ColPmlIndex.load(f"{bench_prefix}.colpml.npz")
    K.reset_launches()
    e = QueryEngines(index, ColBwtConfig(table_cache="off"), None,
                     device=dev)
    launches.append(dict(K.launches))
    require(e.use_pos, f"phase 13: A's engine is {e.name}")
    arrs = [v for v in e.pt.values() if TB.placement(v) == "dev"]
    a_bytes = sum(v.nbytes for v in arrs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    host = [v.cpu() for v in arrs]
    copy_s = time.perf_counter() - t0
    del host, arrs, e
    torch.cuda.empty_cache()
    a_builds = [ev["seconds"] for ev in a_events.values()]
    require(copy_s > max(a_builds),
            f"phase 13: A's tables copied to the host in {copy_s} s, "
            f"under their builds {a_builds}: a save could have paid")
    out["A"] = {"events": a_events, "bytes": a_bytes,
                "measured_copy_to_host_s": copy_s}
    log("[phase 13] C's save and A's skipped saves: "
        + json.dumps({"C": out["C"], "A": out["A"]}))

    # 5. phase 4's query under the profiler
    pp = WORK / "reads_profile.fa"
    shutil.copy(pat4, pp)
    trace_dir = WORK / "profile"
    K.reset_launches()
    with profiling.trace(str(trace_dir), dev):
        v = run_query(lambda: cli_main(["query", bench_prefix, "-p",
                                        str(pp)]))
        torch.cuda.synchronize()
    launches.append(dict(K.launches))
    for ext in ("pml", "cid"):
        require(same_bytes(f"{pp}.split.{ext}.bin",
                           f"{pat4}.split.{ext}.bin"),
                f"phase 13: the profiled .split.{ext}.bin differs from "
                "phase 4's")
    busy, top = busy_seconds(trace_dir / profiling.TRACE_FILE)
    require(busy > 0, "phase 13: the trace holds no device interval")
    out["profile"] = {"query_wall_s": v["wall_s"], "scan_s": v["scan_s"],
                      "table_build_s": v["table_build_s"], "busy_s": busy,
                      "busy_share": busy / v["wall_s"],
                      "busy_share_of_scan": busy / v["scan_s"],
                      "top_us": top}
    log("[phase 13] phase 4's query under the profiler: "
        + json.dumps(out["profile"]))
    return out, launches


def config3_docs(doc_len: int, n_docs: int | None = None
                 ) -> tuple[list[bytes], np.random.Generator]:
    """Config #3's genomes as scripts/validate_config3.py makes them (one
    random base, CONFIG3["muts"] substitutions a genome drawn from
    CONFIG3["hotspots"] sites; `n_docs` of them), and the generator, where
    its reads go on drawing."""
    rng = np.random.default_rng(0xC0F3)
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    base = rng.choice(acgt, doc_len)
    sites = rng.choice(doc_len, CONFIG3["hotspots"], replace=False)
    docs = []
    for _ in range(n_docs or CONFIG3["docs"]):
        a = base.copy()
        pos = rng.choice(sites, CONFIG3["muts"], replace=False)
        a[pos] = rng.choice(acgt, CONFIG3["muts"])
        docs.append(a.tobytes())
    return docs, rng


def config3_reads(docs: list[bytes], rng: np.random.Generator, count: int
                  ) -> list[bytes]:
    """validate_config3.py's reads: 150 bp from a random genome with up to
    3 random substitutions each."""
    doc_len = len(docs[0])
    reads = []
    for _ in range(count):
        d = docs[int(rng.integers(0, len(docs)))]
        s = int(rng.integers(0, doc_len - 150))
        arr = bytearray(d[s:s + 150])
        for _ in range(int(rng.integers(0, 4))):
            arr[int(rng.integers(0, 150))] = int(rng.choice(list(b"ACGT")))
        reads.append(bytes(arr))
    return reads


def config4_muts(doc_len: int) -> int:
    """Config #4's substitutions a haplotype at `doc_len` bp: its density,
    CONFIG4["muts"] per CONFIG4["doc_len"] bp."""
    return round(CONFIG4["muts"] * doc_len / CONFIG4["doc_len"])


def config4_docs(doc_len: int, muts: int
                 ) -> tuple[list[bytes], np.random.Generator]:
    """Config #4's haplotypes as scripts/validate_config4.py makes them (one
    random base, `muts` substitutions a haplotype at positions drawn with
    replacement), and the generator, where its reads go on drawing."""
    rng = np.random.default_rng(0xC4)
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    base = rng.choice(acgt, doc_len)
    docs = []
    for _ in range(CONFIG4["docs"]):
        a = base.copy()
        pos = rng.integers(0, doc_len, muts)
        a[pos] = rng.choice(acgt, muts)
        docs.append(a.tobytes())
    return docs, rng


def config4_reads(docs: list[bytes], rng: np.random.Generator, count: int
                  ) -> list[bytes]:
    """validate_config4.py's reads: 150 bp from a random haplotype with up
    to 3 random substitutions each."""
    doc_len = len(docs[0])
    reads = []
    for _ in range(count):
        d = docs[int(rng.integers(0, len(docs)))]
        s = int(rng.integers(0, doc_len - 150))
        arr = bytearray(d[s:s + 150])
        for _ in range(int(rng.integers(0, 4))):
            arr[int(rng.integers(0, 150))] = int(rng.choice(list(b"ACGT")))
        reads.append(bytes(arr))
    return reads


def write_config4_reads(path: str, doc_len: int, muts: int, count: int
                        ) -> None:
    """The reads of config #4 at `doc_len` bp written to `path` as FASTA:
    validate_config4.py's `count` reads (q0, q1, ...), then CONFIG4["n_reads"]
    of them with one N inserted (n0, n1, ...), as query_reads adds them to
    cell A's.  Phase 15 runs it in a process of its own beside the build."""
    docs, rng = config4_docs(doc_len, muts)
    reads = config4_reads(docs, rng, count)
    del docs
    n_reads = []
    for i in rng.choice(count, CONFIG4["n_reads"], replace=False):
        p = int(rng.integers(0, 151))
        n_reads.append(reads[i][:p] + b"N" + reads[i][p:])
    write_reads(Path(path), [(f"q{i}", r) for i, r in enumerate(reads)]
                + [(f"n{i}", r) for i, r in enumerate(n_reads)])


def write_config3_reads(path: str, doc_len: int, count: int) -> None:
    """The reads of config #3 at `doc_len` bp written to `path` as FASTA
    (q0, q1, ...): validate_config3.py's `count` reads.  Phase 14 runs it
    in a process of its own beside the build."""
    docs, rng = config3_docs(doc_len)
    write_reads(Path(path), [(f"q{i}", r) for i, r
                             in enumerate(config3_reads(docs, rng, count))])


class Beside:
    """While active, `target(*args)` runs in a process of its own (spawned:
    it imports this file, none of the caller's state); `wait` joins it and
    fails on an exit code other than 0, and leaving stops it if it still
    runs."""

    def __init__(self, target, *args):
        import multiprocessing

        self.proc = multiprocessing.get_context("spawn").Process(
            target=target, args=args)

    def __enter__(self):
        self.proc.start()
        return self

    def wait(self) -> float:
        """Join the process; returns the seconds waited."""
        t0 = time.perf_counter()
        self.proc.join()
        require(self.proc.exitcode == 0,
                f"{self.proc.name} exited {self.proc.exitcode}")
        return time.perf_counter() - t0

    def __exit__(self, *exc):
        if self.proc.is_alive():
            self.proc.terminate()
        self.proc.join()
        return False


class EngineSpy:
    """While active, keeps the QueryEngines a query makes, for its tables'
    bytes."""

    def __enter__(self):
        from colbwt_tpu_torch.pipeline import engines

        self.real = engines.QueryEngines
        self.made = made = []

        class Recorded(self.real):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                made.append(self)

        engines.QueryEngines = Recorded
        return self

    def __exit__(self, *exc):
        from colbwt_tpu_torch.pipeline import engines

        engines.QueryEngines = self.real
        # the engines' class holds the list it appends to: keep a copy and
        # empty that list, so no reference cycle (engine, class, list) holds
        # an engine's tables on the card after the caller drops it
        held, self.made = self.made, list(self.made)
        held.clear()
        return False


def check_config3_chunks(torch, dev, arrays, chk: Checks) -> dict:
    """The large-N route at config #3's chunks (C = 2**26, N = 10,000,
    uint16 ids, as find_multi_mums_chunked cuts them): the first and the
    last equal to the plain version, the first timed beside it; then the
    same first chunk's positions at N = 1,025 (uint16 and int32 ids), equal
    and timed, for the route's growth with N.  Returns the times."""
    from colbwt_tpu_torch.ops import construct as TC

    lcp, sa_docs, rc = scan_inputs(arrays)
    n, N = lcp.size, CONFIG3["docs"]
    C = min(1 << 26, 1 << max(13, (n - 1).bit_length()))

    def chunk(s, N, ids):
        halo = 2 * N + 2

        def sl(a, fill, dtype):
            x = a[s:s + C + halo].astype(dtype)
            return torch.from_numpy(np.concatenate(
                [x, np.full(C + halo - x.size, fill, dtype)])).to(dev)
        docs = (sl(sa_docs, 65535, np.uint16) if ids == "uint16"
                else sl(sa_docs, -1, np.int32))
        return (sl(lcp, 0, np.int32), docs, sl(rc, 1, np.uint8),
                min(n - N - s, C), 20, N)

    last = (n - 1) // C
    times = {}
    for k, N_, ids in ([(0, N, "uint16")]
                       + ([(last, N, "uint16")] if last else [])
                       + [(0, 1025, "uint16"), (0, 1025, "int32")]):
        args = chunk(k * C, N_, ids)
        label = (f"config #3 chunk {k} of {last + 1} (C = {C}, N = {N_}, "
                 f"{ids} documents, {min(n - k * C, C)} positions in range)")
        got = TC.mum_scan_chunk(*args)
        want = TC.mum_scan_chunk_ref(*args)
        chk.equal("mum_window_two_pass", got[0], want[0], label + " hits")
        chk.equal("mum_window_two_pass", got[1], want[1], label + " ell")
        hits = int(np.unpackbits(want[0].cpu().numpy()).sum())
        del want
        if k == 0:
            # the bytes: lcp, documents and run changes read once, ell and
            # the packed hits written once; 48 integer operations a start
            times[f"N={N_} {ids}"] = chk.time(
                "mum_window_two_pass", lambda: TC.mum_scan_chunk(*args),
                lambda: TC.mum_scan_chunk_ref(*args), label,
                bound=(nbytes(args[:3], got), 48 * C))
        log(f"[phase 14] {label}: equal to the plain version, {hits} hits")
        del got, args
        torch.cuda.empty_cache()
    times[f"ratio N={N} / N=1025"] = (times[f"N={N} uint16"]
                                      / times["N=1025 uint16"])
    return times


def phase14(torch, dev, cli_main, chk: Checks, doc_len: int, n_reads: int
            ) -> tuple[dict, list[dict]]:
    """Config #3 through the port's entry points: its genomes written as
    10,000 FASTA files and a file list, `build -i LIST -m tunnels -s 10 -l
    20` (the large-N route in 2**26 chunks, K10a, the prewarm), the
    route's chunks against its plain version, then `query --stream` of
    validate_config3.py's reads (made in a process of their own beside the
    build), 512 sampled records equal to the C++ serial engine on the
    index's table and 8 of them to the oracle."""
    from colbwt_tpu_torch.io import formats as F
    from colbwt_tpu_torch.io import native as native_lib
    from colbwt_tpu_torch.io.fasta import read_fasta
    from colbwt_tpu_torch.io.pml_out import read_pml_cid_binary
    from colbwt_tpu_torch.models.index import ColPmlIndex
    from colbwt_tpu_torch.ops import _kernels as K
    from colbwt_tpu_torch.ops import oracle as O

    t0 = time.perf_counter()
    work = WORK / "config3"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    docs, _ = config3_docs(doc_len)
    files = []
    for i, d in enumerate(docs):
        files.append(work / f"g{i}.fa")
        write_reads(files[-1], [(f"genome{i}", d)])
    listing = work / "genomes.txt"
    listing.write_text("".join(f"{f}\n" for f in files))
    log(f"[phase 14] config #3: {len(docs)} genomes of {doc_len} bp written "
        f"as FASTA files and a file list in {time.perf_counter() - t0:.1f}s")
    prefix = str(work / "config3")
    pat = work / "reads.fa"
    with Beside(write_config3_reads, str(pat), doc_len, n_reads) as maker:
        with Capture() as cap:
            v, lc_build = run_build("14", lambda: cli_main(
                ["build", "-i", str(listing), "-o", prefix, "-m", "tunnels",
                 "-s", "10", "-l", "20", "--device", str(dev)]),
                ("mum_window", "mum_window_two_pass", "tunneled_walk"))
        require(cap.args is not None, "phase 14 did not run the device scan")
        index = ColPmlIndex.load(f"{prefix}.colpml.npz")
        num_docs, ml, _ = F.read_col_mums(f"{prefix}.fa.col_mums")
        got = {"n": int(index.n), "bwt_r": int(index.bwt_r),
               "mums": int(ml.size)}
        full = doc_len == CONFIG3["doc_len"]
        require(num_docs == CONFIG3["docs"],
                f"phase 14: {num_docs} documents")
        if full:
            require(got == CONFIG3_LOG, f"phase 14: {got}, expected "
                    f"{CONFIG3_LOG} (logs/config3_all_r3.log)")
        log(f"[phase 14] build: n = {got['n']}, BWT r = {got['bwt_r']}, "
            f"{got['mums']} multi-MUMs, index r = {index.r}"
            + (" (as logs/config3_all_r3.log)" if full else "")
            + f"; mum_window launches {lc_build['mum_window']} (large-N route "
            f"{lc_build['mum_window_two_pass']})")
        t1 = time.perf_counter()
        times = check_config3_chunks(torch, dev, cap.args, chk)
        del cap
        log(f"[phase 14] the large-N route's chunks checked and timed in "
            f"{time.perf_counter() - t1:.1f}s: " + json.dumps(times))

        log(f"[phase 14] {n_reads} reads written beside the build, waited "
            f"{maker.wait():.1f}s for")
        K.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        with EngineSpy() as spy:
            q = run_logged(lambda: cli_main(
                ["query", prefix, "-p", str(pat), "--stream", "--device",
                 str(dev)]), "colbwt_torch.stream",
                STREAM_KEYS + ("device_mem_peak_bytes",))
        lc_query = dict(K.launches)
        require(len(spy.made) == 1, f"phase 14: {len(spy.made)} engines")
        eng = spy.made[0]
        table_bytes = nbytes(eng.pt, eng.mt, eng.ft)
        del spy, eng
        require(q["reads"] == n_reads, f"phase 14: {q['reads']} records")
        scan = {"pos": "query_chunk_pos", "xla": "query_batch_xla",
                "mega": "query_chunk_mega",
                "mega-wide": "query_chunk_mega_wide",
                "fused": "query_batch_fused"}[q["engine"].split("(")[0]]
        require(lc_query[scan] > 0, f"phase 14: {scan} never launched")

        t1 = time.perf_counter()
        names, pmls = read_pml_cid_binary(f"{pat}.split.pml.bin")
        _, cids = read_pml_cid_binary(f"{pat}.split.cid.bin")
        require(names == [f"q{i}" for i in range(n_reads)],
                "phase 14 record names differ")
        tbl = load_table(prefix)
        sample = np.sort(np.random.default_rng(0xC3C3).choice(
            n_reads, 512, replace=False))
        picked = set(sample.tolist())
        reads = {i: r.seq for i, r in enumerate(read_fasta(pat))
                 if i in picked}
        want_p, want_c = native_lib.query_pml_serial(
            tbl, [reads[i] for i in sample])
        for j, i in enumerate(sample):
            require(np.array_equal(pmls[i], want_p[j])
                    and np.array_equal(cids[i], want_c[j]),
                    f"phase 14 record q{i} differs from the C++ serial engine")
        for i in sample[::64]:
            ep, ec = O.query_pml_oracle(tbl, reads[i])
            require(np.array_equal(pmls[i], ep)
                    and np.array_equal(cids[i], ec),
                    f"phase 14 record q{i} differs from the oracle")
        del names, pmls, cids, tbl, reads
        out = {"doc_len": doc_len, "docs": CONFIG3["docs"], **got,
               "index_r": int(index.r), "build": v,
               "large_n_route_ms": times, "engine": q.get("engine"),
               "table_cache": q.get("table_cache"),
               "table_bytes": table_bytes,
               "table_build_s": q.get("table_build_s"),
               "reads": q["reads"], "query_wall_s": q["wall_s"],
               "reads_per_s": q["reads"] / q["wall_s"],
               "device_mem_peak_bytes": q.get("device_mem_peak_bytes")}
        log(f"[phase 14] query --stream, engine {q.get('engine')}: "
            f"{q['reads']} reads in {q['wall_s']:.3f}s -> "
            f"{out['reads_per_s']:.0f} reads/s, tables {table_bytes} B built "
            f"in {q.get('table_build_s')}s, device memory peak "
            f"{out['device_mem_peak_bytes']} B; 512 sampled records equal the "
            f"C++ serial engine, 8 the oracle "
            f"({time.perf_counter() - t1:.1f}s); launches "
            f"{json.dumps(lc_query)}")
        log("[config3] " + json.dumps(out))
    shutil.rmtree(work, ignore_errors=True)
    return out, [lc_build, lc_query]


def check_t1_chunks(torch, dev, index, chk: Checks, what: str) -> int:
    """K1 over every chunk of 2**25 positions of `index` for its first ACGT
    char, as build_t1 fills them (the tail chunk overlapping the one before
    it), each against its plain version and the first timed beside it.
    Returns the chunk count."""
    from colbwt_tpu_torch.models.tensors import to_device
    from colbwt_tpu_torch.ops import query_pos as TQ

    n = index.n
    C = min(n, TQ._T1_CHUNK)
    c = int(index.char_map[ord("A")])
    a = TQ.t1_inputs(index, C, dev)
    pred = to_device(index.pred_jump[c], dev)
    succ = to_device(index.succ_jump[c], dev)
    got = torch.empty((C, 2), dtype=torch.int32, device=dev)
    want = torch.empty_like(got)
    starts = [min(s, n - C) for s in range(0, n, C)]
    for j, s in enumerate(starts):
        args = (a["char"], a["idx_pad"], a["length"], a["lf_pos0"],
                a["threshold"], pred, succ, a["col_id"], c, 0, s, n, C)
        TQ.build_t1_chunk(got, *args)
        TQ.build_t1_chunk_ref(want, *args)
        chk.equal("build_t1_chunk", got, want,
                  f"{what}, chunk {j} of {len(starts)} (s = {s})")
        if j == 0:
            chk.time("build_t1_chunk", lambda: TQ.build_t1_chunk(got, *args),
                     lambda: TQ.build_t1_chunk_ref(want, *args),
                     f"{what}: one chunk of C={C} positions (n={n}, "
                     f"r={index.r})", bound=(t1_bytes(index, c, s, C), C * 40))
    del a, pred, succ, got, want
    torch.cuda.empty_cache()
    return len(starts)


def check_k3_chain(torch, k3: FirstCalls, chk: Checks, cell: str) -> None:
    """K3 on 16 lanes of the first batch a streamed query of `cell` gave it:
    its time a step at that k, a chain of dependent loads that no other lane
    hides, for the chain floors of time_stream_scans."""
    import inspect

    from colbwt_tpu_torch.ops import query_pos as TQ

    args, kw = next(iter(k3.first.values()))
    a = inspect.signature(TQ.query_chunk_pos).bind(*args, **kw)
    a.apply_defaults()
    a = dict(a.arguments)
    for f in ("patterns", "lengths", "pos0", "mlen0"):
        a[f] = a[f][:16].contiguous()
    got, want = TQ.query_chunk_pos(**a), TQ.query_chunk_pos_ref(**a)
    for g, w in zip((*got[0], *got[1]), (*want[0], *want[1])):
        if w is not None:
            chk.equal("query_chunk_pos", g, w, f"{cell}: 16 lanes")
    k, pack = a["k"], a["pack"]
    M = a["patterns"].shape[1] * 8 // pack if pack else a["patterns"].shape[1]
    steps = int(((a["lengths"].long() - a["step_offset"]).clamp(0, M)
                 + k - 1).max()) // k
    chk.time("query_chunk_pos", lambda: TQ.query_chunk_pos(**a),
             lambda: TQ.query_chunk_pos_ref(**a),
             f"{cell}: 16 lanes of its first batch, k={k}",
             chain=(f"query_chunk_pos k={k}", steps, True))


def check_compact_calls(torch, k4: FirstCalls, launches: int, r: int,
                        chk: Checks, cell: str) -> int:
    """K4 at each shape the compact fallback of a streamed query of `cell`
    gave it (the N reads, on the run-split index of r rows): held to its
    plain version and timed beside its bound, its chain floor from 16 of
    its lanes.  Returns the reads it scanned."""
    from colbwt_tpu_torch.ops import query_xla as TX

    require(sum(k4.count.values()) == launches,
            f"{cell}: {sum(k4.count.values())} K4 calls seen, {launches} "
            "launches counted")
    rows = 0
    for key, (args, kw) in k4.first.items():
        tb, pats, lens = args
        B, M = pats.shape
        rows += B * k4.count[key]
        got = TX.query_batch_device(*args, **kw)
        want = TX.query_batch_device_ref(*args, **kw)
        for g, w, part in zip(got, want, ("pml", "cid")):
            chk.equal("query_batch_xla", g, w, f"{cell} shape {key} {part}")
        lane = lens.clamp(max=M).cpu().numpy()
        chain = f"query_batch_xla ff_bound={kw.get('ff_bound', 0)}"
        a16 = (tb, pats[:16].contiguous(), lens[:16].contiguous())
        for g, w, part in zip(TX.query_batch_device(*a16, **kw),
                              TX.query_batch_device_ref(*a16, **kw),
                              ("pml", "cid")):
            chk.equal("query_batch_xla", g, w, f"{cell}: 16 lanes {part}")
        chk.time("query_batch_xla", lambda: TX.query_batch_device(*a16, **kw),
                 lambda: TX.query_batch_device_ref(*a16, **kw),
                 f"{cell}: 16 lanes of {M}, r = {r}",
                 chain=(chain, int(lane[:16].max()), True))
        steps = int(lane.sum())
        chk.time("query_batch_xla", lambda: TX.query_batch_device(*args, **kw),
                 lambda: TX.query_batch_device_ref(*args, **kw),
                 f"{cell}: {k4.count[key]} launches of {B} x {M}, "
                 f"ff_bound={kw.get('ff_bound', 0)}, r = {r}",
                 bound=(nbytes(args[1:], got) + gathered(tb, steps, 40),
                        steps * 30),
                 chain=(chain, int(lane.max()), False))
    return rows


def phase15(torch, dev, cli_main, chk: Checks, doc_len: int, n_reads: int
            ) -> tuple[dict, list[dict]]:
    """Config #4 through the port's entry points: its 8 haplotypes written
    as FASTA files and a file list, `build -i LIST -m tunnels -s 10 -l 100`
    (K8's tile route, N = 8, in chunks of 2**26; K10a; the prewarm's K1),
    then `query --stream` of validate_config4.py's reads and CONFIG4["n_reads"]
    reads with an N added (as cell A's: without them no read leaves the
    ACGT keys, and the compact fallback never runs), made in a process of
    their own while the build runs.  At full size config #4's n makes two
    decisions that the cut's cannot: the run split (n > 2**28) and pos at
    k = 1 over ACGT keys without the general T1 (6·n > 2**31 - 1), whose
    N reads K4 serves.  The cut forces both through ColBwtConfig
    (run_split "always", a pos_hbm_budget of 5·n·8 bytes, within
    [4·n·8, (4 + sigma + 1)·n·8)) and calls build_pipeline and query_stream
    with it; any other decision fails the phase.  K8's chunks, K10a's
    buckets, K1's chunks, and K3's and K4's shapes from the query are held
    to their plain versions and timed; 256 sampled records equal the C++
    serial engine on the index's table, 8 of them and the N reads among
    them the oracle.  At full size n, the BWT's r, the multi-MUMs, the
    col-split marks and the col runs must be logs/config4_r3.log's, and the
    build is left under build/chip_smoke/config4/ for `--sa-mode chunked`."""
    from colbwt_tpu_torch.io import formats as F
    from colbwt_tpu_torch.io import native as native_lib
    from colbwt_tpu_torch.io.fasta import read_fasta
    from colbwt_tpu_torch.io.pml_out import read_pml_cid_binary
    from colbwt_tpu_torch.models.index import ColPmlIndex
    from colbwt_tpu_torch.ops import _kernels as K
    from colbwt_tpu_torch.ops import oracle as O
    from colbwt_tpu_torch.ops import query_pos as TQ
    from colbwt_tpu_torch.pipeline import build_pipeline, query_stream
    from colbwt_tpu_torch.utils.config import ColBwtConfig, SplitMode
    from colbwt_tpu_torch.utils.hbm import resolve_pos_budget

    t0 = time.perf_counter()
    whole = doc_len == CONFIG4["doc_len"]
    cell = "SC4 whole" if whole else "SC4"
    work = WORK / "config4"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    muts = config4_muts(doc_len)
    docs, _ = config4_docs(doc_len, muts)
    files = []
    for i, d in enumerate(docs):
        files.append(work / f"hap{i}.fa")
        write_reads(files[-1], [(f"hap{i}", d)])
    listing = work / "haplotypes.txt"
    listing.write_text("".join(f"{f}\n" for f in files))
    n = sum(len(d) + 1 for d in docs)
    del docs
    pat = work / "reads.fa"
    with Beside(write_config4_reads, str(pat), doc_len, muts,
                n_reads) as maker:
        prefix = str(work / "config4")
        budget = 5 * n * 8
        forced = ({} if whole else
                  {"run_split": "always", "pos_hbm_budget": budget})
        log(f"[phase 15] config #4: {CONFIG4['docs']} haplotypes of {doc_len} "
            f"bp ({muts} substitutions each, n = {n}) written as FASTA files "
            f"and a file list in {time.perf_counter() - t0:.1f}s; "
            + ("decisions made by n" if whole else
               "forced through ColBwtConfig: " + json.dumps(forced)
               + " (the run split, as n > 2**28 makes it, and pos k = 1 over "
               "ACGT keys without the general T1, as 6·n > 2**31 - 1 makes "
               "it)"))
        min_mum = str(CONFIG4["min_mum"])
        if whole:
            def build():
                return cli_main(["build", "-i", str(listing), "-o", prefix,
                                 "-m", "tunnels", "-s", "10", "-l", min_mum,
                                 "--device", str(dev)])
        else:
            cfg = ColBwtConfig(mode=SplitMode.TUNNELS, split_rate=10,
                               min_mum=CONFIG4["min_mum"], prewarm=True,
                               **forced)

            def build():
                build_pipeline([], prefix, cfg, filelist=str(listing),
                               device=dev)
                return 0
        with Capture() as cap, TimedCalls(
                torch, "colbwt_tpu_torch.ops.colsplit",
                "tunneled_walk") as walks:
            v, lc_build = run_build("15", build, ("mum_window",
                                                  "tunneled_walk",
                                                  "build_t1_chunk"))
        require(cap.args is not None, "phase 15 did not run the device scan")
        t1 = time.perf_counter()
        check_build_walks(torch, walks, lc_build["tunneled_walk"], chk, cell)
        del walks
        C = min(1 << 26, 1 << max(13, (n - 1).bit_length()))
        check_chunks(torch, dev, cap.args, CONFIG4["docs"], C, chk,
                     f"{cell}", min_mum=CONFIG4["min_mum"])
        del cap
        index = ColPmlIndex.load(f"{prefix}.colpml.npz")
        tbl = load_table(prefix)
        _, ml, _ = F.read_col_mums(f"{prefix}.fa.col_mums")
        got = {"n": int(index.n), "bwt_r": int(index.bwt_r),
               "mums": int(ml.size), "marks": int(v["marks"]),
               "col_runs": int(tbl.char.size)}
        require(got["n"] == n, f"phase 15: n = {got['n']}, expected {n}")
        if whole:
            require(got == CONFIG4_LOG, f"phase 15: {got}, expected "
                    f"{CONFIG4_LOG} (logs/config4_r3.log)")
        require(index.ff_bound == 2 and index.r > got["col_runs"],
                f"phase 15: the index is not run-split (ff_bound "
                f"{index.ff_bound}, r = {index.r})")
        t1_chunks = check_t1_chunks(torch, dev, index, chk, f"{cell}'s index")
        log(f"[phase 15] build: " + json.dumps(got)
            + (" (as logs/config4_r3.log)" if whole else "")
            + f", run-split index r = {index.r} (ff_bound {index.ff_bound}); "
            f"K8's {-(-n // C)} chunks, K10a's buckets and K1's {t1_chunks} "
            f"chunks equal to their plain versions "
            f"({time.perf_counter() - t1:.1f}s)")

        log(f"[phase 15] {n_reads} + {CONFIG4['n_reads']} N reads written "
            f"beside the build, waited {maker.wait():.1f}s for")
        K.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        keys = STREAM_KEYS + ("device_mem_peak_bytes",)
        with EngineSpy() as spy, FirstCalls(
                "colbwt_tpu_torch.ops.query_pos", "query_chunk_pos") as k3, \
                FirstCalls("colbwt_tpu_torch.ops.query_xla",
                           "query_batch_device") as k4:
            if whole:
                q = run_logged(lambda: cli_main(
                    ["query", prefix, "-p", str(pat), "--stream", "--device",
                     str(dev)]), "colbwt_torch.stream", keys)
            else:  # the CLI's --stream batch, the budget forced
                qcfg = ColBwtConfig(batch_size=32768, pos_hbm_budget=budget)

                def stream():
                    query_stream(prefix, str(pat), qcfg, device=dev)
                    return 0
                q = run_logged(stream, "colbwt_torch.stream", keys)
        lc_query = dict(K.launches)
        require(len(spy.made) == 1, f"phase 15: {len(spy.made)} engines")
        eng = spy.made[0]
        pt = eng.pt or {}
        decided = {"engine": eng.name, "keys": str(pt.get("alphabet")),
                   "general_t1": pt.get("t1") is not None}
        require(decided == {"engine": "pos(k=1)", "keys": str(b"ACGT"),
                            "general_t1": False},
                f"phase 15: engine {decided}, expected pos(k=1) over ACGT "
                "keys without the general T1")
        table_bytes = nbytes(pt)
        loaded = any(ev["event"] == "load" for ev in eng.cache_events)
        for name in ("query_chunk_pos", "query_batch_xla",
                     "upload_rows" if loaded else "build_t1_chunk"):
            require(lc_query[name] > 0, f"{name} never launched in phase 15")
        require(q["reads"] == n_reads + CONFIG4["n_reads"],
                f"phase 15: {q['reads']} records")
        if loaded:  # K14 brought the tables: they must be a fresh build's
            fresh = TQ.build_pos_tables(
                index, 1, hbm_budget_bytes=resolve_pos_budget(
                    forced.get("pos_hbm_budget", 0), dev),
                alphabet=b"ACGT", device=dev)
            chk.equal("upload_rows", pt["table"], fresh["table"],
                      f"{cell}'s pos table from the cache")
            del fresh
        t1 = time.perf_counter()
        check_k3_chain(torch, k3, chk, cell)
        time_stream_scans(torch, k3, lc_query["query_chunk_pos"], chk, cell)
        rows = check_compact_calls(torch, k4, lc_query["query_batch_xla"],
                                   index.r, chk, cell)
        require(rows == CONFIG4["n_reads"],
                f"phase 15: K4 scanned {rows} reads, expected the "
                f"{CONFIG4['n_reads']} N reads")
        del spy, eng, pt, k3, k4
        torch.cuda.empty_cache()
        log(f"[phase 15] K3's and K4's shapes from the query equal to their "
            f"plain versions ({time.perf_counter() - t1:.1f}s)")

        t1 = time.perf_counter()
        names, pmls = read_pml_cid_binary(f"{pat}.split.pml.bin")
        _, cids = read_pml_cid_binary(f"{pat}.split.cid.bin")
        require(names == [f"q{i}" for i in range(n_reads)]
                + [f"n{i}" for i in range(CONFIG4["n_reads"])],
                "phase 15 record names differ")
        # 4 N reads: the oracle scans every run for an N (its successor and
        # predecessor runs, neither of which exists), 1-6 s a read
        rng = np.random.default_rng(0xC4C4)
        plain = np.sort(rng.choice(n_reads, 252, replace=False))
        with_n = n_reads + np.sort(rng.choice(CONFIG4["n_reads"], 4,
                                              replace=False))
        sample = np.concatenate([plain, with_n])
        picked = set(sample.tolist())
        reads = {i: r.seq for i, r in enumerate(read_fasta(pat))
                 if i in picked}
        want_p, want_c = native_lib.query_pml_serial(
            tbl, [reads[i] for i in sample])
        for j, i in enumerate(sample):
            require(np.array_equal(pmls[i], want_p[j])
                    and np.array_equal(cids[i], want_c[j]),
                    f"phase 15 record {names[i]} differs from the C++ "
                    "serial engine")
        for i in np.concatenate([plain[::32], with_n]):
            ep, ec = O.query_pml_oracle(tbl, reads[i])
            require(np.array_equal(pmls[i], ep)
                    and np.array_equal(cids[i], ec),
                    f"phase 15 record {names[i]} differs from the oracle")
        del names, pmls, cids, tbl, reads
        check_s = time.perf_counter() - t1
        out = {"doc_len": doc_len, "docs": CONFIG4["docs"], **got,
               "index_r": int(index.r), "forced": forced, "build": v,
               "engine": q.get("engine"), "decided": decided,
               "table_cache": q.get("table_cache"),
               "table_bytes": table_bytes,
               "table_build_s": q.get("table_build_s"),
               "reads": q["reads"], "query_wall_s": q["wall_s"],
               "reads_per_s": q["reads"] / q["wall_s"],
               "device_mem_peak_bytes": q.get("device_mem_peak_bytes"),
               "phase_s": time.perf_counter() - t0}
        log(f"[phase 15] query --stream, engine {q.get('engine')} (ACGT "
            f"keys, no general T1): {q['reads']} reads in "
            f"{q['wall_s']:.3f}s -> {out['reads_per_s']:.0f} reads/s, tables "
            f"{table_bytes} B in {q.get('table_build_s')}s (cache: "
            f"{json.dumps(q.get('table_cache'))}), device memory peak "
            f"{out['device_mem_peak_bytes']} B; 256 sampled records equal the "
            f"C++ serial engine, {plain[::32].size} of them and the "
            f"{with_n.size} N reads among them the oracle "
            f"({check_s:.1f}s); launches {json.dumps(lc_query)}")
        log("[config4] " + json.dumps(out))
    if not whole:
        shutil.rmtree(work, ignore_errors=True)
    return out, [lc_build, lc_query]


def phase15_chunked(torch, dev, cli_main, chk: Checks) -> tuple[dict, dict]:
    """`--config4 --sa-mode chunked`: config #4 built again through the
    chunked SA lane (`--sa-mode chunked --chunk-chars` CONFIG4_CHUNK_CHARS,
    4 chunks), K8's streamed chunks and K10a's buckets held to their plain
    versions; every artifact and the index byte-equal to the monolithic
    build `--config4` left under build/chip_smoke/config4/ (absent: a
    failure)."""
    from colbwt_tpu_torch.ops import construct as TC

    work = WORK / "config4"
    prefix = str(work / "config4")
    listing = work / "haplotypes.txt"
    need = ([f"{prefix}.{ext}" for ext in ARTIFACTS]
            + [f"{prefix}.colpml.npz", str(listing)])
    missing = [p for p in need if not Path(p).exists()]
    require(not missing, "--sa-mode chunked compares with the monolithic "
            f"build of `--config4`, run before it; missing: {missing}")
    pre = str(work / "config4_chunked")
    real = TC.mum_scan_chunk
    first, calls = [], [0]

    def checked(*args):
        got = real(*args)
        want = TC.mum_scan_chunk_ref(*args)
        what = f"SC4 chunked lane, chunk {calls[0]}"
        chk.equal("mum_window", got[0], want[0], what + " hits")
        chk.equal("mum_window", got[1], want[1], what + " ell")
        calls[0] += 1
        if not first:
            first.append(clone_args(torch, args))
        return got

    TC.mum_scan_chunk = checked
    try:
        with TimedCalls(torch, "colbwt_tpu_torch.ops.colsplit",
                        "tunneled_walk") as walks:
            v, lc = run_build("15c", lambda: cli_main(
                ["build", "-i", str(listing), "-o", pre, "-m", "tunnels",
                 "-s", "10", "-l", str(CONFIG4["min_mum"]), "--sa-mode",
                 "chunked", "--chunk-chars", str(CONFIG4_CHUNK_CHARS),
                 "--no-prewarm", "--device", str(dev)]),
                ("mum_window", "tunneled_walk"))
    finally:
        TC.mum_scan_chunk = real
    require(bool(first), "the chunked lane launched no K8 chunk")
    args = first[0]
    packed, ell = TC.mum_scan_chunk(*args)
    chk.time("mum_window", lambda: TC.mum_scan_chunk(*args),
             lambda: TC.mum_scan_chunk_ref(*args),
             f"SC4 chunked lane, its first streamed chunk ({args[3]} "
             f"window starts, N = {args[5]})",
             bound=(nbytes(args[:3], packed, ell), args[3] * 6 * args[5]))
    check_build_walks(torch, walks, lc["tunneled_walk"], chk,
                      "SC4 chunked lane")
    for ext in ARTIFACTS:
        require(same_bytes(f"{pre}.{ext}", f"{prefix}.{ext}"),
                f"--sa-mode chunked: .{ext} differs from the monolithic "
                "build's")
    require(same_index(f"{pre}.colpml.npz", f"{prefix}.colpml.npz"),
            "--sa-mode chunked: the index differs from the monolithic build's")
    log(f"[phase 15c] chunked SA lane (--chunk-chars {CONFIG4_CHUNK_CHARS}): "
        f"{len(ARTIFACTS)} artifacts and the index byte-equal to the "
        f"monolithic build's; K8's {calls[0]} streamed chunks equal to "
        "their plain version at their calls")
    return v, lc


def start_native_build() -> subprocess.Popen | None:
    """Start compiling the host library of native/ (SA-IS, Kasai and the
    chunked SA lane of the build; colbwt_tpu/io/native.py) with the
    Makefile's command, unless it is there; `finish_native_build` waits."""
    src = REPO / "native"
    if (src / "libcolbwt_native.so").exists():
        return None
    cxx = shutil.which("g++") or shutil.which("c++")
    require(cxx is not None, "no C++ compiler for native/")
    cmd = [cxx, "-O3", "-march=native", "-std=c++17", "-Wall", "-fPIC",
           "-fopenmp", "-shared", "-o", str(src / "libcolbwt_native.so"),
           *(str(src / f) for f in ("colbwt_native.cpp", "sais.cpp",
                                    "chunked.cpp"))]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def finish_native_build(proc: subprocess.Popen | None) -> None:
    from colbwt_tpu_torch.io import native as native_lib

    if proc is not None:
        _, err = proc.communicate()
        require(proc.returncode == 0,
                f"native build failed: {' '.join(proc.args)}\n{err[-4000:]}")
    require(native_lib.available(), "native library not loadable")


def load_table(prefix: str):
    """The col-PML table of the index built at `prefix` (its kept
    artifacts)."""
    from colbwt_tpu_torch.io import formats as F
    from colbwt_tpu_torch.ops import oracle as O

    heads, lens = F.read_rlbwt(f"{prefix}.fa")
    return O.build_col_pml(
        heads, lens, np.flatnonzero(F.read_sdsl_bit_vector(
            f"{prefix}.fa.col_runs")),
        F.read_col_ids(f"{prefix}.fa.col_ids").astype(np.int64),
        F.read_thresholds_file(f"{prefix}.fa.thr_pos").astype(np.int64))


def query_reads(docs: list[bytes], rng: np.random.Generator
                ) -> tuple[list[bytes], list[bytes], list[bytes]]:
    """bench.py's 262,144 reads of 150 bp; 1,024 of them with one N
    inserted; 16 reads of 5,000 bp from the haplotypes with 10
    substitutions each; drawn with `rng`."""
    from bench import DOC_LEN, N_READS, READ_LEN, make_reads

    reads = make_reads()
    n_reads = []
    for i in rng.choice(N_READS, 1024, replace=False):
        p = int(rng.integers(0, READ_LEN + 1))
        n_reads.append(reads[i][:p] + b"N" + reads[i][p:])
    long_reads = []
    for j in range(16):
        s = int(rng.integers(0, DOC_LEN - 5000))
        arr = bytearray(docs[j % len(docs)][s:s + 5000])
        for p in rng.integers(0, 5000, 10):
            arr[int(p)] = int(rng.choice(list(b"ACGT")))
        long_reads.append(bytes(arr))
    return reads, n_reads, long_reads


def run(torch) -> tuple[dict, list[dict]]:
    """Phases 2-13 on the card; returns the main path's metrics and the
    kernels' JSON entries.  Raises on any failed check."""
    from bench import N_READS, make_docs
    from colbwt_tpu_torch.io.fasta import FastaRecord, write_fasta
    from colbwt_tpu_torch.io.pml_out import read_pml_cid_binary
    from colbwt_tpu_torch.models.index import ColPmlIndex
    from colbwt_tpu_torch.ops import oracle as O
    from colbwt_tpu_torch.utils.config import ColBwtConfig, SplitMode
    from colbwt_tpu_torch.cli import main as cli_main
    from colbwt_tpu_torch.ops import _kernels as K
    from colbwt_tpu_torch.pipeline import build_pipeline

    dev = torch.device("cuda")
    # phase 2: the kernels and the host library, built side by side
    t0 = time.perf_counter()
    native = start_native_build()
    K.load()
    log(f"[phase 2] CUDA kernels built and loaded in "
        f"{time.perf_counter() - t0:.1f}s ({K.library_path().name})")
    finish_native_build(native)
    log(f"[phase 2] native host library "
        f"{'built' if native else 'present'} and loaded after "
        f"{time.perf_counter() - t0:.1f}s")

    # phase 3: bench's index on the device lane, the host lane, kernel checks
    shutil.rmtree(WORK, ignore_errors=True)
    WORK.mkdir(parents=True)
    docs = make_docs()
    fastas = []
    for i, d in enumerate(docs):
        fastas.append(str(WORK / f"hap{i}.fa"))
        write_fasta(fastas[-1], [FastaRecord(f"hap{i}", d)])
    cfg = ColBwtConfig(mode=SplitMode.TUNNELS, split_rate=10, min_mum=20,
                       keep_temp=True)
    prefix = str(WORK / "bench")

    def build3():
        build_pipeline(fastas, prefix, cfg, device=dev)
        return 0

    with Capture() as cap:
        v3, lc3 = run_build("3", build3, ("mum_window", "tunneled_walk"))
    require(cap.args is not None, "phase 3 did not run the device scan")
    build_s = v3["wall_s"]
    index = ColPmlIndex.load(f"{prefix}.colpml.npz")
    host3 = host_lane(prefix, cap.args, len(docs))
    log(f"[phase 3] device lane equals the host lane: multi-MUMs "
        f"{v3['mums_s']:.3f}s on the card vs {host3['mums_s']:.3f}s "
        f"O.find_multi_mums; col-split {v3['colsplit_s']:.3f}s vs "
        f"{host3['colsplit_s']:.3f}s host walk + sweep")
    chk = Checks(torch)
    t0 = time.perf_counter()
    check_build_kernels(torch, dev, prefix, cap.args, chk)
    log(f"[phase 3] K8-K10b equal to their plain versions "
        f"({time.perf_counter() - t0:.1f}s)")
    t0 = time.perf_counter()
    check_sa_kernels(torch, dev, prefix, cap.args, chk)
    del cap
    log(f"[phase 3] K11a, K11b, K12 equal to their plain versions, the "
        f"native SA and LCP and the host thresholds "
        f"({time.perf_counter() - t0:.1f}s)")
    tbl = load_table(prefix)
    log(f"[phase 3] index build {build_s:.1f}s: n={index.n} "
        f"r={index.r} bwt_r={index.bwt_r} sigma={index.sigma} "
        f"ff_bound={index.ff_bound}")

    t0 = time.perf_counter()
    rng = np.random.default_rng(0x5A0E)
    reads, n_reads, long_reads = query_reads(docs, rng)
    log(f"[phase 3] reads made in {time.perf_counter() - t0:.1f}s")

    t0 = time.perf_counter()
    split = check_kernels(torch, dev, index, tbl, reads, n_reads,
                          long_reads, chk)
    log(f"[phase 3] K1-K4 equal to their plain versions "
        f"({time.perf_counter() - t0:.1f}s)")
    t0 = time.perf_counter()
    check_fused_kernels(torch, dev, tbl, split, reads, n_reads, long_reads,
                        chk)
    del split
    log(f"[phase 3] K7, K14 equal to their plain versions "
        f"({time.perf_counter() - t0:.1f}s)")
    t0 = time.perf_counter()
    mega_tbl = scale_table(tbl, MEGA_SCALE)
    wide_tbl = scale_table(tbl, WIDE_SCALE)
    wide_index = check_mega_kernels(torch, dev, mega_tbl, wide_tbl, reads,
                                    n_reads, long_reads, chk)
    log(f"[phase 3] K5, K6a-K6c equal to their plain versions "
        f"({time.perf_counter() - t0:.1f}s)")

    # phase 4: main path, a large query, through the CLI
    records = ([(f"r{i}", s) for i, s in enumerate(reads)]
               + [(f"n{i}", s) for i, s in enumerate(n_reads)]
               + [(f"l{i}", s) for i, s in enumerate(long_reads)])
    pat = WORK / "reads.fa"
    write_reads(pat, records)
    K.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    v = run_query(lambda: cli_main(["query", prefix, "-p", str(pat)]))
    launches4 = dict(K.launches)
    peak = torch.cuda.max_memory_allocated()
    require(v.get("engine") == "pos(k=4)",
            f"main path engine {v.get('engine')}, expected pos(k=4)")
    for name in ("build_t1_chunk", "compose_tables", "query_chunk_pos"):
        require(launches4[name] > 0, f"{name} never launched in phase 4")
    names, pmls = read_pml_cid_binary(f"{pat}.split.pml.bin")
    _, cids = read_pml_cid_binary(f"{pat}.split.cid.bin")
    require(names == [r[0] for r in records], "record names/order differ")
    sample = (sorted(rng.choice(N_READS, 208, replace=False).tolist())
              + [N_READS + int(i) for i in rng.choice(1024, 32,
                                                      replace=False)]
              + list(range(N_READS + 1024, len(records))))
    t0 = time.perf_counter()
    for i in sample:
        ep, ec = O.query_pml_oracle(tbl, records[i][1])
        require(np.array_equal(pmls[i], ep) and np.array_equal(cids[i], ec),
                f"record {records[i][0]} differs from the oracle")
    n_total = len(records)
    main_path = {
        "engine": v["engine"], "reads": n_total,
        "read_s": v["read_s"], "table_cache": v.get("table_cache"),
        "table_build_s": v["table_build_s"],
        "table_save_s": v["table_save_s"],
        "scan_s": v["scan_s"], "write_s": v["write_s"],
        "query_wall_s": v["wall_s"],
        "reads_per_s": n_total / v["wall_s"],
        "scan_reads_per_s": n_total / v["scan_s"],
        "device_mem_peak_bytes": peak,
        "index_build_s": build_s,
    }
    log(f"[phase 4] engine {v['engine']}: {n_total} reads, table build "
        f"{v['table_build_s']:.3f}s, scan {v['scan_s']:.3f}s, CLI wall "
        f"{v['wall_s']:.3f}s -> {main_path['reads_per_s']:.0f} reads/s "
        f"(scan only {main_path['scan_reads_per_s']:.0f} reads/s), device "
        f"memory peak {peak} B; {len(sample)} sampled records equal the "
        f"oracle ({time.perf_counter() - t0:.1f}s); launches "
        f"{json.dumps(launches4)}")

    # phase 5: main path, a small query (under the ladder's 1M characters),
    # with the default engine choice
    sel = ([44 * i for i in range(N_READS // 44)]
           + [N_READS + i for i in range(32)]
           + [N_READS + 1024 + i for i in range(8)])
    chars5 = sum(len(records[i][1]) for i in sel)
    require(chars5 < 1_000_000, f"phase 5 query has {chars5} characters")
    pat5 = WORK / "reads_small.fa"
    write_reads(pat5, [records[i] for i in sel])
    K.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    v5 = run_query(lambda: cli_main(["query", prefix, "-p", str(pat5)]))
    launches5 = dict(K.launches)
    peak5 = torch.cuda.max_memory_allocated()
    require(v5.get("engine") == "xla",
            f"phase 5 engine {v5.get('engine')}, expected xla")
    require(launches5["query_batch_xla"] > 0,
            "query_batch_xla never launched in phase 5")
    names5, pmls5 = read_pml_cid_binary(f"{pat5}.split.pml.bin")
    _, cids5 = read_pml_cid_binary(f"{pat5}.split.cid.bin")
    require(names5 == [records[i][0] for i in sel], "phase 5 names differ")
    for j, i in enumerate(sel):
        require(np.array_equal(pmls5[j], pmls[i])
                and np.array_equal(cids5[j], cids[i]),
                f"phase 5 record {records[i][0]} differs from phase 4")
    log(f"[phase 5] engine {v5['engine']}: {len(sel)} reads ({chars5} "
        f"characters) in {v5['wall_s']:.3f}s (scan {v5['scan_s']:.3f}s), "
        f"device memory peak {peak5} B, records equal phase 4's; launches "
        f"{json.dumps(launches5)}")
    log("[main path] " + json.dumps(main_path))

    # phases 6-7: the mega and mega-wide paths, the same reads through the
    # CLI with the default engine choice on the scaled indexes
    all_names = [r[0] for r in records]

    def oracle_check(scaled):
        def check(pm, ci):
            for i in sample:
                ep, ec = O.query_pml_oracle(scaled, records[i][1])
                require(np.array_equal(pm[i], ep)
                        and np.array_equal(ci[i], ec),
                        f"record {records[i][0]} differs from the oracle")
            return f"{len(sample)} sampled records equal the oracle"
        return check

    paths = {}
    launches = [launches4, launches5]
    for tag, name, engine, scaled, needed in (
            ("6", "mega", "mega", mega_tbl, ("query_chunk_mega",)),
            ("7", "megawide", "mega-wide", wide_tbl,
             ("query_chunk_mega_wide", "fill_block_wide"))):
        p = WORK / f"reads_{name}.fa"
        shutil.copy(pat, p)
        m, lc, pm, ci = mega_phase(
            torch, tag, lambda: cli_main(["query", str(WORK / name), "-p",
                                          str(p)]),
            p, all_names, oracle_check(scaled), engine, needed)
        paths[engine] = m
        launches.append(lc)
    pm7, ci7 = pm, ci
    del mega_tbl, wide_tbl, pm, ci

    # phase 7b: phase 5's small query on the mega-wide index through the
    # library entry point, with a memory budget one byte under the full
    # table, so the ladder builds the compact layout (K6b, K6c)
    from colbwt_tpu_torch.ops.query_mega_wide import wide_table_bytes
    from colbwt_tpu_torch.pipeline import query_pipeline

    p7b = WORK / "reads_small_compact.fa"
    shutil.copy(pat5, p7b)
    cfg7b = ColBwtConfig(pos_hbm_budget=wide_table_bytes(wide_index) - 1)

    def same_as_phase7(pm7b, ci7b):
        for j, i in enumerate(sel):
            require(np.array_equal(pm7b[j], pm7[i])
                    and np.array_equal(ci7b[j], ci7[i]),
                    f"phase 7b record {records[i][0]} differs from phase 7")
        return "records equal phase 7's"

    def query7b():
        query_pipeline(str(WORK / "megawide"), str(p7b), cfg7b, device=dev)
        return 0

    m, lc, _, _ = mega_phase(
        torch, "7b", query7b, p7b, [records[i][0] for i in sel],
        same_as_phase7, "mega-wide",
        ("query_chunk_mega_wide", "fill_block_wide", "shared_table_wide"))
    # the entry phase 7 may have saved holds the full layout: a miss here
    require(m["table_cache"] is None
            or m["table_cache"]["event"].startswith("build"),
            f"phase 7b: the compact layout was not built ({m['table_cache']})")
    paths["mega-wide compact"] = m
    launches.append(lc)
    log("[mega paths] " + json.dumps(paths))

    # phase 9: the fused engine at full size through the CLI, on bench's
    # table run-split with ff_bound 2 (saved in phase 3)
    p9 = WORK / "reads_fused.fa"
    shutil.copy(pat, p9)
    fused = {}
    fused["9"], lc, _, _ = mega_phase(
        torch, "9", lambda: cli_main(["query", str(WORK / "fused"), "-p",
                                      str(p9), "--engine", "fused"]),
        p9, all_names, oracle_check(tbl), "fused",
        ("query_batch_fused", "upload_rows"))
    launches.append(lc)

    # phase 9b: phase 5's small query under the default engine on the
    # ff_bound 1 index: the ladder picks the fused engine by itself
    p9b = WORK / "reads_small_fused.fa"
    shutil.copy(pat5, p9b)

    def same_as_phase5(pm, ci):
        for j, i in enumerate(sel):
            require(np.array_equal(pm[j], pmls5[j])
                    and np.array_equal(ci[j], cids5[j]),
                    f"phase 9b record {records[i][0]} differs from phase 5")
        return "records equal phase 5's"

    fused["9b"], lc, _, _ = mega_phase(
        torch, "9b", lambda: cli_main(["query", str(WORK / "fused1"), "-p",
                                       str(p9b)]),
        p9b, [records[i][0] for i in sel], same_as_phase5, "fused",
        ("query_batch_fused", "upload_rows"))
    launches.append(lc)

    # phase 10: `query --stream` over phase 4's reads, on bench's index
    # (pos, k=4) and with --engine fused on phase 9's: the files must be
    # byte-equal to phases 4 and 9
    for tag, index_prefix, extra, ref, engine, needed in (
            ("10", prefix, [], pat, "pos(k=4)",
             ("build_t1_chunk", "compose_tables", "query_chunk_pos")),
            ("10b", str(WORK / "fused"), ["--engine", "fused"], p9, "fused",
             ("query_batch_fused", "upload_rows"))):
        p10 = WORK / f"reads_stream{tag}.fa"
        shutil.copy(pat, p10)
        with FirstCalls("colbwt_tpu_torch.ops.query_pos",
                        "query_chunk_pos") as k3:
            fused[tag], lc = stream_phase(
                torch, tag, lambda: cli_main(["query", index_prefix, "-p",
                                              str(p10), "--stream", *extra]),
                p10, ref, engine, needed, main_path["reads_per_s"])
        launches.append(lc)
        if tag == "10":
            time_stream_scans(torch, k3, lc["query_chunk_pos"], chk)
        del k3
    log("[fused and stream paths] " + json.dumps(fused))

    # phases 8-8c: the build path through the CLI; 11-11c: without the
    # native library
    v8, lc8 = phase8(torch, dev, cli_main, chk)
    # K1 at phase 8's index: its r-sized arrays outgrow the 50 MB L2
    check_t1_chunks(torch, dev, ColPmlIndex.load(
        str(WORK / "pangenome.colpml.npz")), chk, "phase 8's index")
    v8bc, lc8bc = phase8bc(dev, cli_main, fastas, prefix)
    v11, lc11 = phase11(dev, cli_main, fastas, prefix, v3)
    v11b, lc11b = phase11b(torch, dev, str(WORK / "pangenome"), v8, chk)
    v11c, lc11c = phase11c(torch, dev, docs, tbl)
    launches += [lc3, lc8, *lc8bc, lc11, lc11b, lc11c]

    # phase 12: the sharded query API, ip shards on the one card
    walls12, lc12 = phase12(torch, dev, index, wide_index,
                            reads + n_reads, long_reads, (pmls, cids),
                            (pm7, ci7), chk)
    launches += lc12
    log("[sharded paths] " + json.dumps(walls12))

    # phase 13: the table cache and prewarm on the indexes phases 6-7
    # saved, and the main path's query under the profiler
    v13, lc13 = phase13(torch, dev, cli_main, prefix, pat, wide_index,
                        paths["mega"]["table_cache"],
                        paths["mega-wide"]["table_cache"],
                        {"A query": main_path["table_cache"],
                         "A stream": fused["10"]["table_cache"]})
    launches += lc13
    log("[cache and profile] " + json.dumps(v13))

    # phase 14: config #3 through the CLI, at the smoke's cuts
    _, lc14 = phase14(torch, dev, cli_main, chk, CONFIG3_SMOKE["doc_len"],
                      CONFIG3_SMOKE["reads"])
    launches += lc14
    # phase 15: config #4 through the entry points, at the smoke's cuts
    _, lc15 = phase15(torch, dev, cli_main, chk, CONFIG4_SMOKE["doc_len"],
                      CONFIG4_SMOKE["reads"])
    launches += lc15
    log("[build path] " + json.dumps(
        {"phase3_device": v3, "phase3_host": host3, "phase8": v8,
         "phase8b": v8bc["8b"], "phase8c": v8bc["8c"], "phase11": v11,
         "phase11b": v11b, "phase11c": v11c}))

    return main_path, kernel_entries(chk, launches, KERNEL_INFO)


def kernel_entries(chk: Checks, launches: list[dict], names) -> list[dict]:
    """The {"kernels": ...} line's entries of the kernels `names`: launches
    summed over `launches`, the error and times `chk` kept."""
    out = []
    for name in names:
        tag, src, replaces = KERNEL_INFO[name]
        out.append({"name": f"{tag} {name}", "route": "cuda", "source": src,
                    "replaces": replaces,
                    "launches": sum(lc[name] for lc in launches),
                    "max_abs_err": chk.err[name], **chk.ms[name]})
    return out


def phase2_alone() -> None:
    """Phase 2 for a run of one phase: the kernels and the host library."""
    from colbwt_tpu_torch.ops import _kernels as K

    t0 = time.perf_counter()
    native = start_native_build()
    K.load()
    finish_native_build(native)
    log(f"[phase 2] CUDA kernels and the native host library ready in "
        f"{time.perf_counter() - t0:.1f}s")
    WORK.mkdir(parents=True, exist_ok=True)


def run_config3(torch) -> list[dict]:
    """Phases 2 and 14 alone, config #3 whole; returns the large-N route's
    JSON entry."""
    from colbwt_tpu_torch.cli import main as cli_main

    phase2_alone()
    chk = Checks(torch)
    _, lc14 = phase14(torch, torch.device("cuda"), cli_main, chk,
                      CONFIG3["doc_len"], CONFIG3["reads"])
    return kernel_entries(chk, lc14, ["mum_window_two_pass"])


def run_config4(torch, chunked: bool) -> list[dict]:
    """Phases 2 and 15 alone, config #4 whole; with `chunked` its build
    through the chunked SA lane against the one `--config4` left.  Returns
    the JSON entries of the kernels it held to their plain versions."""
    from colbwt_tpu_torch.cli import main as cli_main

    phase2_alone()
    chk = Checks(torch)
    dev = torch.device("cuda")
    if chunked:
        _, lc = phase15_chunked(torch, dev, cli_main, chk)
        launches = [lc]
    else:
        _, launches = phase15(torch, dev, cli_main, chk, CONFIG4["doc_len"],
                              CONFIG4["reads"])
    return kernel_entries(chk, launches,
                          [name for name in KERNEL_INFO if name in chk.ms])


def main() -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config3", action="store_true",
                    help="phase 14 alone, config #3 whole (%d genomes of %d "
                         "bp, %d reads)" % (CONFIG3["docs"],
                                            CONFIG3["doc_len"],
                                            CONFIG3["reads"]))
    ap.add_argument("--config4", action="store_true",
                    help="phase 15 alone, config #4 whole (%d haplotypes of "
                         "%d bp, %d + %d reads); its build is left for "
                         "--sa-mode chunked" % (
                             CONFIG4["docs"], CONFIG4["doc_len"],
                             CONFIG4["reads"], CONFIG4["n_reads"]))
    ap.add_argument("--sa-mode", choices=("monolithic", "chunked"),
                    default="monolithic",
                    help="with --config4: chunked builds config #4 through "
                         "the chunked SA lane and holds it byte-equal to the "
                         "monolithic build a --config4 run left")
    args = ap.parse_args()
    if args.sa_mode == "chunked" and not args.config4:
        ap.error("--sa-mode chunked goes with --config4")
    if args.config3 and args.config4:
        ap.error("--config3 and --config4 run apart")
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "test needs an NVIDIA GPU", file=sys.stderr)
        return 1
    # phase 1: the card
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(card)
    log(f"[phase 1] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    sys.path.insert(0, str(REPO))
    if args.config3:
        kernels = run_config3(torch)
    elif args.config4:
        kernels = run_config4(torch, args.sa_mode == "chunked")
    else:
        _, kernels = run(torch)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
