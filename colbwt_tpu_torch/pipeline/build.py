"""Build pipeline and one-shot query pipeline — port of
colbwt_tpu/pipeline/build.py.

`build_pipeline` writes the same artifacts as the JAX package's
(PREFIX.fa.bwt.heads/.bwt.len/.thr_pos/.col_mums, PREFIX.lengths,
PREFIX.fa.col_runs/.col_ids, PREFIX.fa.col_pml, PREFIX.colpml.npz), with
the same stage skipping and cleanup, and routes every stage as the JAX
package does, the device stages on `device` (default cuda):

  stage_mums      monolithic lane: SA and LCP by native SA-IS + Kasai on
                  the host; without the native library, by
                  ops/construct.suffix_array and lcp_from_pyramid on the
                  device when n >= _DEVICE_MIN_N (kernels K11a, K11b),
                  else by the host oracle; multi-MUMs by
                  ops/construct.find_multi_mums on the device when
                  n >= _DEVICE_MIN_N and N >= 2 (kernel K9 below
                  construct._CHUNKED_SCAN_MIN_N, K8 from there), else the
                  host oracle; thresholds on the host.
                  chunked lane (sa_mode="chunked", or "auto" beyond the
                  host SA budget): chunked RLBWT + LCP on the host
                  (ops/construct_chunked.py), multi-MUMs by the
                  in-process streamed K8 scan (ops/mum_scan_stream.py)
  stage_bwt       the plain BWT file, as the JAX package writes it
  stage_colsplit  n >= 2**31: the host int64 walkers; else, when
                  n >= _DEVICE_MIN_N or there are more than 256 MUMs,
                  ops/colsplit.col_split on the device (K10a tunnels, K10b
                  all with N <= 64, the host walk for all with N > 64);
                  else the oracle
  stage_index     as the JAX package, with this port's memory budget

  stage_prewarm   with cfg.prewarm (the CLI's default): the engine a
                  large query picks, its tables built and, where the
                  table cache pays, saved under PREFIX.torch_tables

`build_pipeline` attaches each stage's seconds to its log records
(`sa_lcp_s`, `bwt_s`, `mums_s`, `thresholds_s`, `colsplit_s`, `index_s`,
`prewarm_s`, `build_s`; `build_s` includes the prewarm) with the counts
`mums` and `marks`.  `query_pipeline` runs the query on the device through
pipeline/engines.py.
"""

from __future__ import annotations

import contextlib
import gc
import shutil
import time
from pathlib import Path

import numpy as np
import torch

from colbwt_tpu_torch.io import formats as F
from colbwt_tpu_torch.io.fasta import read_fasta, reverse_complement
from colbwt_tpu_torch.io.pml_out import (write_pml_cid_binary,
                                         write_pml_cid_text,
                                         write_pml_cid_text_long)
from colbwt_tpu_torch.models.index import ColPmlIndex
from colbwt_tpu_torch.ops import oracle as O
from colbwt_tpu_torch.utils.config import ColBwtConfig
from colbwt_tpu_torch.utils.log import (Timer, device_mem_peak, get_logger,
                                        status)
from colbwt_tpu_torch.ops import construct as TC
from colbwt_tpu_torch.ops import colsplit as TCS
from colbwt_tpu_torch.utils.device import resolve_device
from colbwt_tpu_torch.utils.hbm import (resolve_pos_budget,
                                        resolve_sa_budget_chars)
from colbwt_tpu_torch.utils.profiling import StepTimer

# below this n the host oracle beats device dispatch for construction
# (colbwt_tpu/pipeline/build.py:40)
_DEVICE_MIN_N = 1 << 18
# the one-shot query warns from this many reads held in host memory
# (colbwt_tpu/pipeline/build.py:487-491)
LARGE_QUERY_READS = 1_000_000


def _exists(*paths: Path) -> bool:
    return all(p.exists() for p in paths)


def _cleanup(paths: list[Path]) -> None:
    for p in paths:
        p.unlink(missing_ok=True)


@contextlib.contextmanager
def _timed(logger, key: str, what: str):
    """Log `what` with its seconds, attached to the record as `key`; the
    stage is a recorder span named `key`, so a profiler's trace shows it
    beside the card's work."""
    rec = StepTimer()
    with rec.stage(key):
        yield
    s = rec.stages[key]
    logger.info("%s in %.3fs", what, s, extra={key: s})


def load_documents(fastas: list[str], filelist: str | None,
                   rev_comp: bool) -> list[bytes]:
    """Collect one document per FASTA file (records concatenated), with
    optional reverse complements appended (scripts/col-bwt.py:109-139);
    colbwt_tpu/pipeline/build.py:52 as it is."""
    files = list(fastas)
    if filelist:
        files = []
        for line in Path(filelist).read_text().splitlines():
            if line.strip():
                files.append(line.split()[0])
    docs = []
    for f in files:
        seq = b"".join(rec.seq for rec in read_fasta(f))
        if rev_comp:
            seq = seq + reverse_complement(seq)
        docs.append(seq.upper())
    return docs


def _write_mums_artifacts(fa: str, prefix: str, docs: list[bytes], heads,
                          lens, thr, ml, mp, cfg: ColBwtConfig) -> None:
    F.write_rlbwt(fa, heads, lens, cfg.rw_bytes)
    F.write_thresholds_file(f"{fa}.thr_pos", thr, cfg.rw_bytes)
    F.write_col_mums(f"{fa}.col_mums", len(docs), ml, mp, cfg.rw_bytes)
    Path(f"{prefix}.lengths").write_text(
        "".join(f"{len(d)}\n" for d in docs))


def stage_mums(docs: list[bytes], prefix: str, cfg: ColBwtConfig, logger,
               device: torch.device):
    """SA/LCP -> RLBWT + thresholds + multi-MUMs, written to the mumemto
    file contracts."""
    fa = f"{prefix}.fa"
    outs = [Path(f"{fa}.bwt.heads"), Path(f"{fa}.bwt.len"),
            Path(f"{fa}.thr_pos"), Path(f"{fa}.col_mums"),
            Path(f"{prefix}.lengths")]
    if _exists(*outs) and not cfg.force:
        logger.info("[mums] artifacts exist, skipping")
        return
    try:
        from colbwt_tpu_torch.io import native as native_lib

        n_total = sum(len(d) + 1 for d in docs)
        sa_budget = resolve_sa_budget_chars(cfg.sa_ram_chars)
        if cfg.sa_mode == "chunked" or (cfg.sa_mode == "auto"
                                        and n_total > sa_budget):
            if not native_lib.available():
                raise RuntimeError(
                    "chunked construction needs the native library "
                    "(make -C native); monolithic SA at this n would need "
                    f"~{n_total * 40 / 1e9:.0f} GB of host RAM")
            _stage_mums_chunked(docs, prefix, cfg, logger, sa_budget, device)
            return
        text, ranks, doc_ids = O.concat_collection(docs)
        n = text.size
        use_device = n >= _DEVICE_MIN_N
        with _timed(logger, "sa_lcp_s", "[mums] suffix array + LCP"):
            # native SA-IS, then the device's prefix doubling, then the
            # host oracle (colbwt_tpu/pipeline/build.py:100-116)
            if native_lib.available():
                sa = native_lib.suffix_array_sais(ranks)
                lcp = native_lib.lcp_kasai(ranks, sa)
            elif use_device:
                sa_t, _, pyr = TC.suffix_array(ranks, with_pyramid=True,
                                               device=device)
                lcp = TC.lcp_from_pyramid(ranks, sa_t, pyr).cpu().numpy()
                sa = sa_t.cpu().numpy()
                del sa_t, pyr
            else:
                sa = O.suffix_array(ranks)
                lcp = O.lcp_kasai(ranks, sa)
        with _timed(logger, "bwt_s", "[mums] BWT + RLE"):
            heads, lens = O.rle(O.bwt_from_sa(text, sa))
        with _timed(logger, "mums_s", "[mums] multi-MUMs"):
            if use_device and len(docs) >= 2:
                ml, mp = TC.find_multi_mums(
                    ranks, sa, lcp, doc_ids, len(docs), cfg.min_mum,
                    log=lambda m: logger.info("[mums] %s", m), device=device)
            else:
                ml, mp = O.find_multi_mums(ranks, sa, lcp, doc_ids,
                                           len(docs), cfg.min_mum)
        with _timed(logger, "thresholds_s", "[mums] thresholds"):
            thr = (O.compute_thresholds_fast(heads, lens, lcp) if use_device
                   else O.compute_thresholds(heads, lens, lcp))
        _write_mums_artifacts(fa, prefix, docs, heads, lens, thr, ml, mp, cfg)
        logger.info("[mums] n=%d runs=%d multi-MUMs=%d", n, heads.size,
                    ml.size, extra={"mums": int(ml.size)})
    except Exception:
        _cleanup(outs)
        raise


def _stage_mums_chunked(docs: list[bytes], prefix: str, cfg: ColBwtConfig,
                        logger, sa_budget: int, device: torch.device):
    """stage_mums by chunked construction (colbwt_tpu/pipeline/build.py:145
    _stage_mums_chunked): per-chunk SA-IS + rank merge into the RLBWT, LCP
    from the RLBWT, then the streamed multi-MUM scan on `device`.  The
    RLBWT and LCP sub-stages cache their results under
    PREFIX.chunked_cache (temp name, then rename), so a killed build
    resumes; the cache goes once the stage's artifacts are written."""
    from colbwt_tpu_torch.ops import construct_chunked as CC
    from colbwt_tpu_torch.ops import mum_scan_stream as MS

    fa = f"{prefix}.fa"
    n_total = sum(len(d) + 1 for d in docs)
    chunk = cfg.chunk_chars or max(1, sa_budget // 2)
    logger.info("[mums] chunked construction: n=%d chunk=%d", n_total, chunk)

    text = np.empty(n_total, dtype=np.uint8)
    doc_starts = np.zeros(len(docs) + 1, dtype=np.int64)
    pos = 0
    for i, d in enumerate(docs):
        arr = np.frombuffer(d, dtype=np.uint8)
        text[pos:pos + arr.size] = arr
        text[pos + arr.size] = CC.TERMINATOR
        pos += arr.size + 1
        doc_starts[i + 1] = pos

    ck = Path(f"{prefix}.chunked_cache")
    ck.mkdir(parents=True, exist_ok=True)
    fprint = CC._input_fingerprint(text, doc_starts, True)
    rle_f = ck / f"rlbwt.{fprint}.npz"
    with _timed(logger, "bwt_s", "[mums] chunked RLBWT + doc array"):
        heads = None
        if rle_f.exists():
            try:
                z = np.load(rle_f)
                heads, lens = z["heads"], z["lens"]  # doc_of stays on disk
                logger.info("[mums] chunked RLBWT loaded from stage cache")
            except Exception:
                logger.warning("[mums] corrupt RLBWT stage cache — "
                               "rebuilding")
                rle_f.unlink(missing_ok=True)
        if heads is None:
            heads, lens, doc_of = CC.build_rlbwt_chunked(
                text, doc_starts, chunk,
                log=lambda m: logger.info("[mums] %s", m), cache_dir=ck,
                fingerprint=fprint)
            tmp = rle_f.with_suffix(".tmp.npz")
            np.savez(tmp, heads=heads, lens=lens, doc_of=doc_of)
            tmp.rename(rle_f)
            del doc_of
    del text
    gc.collect()
    lcp_f = ck / f"lcp32.{fprint}.npy"
    with _timed(logger, "sa_lcp_s", "[mums] LCP from the RLBWT"):
        lcp_cached = False
        if lcp_f.exists():
            try:
                np.load(lcp_f, mmap_mode="r")  # header + length check
                lcp_cached = True
                logger.info("[mums] LCP stage cache on disk (memmap)")
            except Exception:
                logger.warning("[mums] corrupt LCP stage cache — rebuilding")
                lcp_f.unlink(missing_ok=True)
        if not lcp_cached:
            lcp32 = CC.lcp_chunked(heads, lens, len(docs))
            tmp = lcp_f.with_suffix(".tmp.npy")
            np.save(tmp, lcp32)
            tmp.rename(lcp_f)
            del lcp32
            gc.collect()
    lcp32 = np.load(lcp_f, mmap_mode="r")
    with _timed(logger, "thresholds_s", "[mums] thresholds"):
        thr = O.compute_thresholds_fast(heads, lens, lcp32)
    del lcp32
    with _timed(logger, "mums_s", "[mums] multi-MUMs (streamed)"):
        if len(docs) >= 2:
            doc_f = ck / f"doc_of.{fprint}.u16.npy"
            rc_f = ck / f"rc.{fprint}.bits.npy"
            if not rc_f.exists():
                MS.write_run_change_bits(heads, lens, rc_f)
            if not doc_f.exists():
                MS.extract_npz_member(rle_f, "doc_of.npy", doc_f)
            ml, mp = MS.find_multi_mums_streamed(
                lcp_f, doc_f, rc_f, len(docs), cfg.min_mum,
                progress_path=ck / f"mumscan.{fprint}.npz",
                log=lambda m: logger.info("[mums] %s", m), device=device)
        else:
            ml = np.empty(0, dtype=np.int64)
            mp = np.empty(0, dtype=np.int64)

    _write_mums_artifacts(fa, prefix, docs, heads, lens, thr, ml, mp, cfg)
    shutil.rmtree(ck, ignore_errors=True)  # stage artifacts now authoritative
    logger.info("[mums] n=%d runs=%d multi-MUMs=%d (chunked)", n_total,
                heads.size, ml.size, extra={"mums": int(ml.size)})


def stage_bwt(prefix: str, cfg: ColBwtConfig, logger):
    """Expand the RLBWT to PREFIX.fa.bwt (src/rlbwt_to_bwt.cpp:22-27);
    colbwt_tpu/pipeline/build.py:262 as it is."""
    fa = f"{prefix}.fa"
    out = Path(f"{fa}.bwt")
    if out.exists() and not cfg.force:
        logger.info("[bwt] exists, skipping")
        return
    try:
        heads, lens = F.read_rlbwt(fa, cfg.rw_bytes)
        F.write_plain_bwt(out, heads, lens)
    except Exception:
        _cleanup([out])
        raise


def stage_colsplit(prefix: str, cfg: ColBwtConfig, logger,
                   device: torch.device):
    """FL walk + interval sweep -> .col_runs + .col_ids
    (src/col_split.cpp:62-141), routed as colbwt_tpu/pipeline/build.py:277
    stage_colsplit."""
    from colbwt_tpu_torch.ops.colruns_vec import (find_col_runs_mixed,
                                                  find_col_runs_uniform)

    fa = f"{prefix}.fa"
    outs = [Path(f"{fa}.col_runs"), Path(f"{fa}.col_ids")]
    if _exists(*outs) and not cfg.force:
        logger.info("[colsplit] artifacts exist, skipping")
        return
    t0 = time.perf_counter()
    try:
        heads, lens = F.read_rlbwt(fa, cfg.rw_bytes)
        num_docs, ml, mp = F.read_col_mums(f"{fa}.col_mums", cfg.rw_bytes)
        fl = O.build_fl_table(heads, lens)
        wide = fl.n > min(cfg.wide_n_limit, 2**31 - 1)
        tunneled = cfg.mode.value in ("tunnels", "tunneled")
        with status("col-split FL walk", logger):
            if wide and tunneled:
                # device walker positions are int32
                mpos, mids, mhts = TCS.col_split_tunneled_numpy(
                    fl, ml, mp, num_docs, cfg.split_rate, cfg.id_bits)
            elif wide:
                mpos, mids, mhts = TCS.col_split_all_numpy(
                    fl, ml, mp, num_docs, cfg.split_rate, cfg.id_bits)
            elif fl.n >= _DEVICE_MIN_N or ml.size > 256:
                mpos, mids, mhts = TCS.col_split(
                    fl, ml, mp, num_docs, cfg.split_rate, cfg.mode.value,
                    cfg.id_bits, device=device)
            else:
                mpos, mids, mhts = O.col_split_oracle(
                    fl, ml, mp, num_docs, cfg.split_rate, cfg.mode.value,
                    cfg.id_bits)
        with status("find_col_runs sweep", logger):
            if mhts.size and (mhts == mhts[0]).all():
                bits, ids = find_col_runs_uniform(mpos, mids, int(mhts[0]),
                                                  fl.l_heads, fl.n)
            else:
                bits, ids = find_col_runs_mixed(mpos, mids, mhts,
                                                fl.l_heads, fl.n)
        bv = np.zeros(fl.n, dtype=bool)
        bv[bits] = True
        F.write_sdsl_bit_vector(outs[0], bv)
        F.write_col_ids(outs[1], ids, (cfg.id_bits + 7) // 8, cfg.id_bits)
        s = time.perf_counter() - t0
        logger.info("[colsplit] marks=%d col_runs bits=%d in %.3fs",
                    mpos.size, bits.size, s,
                    extra={"marks": int(mpos.size), "colsplit_s": s})
    except Exception:
        _cleanup(outs)
        raise


def stage_index(prefix: str, cfg: ColBwtConfig, logger,
                device: torch.device):
    """Assemble the queryable index (the movi-split build role).  Run
    splitting serves the mega and mega-wide engines, so it is skipped, as in
    the JAX package, whenever the pos tables fit the budget of `device` and
    the index is not wide."""
    fa = f"{prefix}.fa"
    out = Path(f"{prefix}.colpml.npz")
    col_pml_out = Path(f"{fa}.col_pml")
    if _exists(out, col_pml_out) and not cfg.force:
        logger.info("[index] exists, skipping")
        return
    try:
        heads, lens = F.read_rlbwt(fa, cfg.rw_bytes)
        thr = F.read_thresholds_file(f"{fa}.thr_pos", cfg.rw_bytes)
        bv = F.read_sdsl_bit_vector(f"{fa}.col_runs")
        ids = F.read_col_ids(f"{fa}.col_ids", (cfg.id_bits + 7) // 8)
        with status("col_pml table", logger):
            tbl = O.build_col_pml(heads, lens, np.flatnonzero(bv),
                                  ids.astype(np.int64), thr.astype(np.int64))
        # the reference's .col_pml rows hold an offset into a run in 2 bytes
        # (LEN_BYTES): a table with an offset past 65,535 (config #3's
        # 10,000 near-identical genomes have them) gets no such file; the
        # index keeps int64 fields and goes on
        offset_max = int(np.max(tbl.dest_offset, initial=0))
        if offset_max < 1 << 16:
            F.write_col_pml_file(
                f"{fa}.col_pml", bwt_r=int(tbl.bwt_r), n=int(tbl.n),
                char=tbl.char, idx=tbl.idx,
                dest_interval=tbl.dest_interval,
                dest_offset=tbl.dest_offset, col_id=tbl.col_id,
                threshold=tbl.threshold)
        else:
            col_pml_out.unlink(missing_ok=True)
            logger.warning("[index] %s not written: an offset into a run "
                           "of %d exceeds its 2-byte field", col_pml_out,
                           offset_max)
        wide = tbl.n > cfg.wide_n_limit
        sigma = int(np.unique(O.normalize_heads(tbl.char)).size)
        pos_viable = (not wide and tbl.n < 2**28
                      and (sigma + 1) * tbl.n * 8
                      <= resolve_pos_budget(cfg.pos_hbm_budget, device))
        split = (wide or cfg.run_split == "always"
                 or (cfg.run_split == "auto" and not pos_viable))
        if split:
            with status("run splitting", logger):
                ffb = max(cfg.ff_bound, 2) if wide else cfg.ff_bound
                index = ColPmlIndex.build(tbl, ff_bound=ffb, wide=wide or None)
        else:
            logger.info("[index] pos engine viable: skipping run splitting")
            index = ColPmlIndex.from_table(tbl)
        index.save(out.with_suffix(""))
        logger.info("[index] r=%d (bwt_r=%d) ff_bound=%d bytes=%d",
                    index.r, index.bwt_r, index.ff_bound, index.nbytes())
    except Exception:
        _cleanup([out, col_pml_out])
        raise


def log_cache_events(logger, eng, prefix: str = "") -> None:
    """One log record for each of the engine's table cache events, the
    event attached as `table_cache`."""
    for ev in eng.cache_events:
        logger.info("%stable cache: %s", prefix, ev,
                    extra={"table_cache": ev})


def stage_prewarm(prefix: str, cfg: ColBwtConfig, logger,
                  device=None) -> None:
    """Make the built index query-ready at build exit (port of
    colbwt_tpu/pipeline/build.py:386-435): load the kernel library (it
    persists on disk, keyed by a hash of its sources: no compile cache and
    no dummy dispatch are needed), then build the engine a large query
    would pick on `device` (default cuda) with the table cache under
    PREFIX.torch_tables, so that it builds and, where the cache pays,
    saves its tables.  Logs each cache event and `prewarm_s`."""
    from colbwt_tpu_torch.ops import _kernels as K
    from colbwt_tpu_torch.pipeline.engines import QueryEngines

    dev = resolve_device(device)
    t0 = time.perf_counter()
    index = ColPmlIndex.load(f"{prefix}.colpml.npz")
    if dev.type == "cuda":
        K.load()
    eng = QueryEngines(index, cfg, total_chars=None,
                       table_dir=f"{prefix}.torch_tables", device=dev)
    log_cache_events(logger, eng, "[prewarm] ")
    prewarm_s = time.perf_counter() - t0
    logger.info("[prewarm] engine %s ready in %.3fs", eng.name, prewarm_s,
                extra={"prewarm_s": prewarm_s})


def build_pipeline(fastas: list[str], output: str,
                   cfg: ColBwtConfig | None = None,
                   filelist: str | None = None, device=None) -> ColPmlIndex:
    """`col-bwt-torch build`: run every stage with skipping + cleanup and
    return the loaded index.  The device stages run on `device` (default
    cuda), whose memory budget also decides run splitting."""
    cfg = cfg or ColBwtConfig()
    dev = resolve_device(device)
    logger = get_logger("colbwt_torch.build", cfg.verbose)
    timer = Timer().start()
    Path(output).parent.mkdir(parents=True, exist_ok=True)

    docs = load_documents(fastas, filelist, cfg.rev_comp)
    logger.info("documents: %d (total %d bases)", len(docs),
                sum(len(d) for d in docs))
    stage_mums(docs, output, cfg, logger, dev)
    stage_bwt(output, cfg, logger)
    stage_colsplit(output, cfg, logger, dev)
    with _timed(logger, "index_s", "[index] stage"):
        stage_index(output, cfg, logger, dev)
    if cfg.prewarm:
        stage_prewarm(output, cfg, logger, dev)

    if not cfg.keep_temp:
        _cleanup([Path(f"{output}.fa.bwt")])
    timer.end()
    logger.info("build complete in %.2fs", timer.start_duration,
                extra={"build_s": timer.start_duration})
    return ColPmlIndex.load(f"{output}.colpml.npz")


def query_pipeline(index_prefix: str, pattern_file: str,
                   cfg: ColBwtConfig | None = None,
                   write_text: bool = False, write_text_long: bool = False,
                   device=None) -> tuple[list, list, list]:
    """`col-bwt-torch query`: batched device queries on `device` (default
    cuda); writes PATTERN.split.pml.bin/.split.cid.bin (+ optional
    .pml/.cid text, the src/pml_query.cpp:74-90 format).

    Logs where the time went, with each value also attached to its log
    record: `read_s` (index load + FASTA parse), `engine`, each table
    cache event (`table_cache`), `table_build_s` (the tables' build or
    load), `table_save_s`, `scan_s` (encode, device scans, copies back),
    `write_s` (output files), `query_s` (all of it), `reads` and
    `device_mem_peak_bytes` (the CUDA allocator's peak; None on the
    CPU)."""
    from colbwt_tpu_torch.pipeline.engines import QueryEngines

    cfg = cfg or ColBwtConfig()
    dev = resolve_device(device)
    logger = get_logger("colbwt_torch.query", cfg.verbose)
    timer = Timer().start()
    t_read = time.perf_counter()
    index = ColPmlIndex.load(f"{index_prefix}.colpml.npz")
    names: list[str] = []
    reads: list[bytes] = []
    for rec in read_fasta(pattern_file):
        names.append(rec.name)
        reads.append(rec.seq.upper())
    read_s = time.perf_counter() - t_read
    logger.info("querying %d reads against r=%d index (loaded in %.3fs)",
                len(reads), index.r, read_s, extra={"read_s": read_s})
    if len(reads) >= LARGE_QUERY_READS:
        logger.warning(
            "%d reads held in host memory by the one-shot query path — "
            "use --stream for bounded-memory streaming at this scale",
            len(reads))

    total_chars = sum(len(rd) for rd in reads)
    eng = QueryEngines(index, cfg, total_chars,
                       table_dir=f"{index_prefix}.torch_tables", device=dev)
    logger.info("engine: %s", eng.name, extra={"engine": eng.name})
    log_cache_events(logger, eng)
    logger.info("tables built or loaded in %.3fs (saved in %.3fs)",
                eng.table_build_seconds, eng.table_save_seconds,
                extra={"table_build_s": eng.table_build_seconds,
                       "table_save_s": eng.table_save_seconds})

    # bucket by padded length; long reads stream in chunks with carried
    # state (the -l mode, src/pml_query.cpp:126-128)
    t_scan = time.perf_counter()
    pmls: list[np.ndarray] = [None] * len(reads)  # type: ignore[list-item]
    cids: list[np.ndarray] = [None] * len(reads)  # type: ignore[list-item]
    buckets: dict[int, list[int]] = {}
    long_idxs: list[int] = []
    for i, rd in enumerate(reads):
        m = max(1, len(rd))
        if eng.supports_long_streaming() and m > cfg.long_read_len:
            long_idxs.append(i)
            continue
        padded = 1 << (m - 1).bit_length()
        buckets.setdefault(padded, []).append(i)
    # phase 1: launch every bucketed batch; phase 2: copy results back
    pending = []
    for padded, idxs in sorted(buckets.items()):
        for off in range(0, len(idxs), cfg.batch_size):
            chunk = idxs[off:off + cfg.batch_size]
            pending.append(
                (chunk, eng.dispatch([reads[i] for i in chunk], padded)))
    for chunk, result in pending:
        p, c, lens = QueryEngines.materialize(result)
        width = p.shape[1]  # may exceed the bucket (pos pads to k-multiple)
        for j, i in enumerate(chunk):
            m = int(lens[j])
            pmls[i] = p[j, width - m:]
            cids[i] = c[j, width - m:]
    step = max(1, cfg.batch_size // 16)
    for off in range(0, len(long_idxs), step):
        chunk = long_idxs[off:off + step]
        p, c = eng.query_long_reads([reads[i] for i in chunk])
        for j, i in enumerate(chunk):
            pmls[i] = p[j]
            cids[i] = c[j]
    scan_s = time.perf_counter() - t_scan
    logger.info("scan of %d reads in %.3fs", len(reads), scan_s,
                extra={"scan_s": scan_s})

    t_write = time.perf_counter()
    write_pml_cid_binary(f"{pattern_file}.split.pml.bin",
                         f"{pattern_file}.split.cid.bin", names, pmls, cids)
    if write_text:
        write_pml_cid_text(f"{pattern_file}.pml", f"{pattern_file}.cid",
                           names, pmls, cids)
    if write_text_long:
        write_pml_cid_text_long(f"{pattern_file}.pml", f"{pattern_file}.cid",
                                names, pmls, cids)
    write_s = time.perf_counter() - t_write
    timer.end()
    logger.info("query complete in %.2fs (%.0f reads/s; outputs written in "
                "%.3fs)", timer.start_duration,
                len(reads) / max(timer.start_duration, 1e-9), write_s,
                extra={"query_s": timer.start_duration, "reads": len(reads),
                       "write_s": write_s,
                       "device_mem_peak_bytes": device_mem_peak(dev)})
    return names, pmls, cids
