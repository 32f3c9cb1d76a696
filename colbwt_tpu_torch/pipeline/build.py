"""Host build lane and one-shot query pipeline — port of
colbwt_tpu/pipeline/build.py.

`build_pipeline` writes the same artifacts as the JAX package's
(PREFIX.fa.bwt.heads/.bwt.len/.thr_pos/.col_mums, PREFIX.lengths,
PREFIX.fa.col_runs/.col_ids, PREFIX.fa.col_pml, PREFIX.colpml.npz), with
the same stage skipping and cleanup, but every stage runs on the host:

  stage_mums      native SA-IS + Kasai (oracle SA without the native
                  library), host multi-MUM scan O.find_multi_mums,
                  O.compute_thresholds_fast
  stage_bwt       shared with the JAX package
  stage_colsplit  tunnels: ops/colsplit_host.py; all: O.col_split_oracle
  stage_index     as the JAX package, with this port's memory budget

The device MUM scan and col-split walk, and the chunked SA lane that
needs them, wait for ROADMAP Queue 1 item 10.  `query_pipeline` runs the
query on the device (default cuda) through pipeline/engines.py.
"""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np
import torch

from colbwt_tpu.io import formats as F
from colbwt_tpu.io.fasta import read_fasta
from colbwt_tpu.io.pml_out import write_pml_cid_binary, write_pml_cid_text
from colbwt_tpu.models.index import ColPmlIndex
from colbwt_tpu.ops import oracle as O
from colbwt_tpu.pipeline.build import load_documents, stage_bwt
from colbwt_tpu.utils.config import ColBwtConfig
from colbwt_tpu.utils.log import Timer, get_logger, status
from colbwt_tpu_torch.utils.device import resolve_device
from colbwt_tpu_torch.utils.hbm import (resolve_pos_budget,
                                        resolve_sa_budget_chars)


def _exists(*paths: Path) -> bool:
    return all(p.exists() for p in paths)


def _cleanup(paths: list[Path]) -> None:
    for p in paths:
        p.unlink(missing_ok=True)


def stage_mums(docs: list[bytes], prefix: str, cfg: ColBwtConfig, logger):
    """SA/LCP -> RLBWT + thresholds + multi-MUMs, on the host."""
    fa = f"{prefix}.fa"
    outs = [Path(f"{fa}.bwt.heads"), Path(f"{fa}.bwt.len"),
            Path(f"{fa}.thr_pos"), Path(f"{fa}.col_mums"),
            Path(f"{prefix}.lengths")]
    if _exists(*outs) and not cfg.force:
        logger.info("[mums] artifacts exist, skipping")
        return
    n_total = sum(len(d) + 1 for d in docs)
    if cfg.sa_mode == "chunked" or (
            cfg.sa_mode == "auto"
            and n_total > resolve_sa_budget_chars(cfg.sa_ram_chars)):
        raise NotImplementedError(
            "the chunked SA lane needs the device multi-MUM scan, which is "
            "not ported to PyTorch yet (ROADMAP Queue 1 item 10)")
    try:
        from colbwt_tpu.io import native as native_lib

        text, ranks, doc_ids = O.concat_collection(docs)
        with status("suffix array + LCP", logger):
            if native_lib.available():
                sa = native_lib.suffix_array_sais(ranks)
                lcp = native_lib.lcp_kasai(ranks, sa)
            else:
                sa = O.suffix_array(ranks)
                lcp = O.lcp_kasai(ranks, sa)
        with status("BWT + RLE", logger):
            heads, lens = O.rle(O.bwt_from_sa(text, sa))
        with status("multi-MUMs", logger):
            ml, mp = O.find_multi_mums(ranks, sa, lcp, doc_ids, len(docs),
                                       cfg.min_mum)
        with status("thresholds", logger):
            thr = O.compute_thresholds_fast(heads, lens, lcp)

        F.write_rlbwt(fa, heads, lens, cfg.rw_bytes)
        F.write_thresholds_file(f"{fa}.thr_pos", thr, cfg.rw_bytes)
        F.write_col_mums(f"{fa}.col_mums", len(docs), ml, mp, cfg.rw_bytes)
        Path(f"{prefix}.lengths").write_text(
            "".join(f"{len(d)}\n" for d in docs))
        logger.info("[mums] n=%d runs=%d multi-MUMs=%d", text.size,
                    heads.size, ml.size)
    except Exception:
        _cleanup(outs)
        raise


def stage_colsplit(prefix: str, cfg: ColBwtConfig, logger):
    """FL walk + interval sweep -> .col_runs + .col_ids
    (src/col_split.cpp:62-141), on the host."""
    from colbwt_tpu.ops.colruns_vec import (find_col_runs_mixed,
                                            find_col_runs_uniform)
    from colbwt_tpu_torch.ops.colsplit_host import col_split_tunneled_numpy

    fa = f"{prefix}.fa"
    outs = [Path(f"{fa}.col_runs"), Path(f"{fa}.col_ids")]
    if _exists(*outs) and not cfg.force:
        logger.info("[colsplit] artifacts exist, skipping")
        return
    try:
        heads, lens = F.read_rlbwt(fa, cfg.rw_bytes)
        num_docs, ml, mp = F.read_col_mums(f"{fa}.col_mums", cfg.rw_bytes)
        fl = O.build_fl_table(heads, lens)
        with status("col-split FL walk", logger):
            if cfg.mode.value in ("tunnels", "tunneled"):
                mpos, mids, mhts = col_split_tunneled_numpy(
                    fl, ml, mp, num_docs, cfg.split_rate, cfg.id_bits)
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
        logger.info("[colsplit] marks=%d col_runs bits=%d", mpos.size,
                    bits.size)
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
        F.write_col_pml_file(
            f"{fa}.col_pml", bwt_r=int(tbl.bwt_r), n=int(tbl.n),
            char=tbl.char, idx=tbl.idx,
            dest_interval=tbl.dest_interval, dest_offset=tbl.dest_offset,
            col_id=tbl.col_id, threshold=tbl.threshold)
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


def build_pipeline(fastas: list[str], output: str,
                   cfg: ColBwtConfig | None = None,
                   filelist: str | None = None, device=None) -> ColPmlIndex:
    """`col-bwt-torch build`: run every stage with skipping + cleanup and
    return the loaded index.  `device` (default cuda) sets the memory
    budget that decides run splitting."""
    cfg = cfg or ColBwtConfig()
    dev = resolve_device(device)
    logger = get_logger("colbwt_torch.build", cfg.verbose)
    timer = Timer().start()
    Path(output).parent.mkdir(parents=True, exist_ok=True)

    docs = load_documents(fastas, filelist, cfg.rev_comp)
    logger.info("documents: %d (total %d bases)", len(docs),
                sum(len(d) for d in docs))
    stage_mums(docs, output, cfg, logger)
    stage_bwt(output, cfg, logger)
    stage_colsplit(output, cfg, logger)
    stage_index(output, cfg, logger, dev)
    if cfg.prewarm:
        logger.warning("prewarm is not ported (ROADMAP Queue 1 item 8); "
                       "skipped")

    if not cfg.keep_temp:
        _cleanup([Path(f"{output}.fa.bwt")])
    timer.end()
    logger.info("build complete in %.2fs", timer.start_duration)
    return ColPmlIndex.load(f"{output}.colpml.npz")


def query_pipeline(index_prefix: str, pattern_file: str,
                   cfg: ColBwtConfig | None = None,
                   write_text: bool = False, write_text_long: bool = False,
                   device=None) -> tuple[list, list, list]:
    """`col-bwt-torch query`: batched device queries on `device` (default
    cuda); writes PATTERN.split.pml.bin/.split.cid.bin (+ optional
    .pml/.cid text, the src/pml_query.cpp:74-90 format).

    Logs where the time went, with each value also attached to its log
    record: `read_s` (index load + FASTA parse), `engine`,
    `table_build_s`, `scan_s` (encode, device scans, copies back),
    `write_s` (output files), `query_s` (all of it) and `reads`."""
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

    total_chars = sum(len(rd) for rd in reads)
    eng = QueryEngines(index, cfg, total_chars, device=dev)
    logger.info("engine: %s", eng.name, extra={"engine": eng.name})
    logger.info("tables built in %.3fs", eng.table_build_seconds,
                extra={"table_build_s": eng.table_build_seconds})

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
        from colbwt_tpu.io.pml_out import write_pml_cid_text_long

        write_pml_cid_text_long(f"{pattern_file}.pml", f"{pattern_file}.cid",
                                names, pmls, cids)
    write_s = time.perf_counter() - t_write
    timer.end()
    logger.info("query complete in %.2fs (%.0f reads/s; outputs written in "
                "%.3fs)", timer.start_duration,
                len(reads) / max(timer.start_duration, 1e-9), write_s,
                extra={"query_s": timer.start_duration, "reads": len(reads),
                       "write_s": write_s})
    return names, pmls, cids
