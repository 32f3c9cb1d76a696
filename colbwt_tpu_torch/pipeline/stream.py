"""Bounded-memory streaming query (the 100M-read lane) — port of
colbwt_tpu/pipeline/stream.py.

`query_stream` keeps host memory flat where `query_pipeline` holds every
read and output:

- reads arrive through io.fasta.stream_fasta (one ~32 MB slab at a time),
- batches dispatch in strict input order, two deep (`max_pending`): a
  batch goes up from pinned memory and its outputs come down into pinned
  memory without blocking (pipeline/engines.py), so the card computes
  batch i+1 while the host waits on batch i's event and writes it,
- PML/CID records append to the .split.*.bin files as each batch lands
  (io.pml_out.PmlCidBinaryWriter), never accumulating in memory.

Long reads (beyond cfg.long_read_len) are flushed in input order: every
pending batch drains before they are queried.  Outputs are byte-identical
to query_pipeline's and to the JAX package's query_stream on the same
input.  The engine's tables go through the table cache in
INDEX_PREFIX.torch_tables/ (pipeline/tables.py), each cache event logged.

A job records its spans and counters in one recorder
(utils/profiling.StepTimer), shared with its engine, and writes them out
once, as the `spans`, `span_totals` and `counters` extras of its last log
record and keys of its stats.  Spans (parent in brackets): stream.job;
stream.load_index, stream.tables, stream.read (FASTA parse and batch
assembly, one a batch), stream.dispatch, stream.drain, stream.long,
stream.close [stream.job]; engine.encode, engine.launch [stream.dispatch];
engine.wait, engine.unpack, stream.slice, stream.write [stream.drain].
Counters: batches, reads, bases, long_reads, launches and first_record_s
here; scanned_bases, padded_cells, fallback_reads, bytes_up and bytes_down
in the engine.
"""

from __future__ import annotations

import time
from collections import deque
from pathlib import Path

from colbwt_tpu_torch.io.fasta import stream_fasta
from colbwt_tpu_torch.io.pml_out import PmlCidBinaryWriter
from colbwt_tpu_torch.models.index import ColPmlIndex
from colbwt_tpu_torch.ops import _kernels as K
from colbwt_tpu_torch.pipeline.build import log_cache_events
from colbwt_tpu_torch.utils.config import ColBwtConfig
from colbwt_tpu_torch.utils.device import resolve_device
from colbwt_tpu_torch.utils.log import device_mem_peak, get_logger
from colbwt_tpu_torch.utils.profiling import StepTimer


def query_stream(index_prefix: str, pattern_file: str,
                 cfg: ColBwtConfig | None = None, max_pending: int = 2,
                 device=None) -> dict:
    """Stream PATTERN through the index on `device` (default cuda); returns
    run stats (reads, chars, seconds, reads_per_s, table_build_s, engine,
    the output paths, and the job's spans, span_totals and counters).
    Outputs land at PATTERN.split.pml.bin/.cid.bin, records in input
    order."""
    from colbwt_tpu_torch.pipeline.engines import QueryEngines

    cfg = cfg or ColBwtConfig()
    dev = resolve_device(device)
    logger = get_logger("colbwt_torch.stream", cfg.verbose)
    tm = StepTimer()
    launches0 = sum(K.launches.values())

    with tm.stage("stream.job"):
        with tm.stage("stream.load_index"):
            index = ColPmlIndex.load(f"{index_prefix}.colpml.npz")
        with tm.stage("stream.tables"):
            eng = QueryEngines(index, cfg, total_chars=None,
                               table_dir=f"{index_prefix}.torch_tables",
                               device=dev, timer=tm)
        log_cache_events(logger, eng)
        logger.info("streaming %s with engine %s (tables in %.3fs, saved in "
                    "%.3fs)", pattern_file, eng.name, eng.table_build_seconds,
                    eng.table_save_seconds,
                    extra={"engine": eng.name,
                           "table_build_s": eng.table_build_seconds,
                           "table_save_s": eng.table_save_seconds})

        out_pml = f"{pattern_file}.split.pml.bin"
        out_cid = f"{pattern_file}.split.cid.bin"
        total_reads = 0
        total_chars = 0
        # pending: (names, dispatch result) in input order, bounded depth
        pending: deque = deque()

        def write(writer: PmlCidBinaryWriter, names: list[str], pmls,
                  cids) -> None:
            with tm.stage("stream.write"):
                writer.append(names, pmls, cids)
            if "first_record_s" not in tm.counters:
                tm.counters["first_record_s"] = (
                    time.perf_counter_ns() - tm.spans[0][1]) * 1e-9

        def drain_one(writer: PmlCidBinaryWriter) -> None:
            with tm.stage("stream.drain"):
                names, result = pending.popleft()
                p, c, lens = QueryEngines.materialize(result)
                W = p.shape[1]
                with tm.stage("stream.slice"):
                    pmls = [p[j, W - int(lens[j]):] for j in range(len(names))]
                    cids = [c[j, W - int(lens[j]):] for j in range(len(names))]
                write(writer, names, pmls, cids)

        def flush_long(writer: PmlCidBinaryWriter, names: list[str],
                       reads: list[bytes]) -> None:
            # long reads are rare; preserve order by draining everything
            # first
            while pending:
                drain_one(writer)
            tm.count("long_reads", len(reads))
            with tm.stage("stream.long"):
                p, c = eng.query_long_reads(reads)
            with tm.stage("stream.drain"):
                write(writer, names, p, c)

        with PmlCidBinaryWriter(out_pml, out_cid) as writer:
            batch_names: list[str] = []
            batch_reads: list[bytes] = []
            long_names: list[str] = []
            long_reads: list[bytes] = []
            long_cap = max(1, cfg.batch_size // 16)

            def dispatch_batch() -> None:
                """Dispatch the assembled batch, draining first to keep at
                most `max_pending` in flight; the caller has closed the
                batch's stream.read span."""
                nonlocal batch_names, batch_reads
                if not batch_names:
                    return
                while len(pending) >= max_pending:
                    drain_one(writer)
                with tm.stage("stream.dispatch"):
                    m = max(max(len(r) for r in batch_reads), 1)
                    padded = 1 << (m - 1).bit_length()
                    pending.append((batch_names,
                                    eng.dispatch(batch_reads, padded)))
                tm.count("batches")
                batch_names, batch_reads = [], []

            tm.begin("stream.read")
            for rec in stream_fasta(pattern_file):
                seq = rec.seq.upper()
                total_reads += 1
                total_chars += len(seq)
                if (eng.supports_long_streaming()
                        and len(seq) > cfg.long_read_len):
                    long_names.append(rec.name)
                    long_reads.append(seq)
                    if len(long_reads) >= long_cap:
                        tm.end()
                        dispatch_batch()  # keep input order
                        flush_long(writer, long_names, long_reads)
                        long_names, long_reads = [], []
                        tm.begin("stream.read")
                    continue
                if long_reads:  # a short read after queued long ones: flush
                    tm.end()
                    dispatch_batch()
                    flush_long(writer, long_names, long_reads)
                    long_names, long_reads = [], []
                    tm.begin("stream.read")
                batch_names.append(rec.name)
                batch_reads.append(seq)
                if len(batch_reads) >= cfg.batch_size:
                    tm.end()
                    dispatch_batch()
                    tm.begin("stream.read")
            tm.end()
            dispatch_batch()
            if long_reads:
                flush_long(writer, long_names, long_reads)
            while pending:
                drain_one(writer)
            with tm.stage("stream.close"):
                writer.close()
                if writer.records != total_reads:
                    raise RuntimeError(f"wrote {writer.records} records for "
                                       f"{total_reads} reads")

    secs = tm.stages["stream.job"]
    tm.count("reads", total_reads)
    tm.count("bases", total_chars)
    tm.count("launches", sum(K.launches.values()) - launches0)
    peak = device_mem_peak(dev)
    spans, totals, counters = tm.spans, tm.summary(), tm.counters
    logger.info("streamed %d reads (%d chars) in %.2fs (%.0f reads/s)",
                total_reads, total_chars, secs,
                total_reads / max(secs, 1e-9),
                extra={"reads": total_reads, "query_s": secs,
                       "device_mem_peak_bytes": peak, "spans": spans,
                       "span_totals": totals, "counters": counters})
    return {"reads": total_reads, "chars": total_chars, "seconds": secs,
            "reads_per_s": total_reads / max(secs, 1e-9),
            "engine": eng.name, "table_build_s": eng.table_build_seconds,
            "device_mem_peak_bytes": peak,
            "pml_path": str(Path(out_pml)), "cid_path": str(Path(out_cid)),
            "spans": spans, "span_totals": totals, "counters": counters}
