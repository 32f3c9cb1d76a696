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
"""

from __future__ import annotations

from collections import deque
from pathlib import Path

from colbwt_tpu_torch.io.fasta import stream_fasta
from colbwt_tpu_torch.io.pml_out import PmlCidBinaryWriter
from colbwt_tpu_torch.models.index import ColPmlIndex
from colbwt_tpu_torch.pipeline.build import log_cache_events
from colbwt_tpu_torch.utils.config import ColBwtConfig
from colbwt_tpu_torch.utils.device import resolve_device
from colbwt_tpu_torch.utils.log import Timer, device_mem_peak, get_logger


def query_stream(index_prefix: str, pattern_file: str,
                 cfg: ColBwtConfig | None = None, max_pending: int = 2,
                 device=None) -> dict:
    """Stream PATTERN through the index on `device` (default cuda); returns
    run stats (reads, chars, seconds, reads_per_s, table_build_s, engine,
    the output paths).  Outputs land at PATTERN.split.pml.bin/.cid.bin,
    records in input order."""
    from colbwt_tpu_torch.pipeline.engines import QueryEngines

    cfg = cfg or ColBwtConfig()
    dev = resolve_device(device)
    logger = get_logger("colbwt_torch.stream", cfg.verbose)
    timer = Timer().start()

    index = ColPmlIndex.load(f"{index_prefix}.colpml.npz")
    eng = QueryEngines(index, cfg, total_chars=None,
                       table_dir=f"{index_prefix}.torch_tables", device=dev)
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

    def drain_one(writer: PmlCidBinaryWriter) -> None:
        names, result = pending.popleft()
        p, c, lens = QueryEngines.materialize(result)
        W = p.shape[1]
        writer.append(names,
                      [p[j, W - int(lens[j]):] for j in range(len(names))],
                      [c[j, W - int(lens[j]):] for j in range(len(names))])

    def flush_long(writer: PmlCidBinaryWriter, names: list[str],
                   reads: list[bytes]) -> None:
        # long reads are rare; preserve order by draining everything first
        while pending:
            drain_one(writer)
        p, c = eng.query_long_reads(reads)
        writer.append(names, p, c)

    with PmlCidBinaryWriter(out_pml, out_cid) as writer:
        batch_names: list[str] = []
        batch_reads: list[bytes] = []
        long_names: list[str] = []
        long_reads: list[bytes] = []
        long_cap = max(1, cfg.batch_size // 16)

        def dispatch_batch() -> None:
            nonlocal batch_names, batch_reads
            if not batch_names:
                return
            m = max(max(len(r) for r in batch_reads), 1)
            padded = 1 << (m - 1).bit_length()
            while len(pending) >= max_pending:
                drain_one(writer)
            pending.append((batch_names,
                            eng.dispatch(batch_reads, padded)))
            batch_names, batch_reads = [], []

        for rec in stream_fasta(pattern_file):
            seq = rec.seq.upper()
            total_reads += 1
            total_chars += len(seq)
            if eng.supports_long_streaming() and len(seq) > cfg.long_read_len:
                long_names.append(rec.name)
                long_reads.append(seq)
                if len(long_reads) >= long_cap:
                    dispatch_batch()  # keep input order
                    flush_long(writer, long_names, long_reads)
                    long_names, long_reads = [], []
                continue
            if long_reads:  # a short read after queued long ones: flush order
                dispatch_batch()
                flush_long(writer, long_names, long_reads)
                long_names, long_reads = [], []
            batch_names.append(rec.name)
            batch_reads.append(seq)
            if len(batch_reads) >= cfg.batch_size:
                dispatch_batch()
        dispatch_batch()
        if long_reads:
            flush_long(writer, long_names, long_reads)
        while pending:
            drain_one(writer)
        if writer.records != total_reads:
            raise RuntimeError(f"wrote {writer.records} records for "
                               f"{total_reads} reads")

    timer.end()
    secs = timer.start_duration
    peak = device_mem_peak(dev)
    logger.info("streamed %d reads (%d chars) in %.2fs (%.0f reads/s)",
                total_reads, total_chars, secs,
                total_reads / max(secs, 1e-9),
                extra={"reads": total_reads, "query_s": secs,
                       "device_mem_peak_bytes": peak})
    return {"reads": total_reads, "chars": total_chars, "seconds": secs,
            "reads_per_s": total_reads / max(secs, 1e-9),
            "engine": eng.name, "table_build_s": eng.table_build_seconds,
            "device_mem_peak_bytes": peak,
            "pml_path": str(Path(out_pml)), "cid_path": str(Path(out_cid))}
