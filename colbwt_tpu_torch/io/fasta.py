"""FASTA / FASTQ (.gz) streaming reader — the port's copy of
colbwt_tpu/io/fasta.py.

Behavioral equivalent of the reference's PatternProcessor (include/common/
io.hpp:6-35, klib kseq underneath): yields (id, sequence) records, transparently
gunzipping.  A buffered pure-Python parser; the native C++ reader in
colbwt_tpu_torch.io.native takes over for large inputs when built.
"""

from __future__ import annotations

import dataclasses
import gzip
import io
from pathlib import Path
from typing import Iterator


@dataclasses.dataclass
class FastaRecord:
    name: str
    seq: bytes


def _open(path: str | Path) -> io.BufferedReader:
    p = Path(path)
    raw = p.open("rb")
    head = raw.peek(2)[:2] if hasattr(raw, "peek") else b""
    if head == b"\x1f\x8b" or p.suffix == ".gz":
        return io.BufferedReader(gzip.open(raw))  # type: ignore[arg-type]
    return raw


def read_fasta(path: str | Path) -> Iterator[FastaRecord]:
    """Stream records from a FASTA or FASTQ file (optionally gzipped).

    Like kseq, the record name is the first whitespace-delimited token after
    '>' / '@'; multi-line sequences are concatenated.  Large plain FASTA
    files route through the native C++ parser when built.
    """
    p = Path(path)
    if (p.suffix not in (".gz", ".fastq", ".fq")
            and p.exists() and p.stat().st_size > (1 << 20)):
        try:
            from colbwt_tpu_torch.io import native

            if native.available():
                head = p.open("rb").read(2)
                if head[:1] == b">":
                    for name, seq in native.parse_fasta_bytes(p.read_bytes()):
                        yield FastaRecord(name, seq)
                    return
        except Exception:
            pass  # fall through to the Python reader
    with _open(path) as fh:
        yield from _parse_lines(fh)


def _parse_lines(fh) -> Iterator[FastaRecord]:
    """Line-by-line FASTA/FASTQ parser over a binary file object (the
    portable fallback; also parses the final partial slab of the native
    streamer, where a record may legitimately lack its trailing newline)."""
    name: str | None = None
    chunks: list[bytes] = []
    fastq = False
    line_iter = iter(fh)
    for line in line_iter:
        line = line.rstrip()
        if not line:
            continue
        if line.startswith(b">") or line.startswith(b"@"):
            if name is not None:
                yield FastaRecord(name, b"".join(chunks))
            fastq = line.startswith(b"@")
            name = line[1:].split()[0].decode() if len(line) > 1 else ""
            chunks = []
        elif line.startswith(b"+") and fastq:
            # quality header: skip quality lines until next record length
            seq_len = sum(len(c) for c in chunks)
            qual_len = 0
            for qline in line_iter:
                qual_len += len(qline.rstrip())
                if qual_len >= seq_len:
                    break
            yield FastaRecord(name or "", b"".join(chunks))
            name = None
            chunks = []
        else:
            chunks.append(line)
    if name is not None:
        yield FastaRecord(name, b"".join(chunks))


def _inflate_slabs(fh, chunk_bytes: int) -> Iterator[bytes]:
    """Raw or gzip-member-aware slab reader: yields decompressed slabs.
    Multi-member gzip (bgzip output) is handled by restarting the
    decompressor on each member boundary.  Inflate runs in zlib's C code;
    the Python layer only shuttles ~chunk-sized buffers."""
    import zlib

    head = fh.peek(2)[:2] if hasattr(fh, "peek") else b""
    if head != b"\x1f\x8b":
        while True:
            slab = fh.read(chunk_bytes)
            if not slab:
                return
            yield slab
        return
    decomp = zlib.decompressobj(wbits=31)
    while True:
        raw = fh.read(chunk_bytes)
        if not raw:
            tail = decomp.flush()
            if tail:
                yield tail
            return
        parts = []
        chunk = raw
        while chunk:
            parts.append(decomp.decompress(chunk))
            if decomp.eof:
                chunk = decomp.unused_data
                decomp = zlib.decompressobj(wbits=31)
            else:
                chunk = b""
        data = b"".join(parts)
        if data:
            yield data


def _prefetch_thread(iterator, depth: int = 2):
    """Drain `iterator` on a worker thread, `depth` items ahead.  zlib
    inflate and the native record scan both release the GIL, so slab i+1
    decompresses while slab i parses — gzipped-FASTQ throughput is
    inflate-bound, so the overlap reclaims most of the parse time.  The
    worker is a daemon: if the consumer abandons the generator early, the
    worker parks on the bounded queue and dies with the process."""
    import queue
    import threading

    q: queue.Queue = queue.Queue(maxsize=depth)
    done = object()

    def run():
        try:
            for item in iterator:
                q.put(item)
            q.put(done)
        except BaseException as e:  # re-raised on the consumer side
            q.put(e)

    threading.Thread(target=run, daemon=True).start()
    while True:
        item = q.get()
        if item is done:
            return
        if isinstance(item, BaseException):
            raise item
        yield item


def stream_fasta(path: str | Path, chunk_bytes: int = 32 << 20
                 ) -> Iterator[FastaRecord]:
    """Bounded-memory FASTA/FASTQ streaming, gzip included: the file is
    read in ~chunk_bytes slabs (gzip members inflate through zlib's C
    path, one slab ahead on a worker thread), each slab parses through the
    native C++ record scanner, and the held-back partial record carries
    into the next slab.  Functionally identical to read_fasta; this is the
    reader for 100M-read query streams (SURVEY §2.2: klib/kseq streams —
    so do we).  FASTQ carry uses the scanner's consumed-bytes contract,
    because '@' is a legal quality character and a byte-level boundary
    search is unsound."""
    p = Path(path)
    try:
        from colbwt_tpu_torch.io import native

        use_native = native.available()
    except Exception:
        use_native = False
    if not use_native:
        yield from read_fasta(path)
        return
    from colbwt_tpu_torch.io import native

    with p.open("rb") as fh:
        carry = b""
        fmt = b""
        slabs = _prefetch_thread(_inflate_slabs(fh, chunk_bytes))
        while True:
            slab = next(slabs, None)
            if slab is None:
                break
            data = carry + slab
            if not fmt:
                fmt = data[:1]
            if fmt == b">":
                # '>' starts a record only at the beginning of a line
                cut = data.rfind(b"\n>")
                if cut < 0:
                    carry = data
                    continue
                carry = data[cut + 1:]
                for name, seq in native.parse_fasta_bytes(data[:cut + 1]):
                    yield FastaRecord(name, seq)
            elif fmt == b"@":
                recs, consumed = native.parse_fastq_bytes(data)
                carry = data[consumed:]
                for name, seq in recs:
                    yield FastaRecord(name, seq)
            else:
                carry = data  # unknown leader: let the fallback decide
        if carry:
            yield from _parse_lines(io.BytesIO(carry))


def write_fasta(path: str | Path, records: list[FastaRecord], width: int = 60) -> None:
    with Path(path).open("wb") as fh:
        for rec in records:
            fh.write(b">" + rec.name.encode() + b"\n")
            for i in range(0, len(rec.seq), width):
                fh.write(rec.seq[i:i + width] + b"\n")


_COMP = bytes.maketrans(b"ACGTacgtNn", b"TGCAtgcaNn")


def reverse_complement(seq: bytes) -> bytes:
    """Reverse complement, used by the -r / --rev_comp build flag
    (scripts/col-bwt.py:138-139, 212)."""
    return seq.translate(_COMP)[::-1]
