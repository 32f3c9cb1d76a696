"""ctypes bindings for the native C++ runtime (native/colbwt_native.cpp) —
the port's copy of colbwt_tpu/io/native.py, with the single-core query
engine (`query_pml_serial`, the bench baseline).

The library is the repository's native/libcolbwt_native.so, shared by both
packages.  Everything here is optional acceleration: each caller has a
NumPy fallback, and `available()` gates usage.  `build()` compiles the
shared library with the in-tree Makefile on first use.
"""

from __future__ import annotations

import ctypes
import subprocess
from pathlib import Path

import numpy as np

_NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
_LIB_PATH = _NATIVE_DIR / "libcolbwt_native.so"
_lib: ctypes.CDLL | None = None


def build(force: bool = False) -> bool:
    """Compile the native library; returns success."""
    if _LIB_PATH.exists() and not force:
        return True
    try:
        subprocess.run(["make", "-C", str(_NATIVE_DIR)] + (["-B"] if force else []),
                       check=True, capture_output=True)
        return _LIB_PATH.exists()
    except (subprocess.CalledProcessError, FileNotFoundError):
        return False


def _load() -> ctypes.CDLL | None:
    global _lib
    if _lib is not None:
        return _lib
    if not _LIB_PATH.exists() and not build():
        return None
    lib = ctypes.CDLL(str(_LIB_PATH))
    i64p = ctypes.POINTER(ctypes.c_int64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.query_pml_serial.restype = None
    lib.query_pml_serial.argtypes = [
        u8p, i64p, i64p, i64p, i64p, u8p, i64p,
        ctypes.c_int64, ctypes.c_int64,
        u8p, i64p, ctypes.c_int64, i32p, i32p]
    lib.rle_encode.restype = ctypes.c_int64
    lib.rle_encode.argtypes = [u8p, ctypes.c_int64, u8p, i64p]
    lib.lcp_kasai.restype = None
    lib.lcp_kasai.argtypes = [i64p, i64p, ctypes.c_int64, i64p]
    lib.fasta_count.restype = ctypes.c_int64
    lib.fasta_count.argtypes = [u8p, ctypes.c_int64]
    lib.fasta_parse.restype = ctypes.c_int64
    lib.fasta_parse.argtypes = [u8p, ctypes.c_int64, u8p, i64p, i64p, i64p, i64p]
    lib.fastq_scan.restype = ctypes.c_int64
    lib.fastq_scan.argtypes = [u8p, ctypes.c_int64, i64p, ctypes.c_int32,
                               u8p, i64p, i64p, i64p, i64p]
    lib.suffix_array_sais.restype = None
    lib.suffix_array_sais.argtypes = [i64p, ctypes.c_int64, ctypes.c_int64, i64p]
    lib.suffix_array_sais32.restype = None
    lib.suffix_array_sais32.argtypes = [i32p, ctypes.c_int64,
                                        ctypes.c_int64, i32p]
    u16p = ctypes.POINTER(ctypes.c_uint16)
    lib.bwt_merge_ranks.restype = None
    lib.bwt_merge_ranks.argtypes = [
        u8p, i64p, ctypes.c_int64, u8p, ctypes.c_int64,
        u8p, ctypes.c_int64, i64p, ctypes.c_int64, i64p]
    lib.bwt_merge_emit.restype = ctypes.c_int64
    lib.bwt_merge_emit.argtypes = [
        u8p, i64p, ctypes.c_int64, ctypes.c_int64,
        u8p, i64p, ctypes.c_int64,
        u16p, u16p, ctypes.c_int32, u8p, i64p, u16p]
    lib.lcp_from_rlbwt.restype = None
    lib.lcp_from_rlbwt.argtypes = [
        u8p, i64p, ctypes.c_int64, ctypes.c_int64, u8p, ctypes.c_int64, i32p]
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def _p(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def query_pml_serial(tbl, patterns: list[bytes]
                     ) -> tuple[list[np.ndarray], list[np.ndarray]]:
    """Single-core C++ reference engine (the bench baseline) on an oracle
    LFTableArrays with col_id + threshold."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    chr_ = np.ascontiguousarray(tbl.char, dtype=np.uint8)
    idx = np.ascontiguousarray(tbl.idx, dtype=np.int64)
    lens = np.ascontiguousarray(tbl.length, dtype=np.int64)
    di = np.ascontiguousarray(tbl.dest_interval, dtype=np.int64)
    do = np.ascontiguousarray(tbl.dest_offset, dtype=np.int64)
    cid = np.ascontiguousarray(
        tbl.col_id if tbl.col_id is not None else np.zeros(tbl.r), dtype=np.uint8)
    thr = np.ascontiguousarray(
        tbl.threshold if tbl.threshold is not None else np.zeros(tbl.r),
        dtype=np.int64)

    offs = np.zeros(len(patterns) + 1, dtype=np.int64)
    np.cumsum([len(p) for p in patterns], out=offs[1:])
    flat = np.frombuffer(b"".join(patterns), dtype=np.uint8).copy()
    pml = np.zeros(flat.size, dtype=np.int32)
    cids = np.zeros(flat.size, dtype=np.int32)

    lib.query_pml_serial(
        _p(chr_, ctypes.c_uint8), _p(idx, ctypes.c_int64),
        _p(lens, ctypes.c_int64), _p(di, ctypes.c_int64),
        _p(do, ctypes.c_int64), _p(cid, ctypes.c_uint8),
        _p(thr, ctypes.c_int64), tbl.r, tbl.n,
        _p(flat, ctypes.c_uint8), _p(offs, ctypes.c_int64), len(patterns),
        _p(pml, ctypes.c_int32), _p(cids, ctypes.c_int32))
    return ([pml[offs[i]:offs[i + 1]].astype(np.int64) for i in range(len(patterns))],
            [cids[offs[i]:offs[i + 1]].astype(np.int64) for i in range(len(patterns))])


def rle_encode(data: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    lib = _load()
    assert lib is not None
    data = np.ascontiguousarray(data, dtype=np.uint8)
    heads = np.empty(data.size, dtype=np.uint8)
    lens = np.empty(data.size, dtype=np.int64)
    r = lib.rle_encode(_p(data, ctypes.c_uint8), data.size,
                       _p(heads, ctypes.c_uint8), _p(lens, ctypes.c_int64))
    return heads[:r].copy(), lens[:r].copy()


def parse_fasta_bytes(data: bytes):
    """Native FASTA parse of an in-memory buffer → list of (name, seq bytes).

    The kseq-equivalent fast path (reference include/common/io.hpp:6-35);
    plain FASTA only — FASTQ/.gz stay on the Python reader."""
    lib = _load()
    assert lib is not None
    buf = np.frombuffer(data, dtype=np.uint8)
    count = lib.fasta_count(_p(buf, ctypes.c_uint8), buf.size)
    if count == 0:
        return []
    seq_out = np.empty(buf.size, dtype=np.uint8)
    name_off = np.empty(count, dtype=np.int64)
    name_len = np.empty(count, dtype=np.int64)
    seq_off = np.empty(count, dtype=np.int64)
    seq_len = np.empty(count, dtype=np.int64)
    lib.fasta_parse(_p(buf, ctypes.c_uint8), buf.size,
                    _p(seq_out, ctypes.c_uint8),
                    _p(name_off, ctypes.c_int64), _p(name_len, ctypes.c_int64),
                    _p(seq_off, ctypes.c_int64), _p(seq_len, ctypes.c_int64))
    raw = buf.tobytes()
    sq = seq_out.tobytes()
    out = [(raw[a:a + b].decode(), sq[c:c + d])
           for a, b, c, d in zip(name_off.tolist(), name_len.tolist(),
                                 seq_off.tolist(), seq_len.tolist())]
    return out


def parse_fastq_bytes(data: bytes) -> tuple[list, int]:
    """Native FASTQ slab scan → ([(name, seq bytes)...], consumed_bytes).

    Only complete records are returned; `consumed` is the offset past the
    last complete record, so a slab streamer carries the partial tail
    (kseq role, reference include/common/io.hpp:6-35 — a byte-level
    boundary search is unsound for FASTQ: '@' is a legal quality char)."""
    lib = _load()
    assert lib is not None
    buf = np.frombuffer(data, dtype=np.uint8)
    consumed = ctypes.c_int64(0)
    count = lib.fastq_scan(_p(buf, ctypes.c_uint8), buf.size,
                           ctypes.byref(consumed), 0,
                           None, None, None, None, None)
    if count == 0:
        return [], int(consumed.value)
    seq_out = np.empty(buf.size, dtype=np.uint8)
    name_off = np.empty(count, dtype=np.int64)
    name_len = np.empty(count, dtype=np.int64)
    seq_off = np.empty(count, dtype=np.int64)
    seq_len = np.empty(count, dtype=np.int64)
    lib.fastq_scan(_p(buf, ctypes.c_uint8), buf.size,
                   ctypes.byref(consumed), 1,
                   _p(seq_out, ctypes.c_uint8),
                   _p(name_off, ctypes.c_int64), _p(name_len, ctypes.c_int64),
                   _p(seq_off, ctypes.c_int64), _p(seq_len, ctypes.c_int64))
    raw = buf.tobytes()
    sq = seq_out.tobytes()
    # .tolist() + one comprehension: per-record numpy scalar extraction was
    # the reader benchmark's hot spot, not the native scan
    out = [(raw[a:a + b].decode(), sq[c:c + d])
           for a, b, c, d in zip(name_off.tolist(), name_len.tolist(),
                                 seq_off.tolist(), seq_len.tolist())]
    return out, int(consumed.value)


def suffix_array_sais(ranks: np.ndarray) -> np.ndarray:
    """Linear-time SA-IS suffix array over the rank text (values >= 1).

    The host-side fast path for index construction — the libdivsufsort/PFP
    role of the reference's mumemto stage (SURVEY §2.2)."""
    lib = _load()
    assert lib is not None
    s = np.ascontiguousarray(ranks, dtype=np.int64)
    if s.size and int(s.min()) < 1:
        raise ValueError("rank text values must be >= 1 (0 is the sentinel)")
    out = np.empty(s.size, dtype=np.int64)
    K = int(s.max()) + 1 if s.size else 1
    lib.suffix_array_sais(_p(s, ctypes.c_int64), s.size, K,
                          _p(out, ctypes.c_int64))
    return out


def suffix_array_sais32(ranks: np.ndarray) -> np.ndarray:
    """int32 SA-IS (values >= 1, n + 1 < 2^31): the chunked-construction
    fast path — 4-byte text/SA arrays halve the induce passes' random-
    access working set vs the int64 entry (~1.9x on gigabase chunks)."""
    lib = _load()
    assert lib is not None
    s = np.ascontiguousarray(ranks, dtype=np.int32)
    assert s.size + 1 < 2**31
    if s.size and int(s.min()) < 1:
        raise ValueError("rank text values must be >= 1 (0 is the sentinel)")
    out = np.empty(s.size, dtype=np.int32)
    K = int(s.max()) + 1 if s.size else 1
    lib.suffix_array_sais32(_p(s, ctypes.c_int32), s.size, K,
                            _p(out, ctypes.c_int32))
    return out


def lcp_kasai(ranks: np.ndarray, sa: np.ndarray) -> np.ndarray:
    lib = _load()
    assert lib is not None
    ranks = np.ascontiguousarray(ranks, dtype=np.int64)
    sa = np.ascontiguousarray(sa, dtype=np.int64)
    out = np.zeros(ranks.size, dtype=np.int64)
    lib.lcp_kasai(_p(ranks, ctypes.c_int64), _p(sa, ctypes.c_int64),
                  ranks.size, _p(out, ctypes.c_int64))
    return out


# ---------------------------------------------------------------------------
# chunked construction kernels (native/chunked.cpp)

def bwt_merge_ranks(heads: np.ndarray, lens: np.ndarray, classes: np.ndarray,
                    n_classes: int, text_b: np.ndarray,
                    doc_starts: np.ndarray) -> np.ndarray:
    """Insertion rank (among the accumulated collection's suffixes) of every
    suffix of chunk B, by per-document backward extension."""
    lib = _load()
    assert lib is not None
    heads = np.ascontiguousarray(heads, dtype=np.uint8)
    lens = np.ascontiguousarray(lens, dtype=np.int64)
    classes = np.ascontiguousarray(classes, dtype=np.uint8)
    text_b = np.ascontiguousarray(text_b, dtype=np.uint8)
    doc_starts = np.ascontiguousarray(doc_starts, dtype=np.int64)
    kpos = np.empty(text_b.size, dtype=np.int64)
    lib.bwt_merge_ranks(
        _p(heads, ctypes.c_uint8), _p(lens, ctypes.c_int64), heads.size,
        _p(classes, ctypes.c_uint8), n_classes,
        _p(text_b, ctypes.c_uint8), text_b.size,
        _p(doc_starts, ctypes.c_int64), doc_starts.size - 1,
        _p(kpos, ctypes.c_int64))
    return kpos


def bwt_merge_emit(heads_a: np.ndarray, lens_a: np.ndarray, n_a: int,
                   bwt_b: np.ndarray, karr: np.ndarray,
                   doc_a: np.ndarray | None = None,
                   doc_b: np.ndarray | None = None
                   ) -> tuple[np.ndarray, np.ndarray, np.ndarray | None]:
    """Merged RLBWT runs (and optionally the merged per-rank doc array)."""
    lib = _load()
    assert lib is not None
    heads_a = np.ascontiguousarray(heads_a, dtype=np.uint8)
    lens_a = np.ascontiguousarray(lens_a, dtype=np.int64)
    bwt_b = np.ascontiguousarray(bwt_b, dtype=np.uint8)
    karr = np.ascontiguousarray(karr, dtype=np.int64)
    n_b = bwt_b.size
    heads_out = np.empty(heads_a.size + n_b, dtype=np.uint8)
    lens_out = np.empty(heads_a.size + n_b, dtype=np.int64)
    with_doc = doc_a is not None
    if with_doc:
        doc_a = np.ascontiguousarray(doc_a, dtype=np.uint16)
        doc_b = np.ascontiguousarray(doc_b, dtype=np.uint16)
        doc_out = np.empty(n_a + n_b, dtype=np.uint16)
        da, db, do = (_p(doc_a, ctypes.c_uint16), _p(doc_b, ctypes.c_uint16),
                      _p(doc_out, ctypes.c_uint16))
    else:
        doc_out = None
        null = ctypes.POINTER(ctypes.c_uint16)()
        da = db = do = null
    r = lib.bwt_merge_emit(
        _p(heads_a, ctypes.c_uint8), _p(lens_a, ctypes.c_int64),
        heads_a.size, n_a,
        _p(bwt_b, ctypes.c_uint8), _p(karr, ctypes.c_int64), n_b,
        da, db, 1 if with_doc else 0,
        _p(heads_out, ctypes.c_uint8), _p(lens_out, ctypes.c_int64), do)
    return heads_out[:r].copy(), lens_out[:r].copy(), doc_out


def lcp_from_rlbwt(heads: np.ndarray, lens: np.ndarray, nsep: int,
                   classes: np.ndarray, n_classes: int) -> np.ndarray:
    """LCP array (int32) straight from the RLBWT — Beller et al. BFS; no
    suffix array, no text."""
    lib = _load()
    assert lib is not None
    heads = np.ascontiguousarray(heads, dtype=np.uint8)
    lens = np.ascontiguousarray(lens, dtype=np.int64)
    classes = np.ascontiguousarray(classes, dtype=np.uint8)
    n = int(lens.sum())
    lcp = np.empty(n, dtype=np.int32)
    lib.lcp_from_rlbwt(
        _p(heads, ctypes.c_uint8), _p(lens, ctypes.c_int64), heads.size,
        nsep, _p(classes, ctypes.c_uint8), n_classes,
        _p(lcp, ctypes.c_int32))
    return lcp
