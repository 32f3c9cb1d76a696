"""Chunked construction: RLBWT + doc array + LCP for collections whose
suffix array does not fit host RAM — the port's copy of
colbwt_tpu/ops/construct_chunked.py (host NumPy and the native library).

The monolithic lane (scripts/validate_wide.py) needs ~40 B/char of working
set for SA-IS + Kasai — ~90 GB at n = 2.3e9 — capping single-host builds.
This lane is the from-scratch equivalent of the reference's scale story
(prefix-free parsing inside the mumemto fork,
thirdparty/CMakeLists.txt:89-108), with a chunk-and-merge decomposition
instead of PFP:

1. split the collection into document chunks whose LOCAL suffix arrays fit
   RAM (native/sais.cpp per chunk);
2. merge chunk BWTs by rank: one backward-extension pass per chunk over the
   accumulated RLBWT (native/chunked.cpp bwt_merge_ranks — parallel across
   documents), then a linear interleave emit (bwt_merge_emit) carrying the
   per-rank document ids along;
3. recover the LCP array directly from the merged RLBWT (lcp_from_rlbwt,
   Beller et al. BFS) — no global SA, no Kasai, no text access.

Peak memory is O(n_chunk * 40 B + n * ~7 B) instead of O(n * 40 B): the
chunk SA working set plus the merged doc array (2 B), LCP (4 B), and kpos
scratch (8 B, chunk-sized).  Everything downstream (thresholds, multi-MUM
scan, col-split, col_pml) already consumes (heads, lens, lcp, doc_of) and
needs no changes.

The JAX package's copy is differential-tested against the monolithic SA
path (tests/test_chunked.py); the port's build lanes are held equal to the
JAX package's (tests/test_torch_construct.py).
"""

from __future__ import annotations

import gc
import time

import numpy as np

from colbwt_tpu_torch.io import native

TERMINATOR = 1


def symbol_classes(text_bytes: np.ndarray) -> tuple[np.ndarray, int]:
    """256-entry byte -> dense class map: terminator (byte 1) is class 0,
    real bytes get classes 1..K in byte order (matching the collection
    order of oracle.concat_collection: terminators below everything, real
    bytes by value)."""
    present = np.unique(text_bytes) if text_bytes.size else np.array([], np.uint8)
    real = [int(b) for b in present if int(b) != TERMINATOR]
    classes = np.full(256, 255, dtype=np.uint8)
    classes[TERMINATOR] = 0
    for i, b in enumerate(sorted(real)):
        classes[b] = i + 1
    return classes, len(real)


def chunk_spans(doc_starts: np.ndarray, max_chunk_chars: int
                ) -> list[tuple[int, int]]:
    """Greedy document spans [dlo, dhi) with <= max_chunk_chars characters
    each (a single document larger than the budget gets its own chunk)."""
    spans = []
    ndocs = doc_starts.size - 1
    d = 0
    while d < ndocs:
        e = d + 1
        while e < ndocs and doc_starts[e + 1] - doc_starts[d] <= max_chunk_chars:
            e += 1
        spans.append((d, e))
        d = e
    return spans


def _input_fingerprint(text: np.ndarray, doc_starts: np.ndarray,
                       with_doc: bool) -> int:
    """Content fingerprint of a chunked-build input: CRC of the doc_starts
    offsets plus a FULL CRC of the text (chunked, so memmaps stream),
    mixed with the with_doc flag.  Guards checkpoint resume against a
    different collection — a strided sample would miss point-mutation-level
    changes at gigabase scale (same-shape collections with different SNPs
    are the common regeneration case); the full pass costs ~1 s/GB, noise
    next to the hours-long build it protects."""
    import zlib

    h = zlib.crc32(np.ascontiguousarray(doc_starts).tobytes())
    step = 256 << 20
    for s in range(0, text.size, step):
        h = zlib.crc32(np.ascontiguousarray(text[s:s + step]).tobytes(), h)
    return (h << 1) | int(bool(with_doc))


def _chunk_suffix_array(text_b: np.ndarray, local_starts: np.ndarray
                        ) -> np.ndarray:
    """Local SA of one chunk: terminators get distinct ascending ranks below
    every real byte (concat_collection semantics, chunk-local)."""
    nd = local_starts.size - 1
    ranks = text_b.astype(np.int32)  # chunks always fit the int32 SA lane
    ranks += nd
    sep_idx = local_starts[1:] - 1
    ranks[sep_idx] = 1 + np.arange(nd, dtype=np.int32)
    sa = native.suffix_array_sais32(ranks)
    del ranks
    gc.collect()
    return sa


def build_rlbwt_chunked(text: np.ndarray, doc_starts: np.ndarray,
                        max_chunk_chars: int, with_doc: bool = True,
                        log=None, cache_dir=None, fingerprint=None
                        ) -> tuple[np.ndarray, np.ndarray,
                                   np.ndarray | None]:
    """(heads, lens[, doc_of]) of the whole collection, chunk by chunk.

    With `cache_dir`, the carried merge state is checkpointed after every
    chunk (atomic rename) and a rerun resumes after the last completed
    chunk — a multi-hour build survives a crash at the cost of one
    state write (~n * 3 B) per chunk.

    `text` is the full concatenation (byte 1 terminating every document —
    may be a np.memmap; only one chunk's slice is copied at a time) and
    `doc_starts` its N+1 document offsets.  doc_of is the per-rank document
    id (uint16), the sa//len equivalent the multi-MUM scan consumes.
    """
    assert doc_starts[0] == 0 and doc_starts[-1] == text.size
    # the byte->class map is rebuilt from the union of bytes seen so far;
    # class order is always byte order, so growing it between merges keeps
    # every per-call rank structure consistent
    seen: set[int] = set()
    classes, K = symbol_classes(np.array([], dtype=np.uint8))

    spans = chunk_spans(doc_starts, max_chunk_chars)
    heads = lens = doc_of = None
    n_a = 0
    start_ci = 0
    state_f = None
    fprint = None
    if cache_dir is not None:
        from pathlib import Path

        cache_dir = Path(cache_dir)
        cache_dir.mkdir(parents=True, exist_ok=True)
        state_f = cache_dir / "rlbwt_state.npz"
        # the caller may pass the fingerprint it already computed —
        # recomputing is a full CRC pass over the multi-gigabase text
        fprint = (fingerprint if fingerprint is not None
                  else _input_fingerprint(text, doc_starts, with_doc))
        if state_f.exists():
            z = np.load(state_f)
            ck_fp = int(z["fingerprint"]) if "fingerprint" in z else None
            if ck_fp != fprint:
                # a missing fingerprint (pre-fingerprint legacy state) is
                # a mismatch too: a same-shape but different collection
                # must not silently resume
                if log:
                    log("checkpoint fingerprint missing or mismatched "
                        "(different collection in this cache_dir) — "
                        "discarding it")
                state_f.unlink()
            elif int(z["max_chunk_chars"]) == max_chunk_chars and \
                    int(z["n_total"]) == int(text.size):
                heads, lens = z["heads"], z["lens"]
                doc_of = z["doc_of"] if with_doc else None
                n_a = int(z["n_a"])
                start_ci = int(z["next_ci"])
                seen = set(int(b) for b in z["seen"])
                classes, K = symbol_classes(
                    np.array(sorted(seen), dtype=np.uint8))
                if log:
                    log(f"resumed after chunk {start_ci}/{len(spans)} "
                        f"(n_a = {n_a:,}, r = {heads.size:,})")
    def _prep(dlo: int, dhi: int):
        """Chunk-local work with no dependence on the accumulated merge
        state: slice + SA-IS + BWT/doc extraction.  Runs one chunk ahead
        on a worker thread (the native SA-IS releases the GIL), so chunk
        i+1's suffix sort overlaps chunk i's rank merge — the two big
        per-chunk costs — instead of serializing on one core."""
        lo, hi = int(doc_starts[dlo]), int(doc_starts[dhi])
        text_b = np.ascontiguousarray(text[lo:hi])
        uniq = np.unique(text_b)
        local_starts = (doc_starts[dlo:dhi + 1] - lo).astype(np.int64)
        sa = _chunk_suffix_array(text_b, local_starts)
        bwt_b = text_b[sa - 1]  # sa==0 wraps to the chunk-final terminator
        doc_b = None
        if with_doc:
            doc_b = (np.searchsorted(local_starts, sa, side="right") - 1
                     + dlo).astype(np.uint16)
        return text_b, local_starts, sa, bwt_b, doc_b, uniq

    from concurrent.futures import ThreadPoolExecutor

    ex = ThreadPoolExecutor(max_workers=1)
    try:
        fut = (ex.submit(_prep, *spans[start_ci])
               if start_ci < len(spans) else None)
        for ci, (dlo, dhi) in enumerate(spans):
            if ci < start_ci:
                continue
            t0 = time.perf_counter()
            text_b, local_starts, sa, bwt_b, doc_b, uniq = fut.result()
            fut = (ex.submit(_prep, *spans[ci + 1])
                   if ci + 1 < len(spans) else None)
            new = set(uniq.tolist()) - seen
            if new:
                seen |= new
                classes, K = symbol_classes(
                    np.array(sorted(seen), dtype=np.uint8))
            if ci == 0:
                heads, lens = native.rle_encode(bwt_b)
                doc_of = doc_b
            else:
                kpos = native.bwt_merge_ranks(heads, lens, classes, K,
                                              text_b, local_starts)
                karr = kpos[sa]
                del kpos
                gc.collect()
                heads, lens, doc_new = native.bwt_merge_emit(
                    heads, lens, n_a, bwt_b, karr,
                    doc_of if with_doc else None, doc_b)
                if with_doc:
                    doc_of = doc_new
                del karr
            lo, hi = int(doc_starts[dlo]), int(doc_starts[dhi])
            n_a += hi - lo
            del sa, bwt_b, text_b, doc_b
            gc.collect()
            if log:
                log(f"chunk {ci + 1}/{len(spans)} docs [{dlo},{dhi}): "
                    f"n_a = {n_a:,}  r = {heads.size:,}  "
                    f"({time.perf_counter() - t0:.0f}s)")
            if state_f is not None and ci + 1 < len(spans):
                tmp = state_f.with_suffix(".tmp.npz")
                np.savez(tmp, heads=heads, lens=lens,
                         doc_of=(doc_of if with_doc
                                 else np.empty(0, np.uint16)),
                         n_a=n_a, next_ci=ci + 1, n_total=int(text.size),
                         max_chunk_chars=max_chunk_chars,
                         fingerprint=fprint,
                         seen=np.array(sorted(seen), dtype=np.int64))
                tmp.rename(state_f)
    finally:
        ex.shutdown(wait=True, cancel_futures=True)
    if state_f is not None and state_f.exists():
        state_f.unlink()  # the caller caches the final result itself
    return heads, lens, doc_of


def lcp_chunked(heads: np.ndarray, lens: np.ndarray, ndocs: int,
                classes: np.ndarray | None = None, K: int | None = None
                ) -> np.ndarray:
    """LCP array (int32) from the merged RLBWT (no SA, no text)."""
    if classes is None:
        classes, K = symbol_classes(np.unique(heads))
    return native.lcp_from_rlbwt(heads, lens, ndocs, classes, K)


def run_change_from_runs(heads: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Rank-level run-change marks (uint8, length n): byte-run boundaries
    PLUS every terminator position — terminators are pairwise distinct, so
    in rank space (concat_collection) each is its own run.  Matches
    `ranks[sa-1]` adjacency of the monolithic path."""
    n = int(lens.sum())
    out = np.zeros(n, dtype=np.uint8)
    starts = np.zeros(heads.size, dtype=np.int64)
    np.cumsum(lens[:-1], out=starts[1:])
    out[starts] = 1
    for j in np.flatnonzero(heads == TERMINATOR):
        out[starts[j]:starts[j] + lens[j]] = 1
    return out
