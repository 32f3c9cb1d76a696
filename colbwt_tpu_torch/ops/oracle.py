"""Reference-semantics oracle in NumPy — the port's copy of
colbwt_tpu/ops/oracle.py.

This module is the executable specification of col-bwt's algorithms, written
host-side in NumPy with the exact semantics of the reference C++ (every
function cites the file:line it models).  The port's host build stages run
it, and the smoke test holds the CUDA path's answers against it.

Coordinate conventions
----------------------
The collection of N documents is concatenated as

    text = d_0 · sep_0 · d_1 · sep_1 · ... · d_{N-1} · sep_{N-1}

where every separator is stored as byte TERMINATOR == 1 but *sorts* as a
distinct symbol: sep_k gets sort-rank 1 + k, all below every regular byte b
(rank N + b).  This is the distinct-terminator convention of BCR-style
multi-string BWTs used by the PFP toolchain the reference drives [inferred,
SURVEY §2.2]; the BWT emitted to disk normalizes separators back to byte 1,
exactly as the reference's readers do (include/ds/LF_table.hpp:111).

"Rank coordinate" = position in the sorted-suffix order, 0..n-1.  Both the L
(BWT) column and the F column live in this one coordinate; LF/FL tables are
run-subdivisions of it.
"""

from __future__ import annotations

import dataclasses
import heapq

import numpy as np

from colbwt_tpu_torch.utils.config import TERMINATOR

def from_fields(cls, fields: dict):
    """An instance of the dataclass `cls` from a dict of its fields (such
    as ``vars()`` of the JAX package's counterpart): arrays become numpy
    arrays, scalars Python scalars; a field absent from `fields` takes its
    default."""
    vals = {}
    for f in dataclasses.fields(cls):
        if f.name in fields:
            v = fields[f.name]
            if v is not None:
                v = np.asarray(v)
                v = v.item() if v.ndim == 0 else v
            vals[f.name] = v
    return cls(**vals)


# ---------------------------------------------------------------------------
# text building
# ---------------------------------------------------------------------------


def concat_collection(docs: list[bytes]) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Concatenate documents with per-doc separators.

    Returns (text_bytes uint8, sort_ranks int64, doc_ids int32): text bytes
    store every separator as TERMINATOR; sort_ranks give sep_k the distinct
    rank 1 + k and byte b the rank N + b; doc_ids label every position
    (separators belong to their document).
    """
    n_docs = len(docs)
    sizes = np.array([len(d) + 1 for d in docs], dtype=np.int64)
    n = int(sizes.sum())
    text = np.empty(n, dtype=np.uint8)
    ranks = np.empty(n, dtype=np.int64)
    doc_ids = np.empty(n, dtype=np.int32)
    off = 0
    for k, d in enumerate(docs):
        arr = np.frombuffer(d, dtype=np.uint8)
        if arr.size and arr.min() <= TERMINATOR:
            raise ValueError("document bytes must be > TERMINATOR (1)")
        text[off:off + arr.size] = arr
        ranks[off:off + arr.size] = arr.astype(np.int64) + n_docs
        doc_ids[off:off + arr.size + 1] = k
        off += arr.size
        text[off] = TERMINATOR
        ranks[off] = 1 + k
        off += 1
    return text, ranks, doc_ids


# ---------------------------------------------------------------------------
# suffix array / LCP / BWT
# ---------------------------------------------------------------------------


def suffix_array(ranks: np.ndarray) -> np.ndarray:
    """Suffix array by prefix doubling (NumPy lexsort).  O(n log n) sorts.

    End-of-string is treated as smaller than every symbol (rank -1 padding),
    the standard $-convention.  The reference offloads suffix sorting to
    PFP/libdivsufsort inside mumemto (thirdparty/CMakeLists.txt:51-69, 89-108);
    this oracle recomputes it directly.
    """
    n = ranks.size
    rank = np.asarray(ranks, dtype=np.int64).copy()
    sa = np.argsort(rank, kind="stable")
    k = 1
    while True:
        # key = (rank[i], rank[i+k]) with -1 past the end
        next_rank = np.full(n, -1, dtype=np.int64)
        next_rank[:n - k] = rank[k:]
        order = np.lexsort((next_rank, rank))
        key_hi = rank[order]
        key_lo = next_rank[order]
        new_rank = np.empty(n, dtype=np.int64)
        changed = np.empty(n, dtype=bool)
        changed[0] = True
        changed[1:] = (key_hi[1:] != key_hi[:-1]) | (key_lo[1:] != key_lo[:-1])
        new_rank[order] = np.cumsum(changed) - 1
        rank = new_rank
        sa = order
        if rank[sa[-1]] == n - 1:
            return sa.astype(np.int64)
        k *= 2
        if k >= 2 * n:  # pragma: no cover - safety
            return sa.astype(np.int64)


def lcp_kasai(ranks: np.ndarray, sa: np.ndarray) -> np.ndarray:
    """LCP array via Kasai: lcp[i] = LCP(suffix sa[i-1], suffix sa[i]),
    lcp[0] = 0.  Computed on sort-ranks so distinct separators never match."""
    n = ranks.size
    inv = np.empty(n, dtype=np.int64)
    inv[sa] = np.arange(n, dtype=np.int64)
    lcp = np.zeros(n, dtype=np.int64)
    h = 0
    r = np.asarray(ranks, dtype=np.int64)
    for i in range(n):
        pos = inv[i]
        if pos > 0:
            j = sa[pos - 1]
            while i + h < n and j + h < n and r[i + h] == r[j + h]:
                h += 1
            lcp[pos] = h
            if h > 0:
                h -= 1
        else:
            h = 0
    return lcp


def bwt_from_sa(text: np.ndarray, sa: np.ndarray) -> np.ndarray:
    """BWT[i] = text[sa[i] - 1] (text[-1] wraps to the last char)."""
    return np.asarray(text, dtype=np.uint8)[sa - 1]


def rle(bwt: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Run-length encode: returns (heads uint8, lens int64)."""
    b = np.asarray(bwt, dtype=np.uint8)
    if b.size == 0:
        return np.empty(0, dtype=np.uint8), np.empty(0, dtype=np.int64)
    boundaries = np.flatnonzero(np.r_[True, b[1:] != b[:-1]])
    lens = np.diff(np.r_[boundaries, b.size]).astype(np.int64)
    return b[boundaries], lens


def normalize_heads(heads: np.ndarray) -> np.ndarray:
    """Map chars <= TERMINATOR to TERMINATOR (no run re-merging — the
    reference's readers apply the same per-run mapping without merging,
    include/ds/LF_table.hpp:111; our writer emits heads from an
    already-normalized BWT so adjacent equal runs cannot arise there)."""
    h = np.asarray(heads, dtype=np.uint8).copy()
    h[h <= TERMINATOR] = TERMINATOR
    return h


# ---------------------------------------------------------------------------
# LF move table (include/ds/LF_table.hpp)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class LFTableArrays:
    """Structure-of-arrays LF move table.

    Mirrors LF_row {character, idx, interval, offset}
    (include/ds/LF_table.hpp:33-44) plus precomputed run lengths.
    Optional col-bwt extensions: col_id (include/col_bwt.hpp:40-52) and
    threshold (include/col_bwt.hpp:81-92).
    """

    char: np.ndarray           # uint8 per run
    idx: np.ndarray            # int64 rank-coordinate start per run
    length: np.ndarray         # int64 per run
    dest_interval: np.ndarray  # int64: LF destination run
    dest_offset: np.ndarray    # int64: LF destination offset within that run
    n: int
    r: int
    col_id: np.ndarray | None = None     # uint8 per run
    threshold: np.ndarray | None = None  # int64 per run
    bwt_r: int | None = None             # original (unsplit) BWT run count

    def get_length(self, i: int) -> int:
        return int(self.length[i])

    @classmethod
    def from_arrays(cls, fields: dict):
        """The table from a dict of its fields, such as ``vars()`` of the
        JAX package's counterpart."""
        return from_fields(cls, fields)


def build_lf_table(heads: np.ndarray, lens: np.ndarray,
                   col_ids_per_row: np.ndarray | None = None) -> LFTableArrays:
    """Construct the LF move table from an RLBWT.

    Semantics of LF_table's RLBWT constructor + compute_table
    (include/ds/LF_table.hpp:92-131, 365-387): rows keep L order; each row's LF
    destination is found by stable-sorting runs by (char, L-position) to get
    the F column, assigning F coordinates cumulatively, then locating each
    row's F start inside the L run subdivision.
    """
    heads = normalize_heads(heads)
    lens = np.asarray(lens, dtype=np.int64)
    r = heads.size
    n = int(lens.sum())
    idx = np.zeros(r, dtype=np.int64)
    idx[1:] = np.cumsum(lens[:-1])

    # F order: stable sort by char (ties keep L order) — equivalent to the
    # char-bucketed L_block_indices iteration of compute_table.
    f_order = np.argsort(heads, kind="stable")
    f_start = np.zeros(r, dtype=np.int64)
    f_start[1:] = np.cumsum(lens[f_order][:-1])
    # F start (rank coordinate) of each L run:
    lf_dest = np.empty(r, dtype=np.int64)
    lf_dest[f_order] = f_start
    dest_interval = np.searchsorted(idx, lf_dest, side="right") - 1
    dest_offset = lf_dest - idx[dest_interval]
    return LFTableArrays(
        char=heads, idx=idx, length=lens,
        dest_interval=dest_interval.astype(np.int64),
        dest_offset=dest_offset.astype(np.int64),
        n=n, r=r,
        col_id=None if col_ids_per_row is None
        else np.asarray(col_ids_per_row, dtype=np.uint8),
    )


def lf_step(tbl: LFTableArrays, interval: int, offset: int) -> tuple[int, int]:
    """LF(run, offset) with the fast-forward walk
    (include/ds/LF_table.hpp:251-262)."""
    di = int(tbl.dest_interval[interval])
    doff = int(tbl.dest_offset[interval]) + offset
    while doff >= tbl.get_length(di):
        doff -= tbl.get_length(di)
        di += 1
    return di, doff


def lf_step_idx(tbl: LFTableArrays, interval: int, offset: int) -> tuple[int, int, int]:
    """LF_idx (include/ds/LF_table.hpp:264-268): also return the rank coord."""
    di, doff = lf_step(tbl, interval, offset)
    return di, doff, int(tbl.idx[di]) + doff


def pred_char(tbl: LFTableArrays, run: int, c: int):
    """Largest run <= `run` with char c → (run, last offset), else None
    (include/ds/LF_table.hpp:271-283)."""
    while tbl.char[run] != c:
        if run == 0:
            return None
        run -= 1
    return run, tbl.get_length(run) - 1


def succ_char(tbl: LFTableArrays, run: int, c: int):
    """Smallest run >= `run` with char c → (run, 0), else None
    (include/ds/LF_table.hpp:286-298)."""
    while tbl.char[run] != c:
        if run == tbl.r - 1:
            return None
        run += 1
    return run, 0


def invert(tbl: LFTableArrays) -> bytes:
    """Regenerate text by LF walking from row 0 until a terminator
    (include/ds/LF_table.hpp:229-244).  Round-trip oracle."""
    out = bytearray()
    interval, offset = 0, 0
    while tbl.char[interval] > TERMINATOR:
        out.append(int(tbl.char[interval]))
        interval, offset = lf_step(tbl, interval, offset)
    return bytes(out)


# ---------------------------------------------------------------------------
# FL move table (include/ds/FL_table.hpp)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class FLTableArrays:
    """Structure-of-arrays FL (forward step) move table.

    Rows are F-runs: the L runs stably reordered by (char, L-position), with
    idx in F (rank) coordinate.  dest_* locate each F-run's text positions in
    the L subdivision, expressed in this table's own F-run intervals — exactly
    FL_table::compute_table (include/ds/FL_table.hpp:343-379).
    L_heads marks L-run starts in rank coordinate
    (compute_L_heads, include/ds/FL_table.hpp:381-391).
    """

    char: np.ndarray           # uint8 per F-run
    idx: np.ndarray            # int64 F start per run
    length: np.ndarray         # int64
    dest_interval: np.ndarray  # int64
    dest_offset: np.ndarray    # int64
    l_heads: np.ndarray        # int64: L-run start positions (sorted)
    n: int
    r: int

    def get_length(self, i: int) -> int:
        return int(self.length[i])

    @classmethod
    def from_arrays(cls, fields: dict):
        """The table from a dict of its fields, such as ``vars()`` of the
        JAX package's counterpart."""
        return from_fields(cls, fields)

    def get_idx(self, i: int) -> int:
        return int(self.idx[i])


def build_fl_table(heads: np.ndarray, lens: np.ndarray) -> FLTableArrays:
    heads = normalize_heads(heads)
    lens = np.asarray(lens, dtype=np.int64)
    r = heads.size
    n = int(lens.sum())
    l_start = np.zeros(r, dtype=np.int64)
    l_start[1:] = np.cumsum(lens[:-1])

    f_order = np.argsort(heads, kind="stable")
    f_char = heads[f_order]
    f_len = lens[f_order]
    f_idx = np.zeros(r, dtype=np.int64)
    f_idx[1:] = np.cumsum(f_len[:-1])

    # F-run j corresponds to original L run f_order[j]; its text positions sit
    # at L coordinate l_start[f_order[j]], located within the F-run subdivision.
    dest_pos = l_start[f_order]
    dest_interval = np.searchsorted(f_idx, dest_pos, side="right") - 1
    dest_offset = dest_pos - f_idx[dest_interval]
    return FLTableArrays(
        char=f_char, idx=f_idx, length=f_len,
        dest_interval=dest_interval.astype(np.int64),
        dest_offset=dest_offset.astype(np.int64),
        l_heads=l_start, n=n, r=r,
    )


def fl_step(tbl: FLTableArrays, interval: int, offset: int) -> tuple[int, int]:
    """FL(run, offset) forward step (include/ds/FL_table.hpp:227-238)."""
    di = int(tbl.dest_interval[interval])
    doff = int(tbl.dest_offset[interval]) + offset
    while doff >= tbl.get_length(di):
        doff -= tbl.get_length(di)
        di += 1
    return di, doff


def decompress(tbl: FLTableArrays) -> bytes:
    """Regenerate text by forward steps — the FL round-trip oracle
    (include/ds/FL_table.hpp:206-220; the reference does two warm-up steps to
    skip mumemto's extra trailing terminator, our text convention needs one:
    rank 0 is the first separator suffix, one FL step lands on text[0])."""
    out = bytearray()
    interval, offset = fl_step(tbl, 0, 0)
    while tbl.char[interval] > TERMINATOR:
        out.append(int(tbl.char[interval]))
        interval, offset = fl_step(tbl, interval, offset)
    return bytes(out)


# ---------------------------------------------------------------------------
# multi-MUM discovery (role of the mumemto fork; semantics per SURVEY §2.2)
# ---------------------------------------------------------------------------


def find_multi_mums(ranks: np.ndarray, sa: np.ndarray, lcp: np.ndarray,
                    doc_ids: np.ndarray, num_docs: int, min_mum: int = 1
                    ) -> tuple[np.ndarray, np.ndarray]:
    """Find multi-MUMs: matches of length >= min_mum occurring exactly once in
    every document, left- and right-maximal.

    Returns (lengths, bwt_positions) sorted ascending by BWT (rank) position —
    the order col_split's FL_loop consumes them in (include/col_split.hpp:70-99
    walks runs left to right).  BWT position is the rank-coordinate start of
    the N-high window of the MUM's suffixes, matching the .col_mums contract
    (src/col_split.cpp:90-106).

    Detection on (SA, LCP, doc): a window [i, i+N) is a multi-MUM iff
      - ell = min(lcp[i+1..i+N-1]) >= min_mum   (shared prefix length)
      - lcp[i] < ell and lcp[i+N] < ell          (uniqueness in collection)
      - the window covers all N documents        (one occurrence per doc)
      - the N preceding characters are not all equal (left-maximality;
        distinct separator ranks make doc-start occurrences unextendable)
    Right-maximality holds because ell is the window minimum.
    """
    n = ranks.size
    N = num_docs
    if N < 2 or n < N:
        return np.empty(0, dtype=np.int64), np.empty(0, dtype=np.int64)

    lcp_ext = np.r_[lcp, 0]  # lcp[n] = 0 boundary
    prev_rank = np.asarray(ranks, dtype=np.int64)[sa - 1]  # rank of char before each suffix
    sa_docs = np.asarray(doc_ids, dtype=np.int64)[sa]

    out_len: list[int] = []
    out_pos: list[int] = []
    for i in range(0, n - N + 1):
        ell = int(lcp_ext[i + 1:i + N].min())
        if ell < min_mum:
            continue
        if lcp_ext[i] >= ell or lcp_ext[i + N] >= ell:
            continue
        window_docs = sa_docs[i:i + N]
        if np.unique(window_docs).size != N:
            continue
        pc = prev_rank[i:i + N]
        if N > 0 and np.all(pc == pc[0]):
            continue  # all left-extensions identical -> not left-maximal
        out_len.append(ell)
        out_pos.append(i)
    lens = np.array(out_len, dtype=np.int64)
    pos = np.array(out_pos, dtype=np.int64)
    order = np.argsort(pos, kind="stable")
    return lens[order], pos[order]


# ---------------------------------------------------------------------------
# thresholds (role of mumemto -T; MONI semantics [inferred], validated by the
# optimal-repositioning property test in tests/test_thresholds.py)
# ---------------------------------------------------------------------------


def compute_thresholds(heads: np.ndarray, lens: np.ndarray, lcp: np.ndarray
                       ) -> np.ndarray:
    """One threshold per BWT run: for run i with char c, the rank-coordinate
    position of the minimum LCP value in (end of previous c-run, start of run
    i]; 0 for the first c-run.  Consumed per include/col_bwt.hpp:531-574:
    at a mismatch at position pos, the predecessor occurrence is preferred iff
    pos < threshold(successor run).
    """
    heads = normalize_heads(heads)
    lens = np.asarray(lens, dtype=np.int64)
    r = heads.size
    starts = np.zeros(r, dtype=np.int64)
    if r > 1:
        np.cumsum(lens[:-1], out=starts[1:])
    thresholds = np.zeros(r, dtype=np.int64)
    last_end: dict[int, int] = {}  # char -> rank coord one past previous c-run
    for i in range(r):
        c = int(heads[i])
        s = int(starts[i])
        if c in last_end:
            lo = last_end[c] + 1   # k ranges over (prev_end, curr_start]
            hi = s                  # inclusive
            seg = lcp[lo:hi + 1]
            thresholds[i] = lo + int(np.argmin(seg))
        else:
            thresholds[i] = 0
        last_end[c] = s + int(lens[i]) - 1
    return thresholds


def compute_thresholds_fast(heads: np.ndarray, lens: np.ndarray,
                            lcp: np.ndarray,
                            block: int = 1 << 27) -> np.ndarray:
    """Vectorized host thresholds, same contract as compute_thresholds.

    Segments for one character are disjoint and ascending in rank space,
    so per-char minima come from np.minimum.reduceat over keys packing
    (lcp, position) — the minimum key is (min lcp, first position of it),
    exactly np.argmin's tie-break.  The packed keys are materialized ONE
    position block at a time (per-segment partial minima carried across
    blocks), so extra memory is O(block + r), not the 8n of a full packed
    array: the round-4 n = 4.6e9 build spiked to 106 GB RSS in this stage
    (logs/chunked_4g_r4.log), which extrapolates past host RAM at n ~ 9e9.
    O(n·sigma) streaming host work; this is the wide-n (n >= 2**31) lane,
    where the device version's n-sized HBM arrays don't fit
    (ops.construct_jax notes)."""
    heads = normalize_heads(heads)
    lens = np.asarray(lens, dtype=np.int64)
    r = heads.size
    starts = np.zeros(r, dtype=np.int64)
    if r > 1:
        np.cumsum(lens[:-1], out=starts[1:])
    ends = starts + lens - 1
    n = int(lens.sum())
    thresholds = np.zeros(r, dtype=np.int64)
    if n == 0 or r == 0:
        return thresholds

    pos_bits = max(int(n - 1).bit_length(), 1)
    cap = (1 << (63 - pos_bits)) - 1  # lcp budget left in the packed key
    lcp_in = np.asarray(lcp)
    clamped = int(lcp_in.max(initial=0)) > cap

    # per-char segment tables: segment s for char c spans ranks
    # (ends[runs_c[s]], starts[runs_c[s+1]]] inclusive; lo/hi ascending
    # and pairwise disjoint because runs of one char are ordered
    segs = []
    for c in np.unique(heads):
        runs_c = np.flatnonzero(heads == c)
        if runs_c.size < 2:
            continue
        lo = ends[runs_c[:-1]] + 1
        hi = starts[runs_c[1:]]
        # int64 max: every real packed key (<= (cap << pos_bits) | pos)
        # replaces it, and a key that ties it is >= cap, so the clamped
        # re-fix path catches it
        best = np.full(lo.size, np.iinfo(np.int64).max)
        segs.append((runs_c, lo, hi, best))

    step = max(1, block)
    for bs in range(0, n, step):
        be = min(bs + step, n)
        blk = lcp_in[bs:be].astype(np.int64)
        if clamped:
            np.minimum(blk, cap, out=blk)
        blk <<= pos_bits
        blk += np.arange(bs, be, dtype=np.int64)
        for runs_c, lo, hi, best in segs:
            i0 = int(np.searchsorted(hi, bs))   # first segment with hi >= bs
            i1 = int(np.searchsorted(lo, be))   # first segment with lo >= be
            if i0 >= i1:
                continue
            blo = np.maximum(lo[i0:i1], bs) - bs
            bhi = np.minimum(hi[i0:i1] + 1, be) - bs
            bounds = np.empty(2 * (i1 - i0), dtype=np.int64)
            bounds[0::2] = blo
            bounds[1::2] = bhi
            # only the last clipped segment can end at the block edge
            # (segments are disjoint), and reduceat's final slice already
            # runs to the end
            if bounds[-1] == be - bs:
                bounds = bounds[:-1]
            red = np.minimum.reduceat(blk, bounds)[0::2]
            np.minimum(best[i0:i1], red, out=best[i0:i1])
        del blk

    pos_mask = (1 << pos_bits) - 1
    for runs_c, lo, hi, best in segs:
        arg = best & pos_mask
        if clamped:  # exact re-fix where clamping could hide the true argmin
            sus = np.flatnonzero((best >> pos_bits) >= cap)
            for s in sus:
                seg = lcp_in[lo[s]:hi[s] + 1]
                arg[s] = lo[s] + int(np.argmin(seg))
        thresholds[runs_c[1:]] = arg
    return thresholds


# ---------------------------------------------------------------------------
# col_split (include/col_split.hpp — THE core construction algorithm)
# ---------------------------------------------------------------------------


def fl_range(tbl: FLTableArrays, interval: int, offset: int, height: int
             ) -> list[tuple[int, int, int]]:
    """Forward-step a range, fragmenting at run ends
    (col_split::FL_range, include/col_split.hpp:226-247)."""
    out = []
    while height > 0:
        di, doff = fl_step(tbl, interval, offset)
        run_len = tbl.get_length(interval)
        if offset + height > run_len:
            covered = run_len - offset
            out.append((di, doff, covered))
            height -= covered
            offset = 0
        else:
            out.append((di, doff, height))
            height = 0
        interval += 1
    return out


def col_split_oracle(tbl: FLTableArrays, mum_lens: np.ndarray, mum_pos: np.ndarray,
                     num_docs: int, split_rate: int = 10, mode: str = "tunnels",
                     id_bits: int = 8
                     ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The two-pass FL-walk marking col sub-run boundaries
    (col_split::split, include/col_split.hpp:54-136).

    Returns (mark_positions sorted, mark_ids, mark_heights): one entry per
    marked rank-coordinate position.  ID semantics per collect_ids
    (include/col_split.hpp:114-127): Tunneled = last writer wins; All = the
    greater height wins, ties keep the existing id.  IDs are binned into
    [1, 2**id_bits - 1] at record time (bin_id, include/col_split.hpp:222-224).
    """
    N = num_docs
    marks: dict[int, tuple[int, int]] = {}  # pos -> (binned id, height)
    tunneled = mode in ("tunnels", "tunneled")
    id_max = 1 << id_bits

    def bin_id(ident: int) -> int:
        return (ident % (id_max - 1)) + 1 if ident >= id_max else ident

    def walk(record):
        # MUMs are consumed in rank-position order with 1-based ids
        # (include/col_split.hpp:66-99).
        order = np.argsort(np.asarray(mum_pos), kind="stable")
        for c_id0, m in enumerate(order):
            pos = int(mum_pos[m])
            length = int(mum_lens[m])
            c_id = c_id0 + 1
            interval = int(np.searchsorted(tbl.idx, pos, side="right") - 1)
            off = pos - int(tbl.idx[interval])
            ranges = fl_range(tbl, interval, off, N)
            skip = tunneled and len(ranges) > 1
            j = 0
            while j < length and not skip:
                next_ranges: list[tuple[int, int, int]] = []
                for (ri, ro, rh) in ranges:
                    if j % split_rate == 0:
                        record(int(tbl.idx[ri]) + ro, c_id, rh)
                    next_ranges.extend(fl_range(tbl, ri, ro, rh))
                ranges = next_ranges
                skip = tunneled and len(ranges) > 1
                j += 1

    # Pass 1 marks boundaries; pass 2 fills ids.  A single pass collecting
    # both reproduces the same result because pass 2's writes are keyed by
    # position with the same visit order.
    def record(pos: int, c_id: int, height: int):
        if mode == "all" and pos in marks:
            old_id, old_h = marks[pos]
            if old_h >= height:
                marks[pos] = (old_id, old_h)
            else:
                marks[pos] = (bin_id(c_id), height)
        else:
            marks[pos] = (bin_id(c_id), height)

    walk(record)
    if not marks:
        z = np.empty(0, dtype=np.int64)
        return z, z.copy(), z.copy()
    positions = np.array(sorted(marks), dtype=np.int64)
    ids = np.array([marks[p][0] for p in positions], dtype=np.int64)
    heights = np.array([marks[p][1] for p in positions], dtype=np.int64)
    return positions, ids, heights


def find_col_runs_oracle(mark_pos: np.ndarray, mark_ids: np.ndarray,
                         mark_heights: np.ndarray, l_heads: np.ndarray, n: int
                         ) -> tuple[np.ndarray, np.ndarray]:
    """Merge marked col intervals with BWT run heads into the final
    (col_runs bit positions, per-bit ids) — exact semantics of
    col_split::find_col_runs (include/col_split.hpp:258-338):

    - every BWT run head gets a bit, id = id of the region covering it;
    - a mark opening an interval into an empty heap claims ownership (bit at
      its start, its id) if id > 0;
    - when an interval ends leaving exactly one open interval with a later
      end, ownership transfers (bit at the end position, remaining id);
    - when the heap empties strictly before the next event, coverage closes
      (bit with id 0);
    - overlapping (>=2 open) regions record no transition — the reference's
      first-claimer-wins quirk, preserved deliberately.
    """
    if mark_pos.size == 0:
        return np.empty(0, dtype=np.int64), np.empty(0, dtype=np.int64)

    bits: list[int] = []
    ids: list[int] = []
    heap: list[tuple[int, int, int]] = []  # (end, start, id)
    run_heads = np.asarray(l_heads, dtype=np.int64)
    cursor = 0  # next unconsumed run head
    last_id = 0

    def set_bit(pos: int, ident: int):
        bits.append(pos)
        ids.append(ident)

    def update_bwt_pos(idx: int, ident: int):
        nonlocal cursor, last_id
        while cursor < run_heads.size and run_heads[cursor] < idx:
            set_bit(int(run_heads[cursor]), last_id)
            cursor += 1
        if cursor < run_heads.size and run_heads[cursor] == idx:
            cursor += 1
        last_id = ident

    def update_col_ranges(idx: int):
        while heap and heap[0][0] <= idx:
            end, _start, _ident = heapq.heappop(heap)
            if len(heap) == 1 and heap[0][0] > end:
                keep_id = heap[0][2]
                update_bwt_pos(end, keep_id)
                set_bit(end, keep_id)
            elif not heap and end < idx:
                update_bwt_pos(end, 0)
                set_bit(end, 0)

    for p, ident, h in zip(mark_pos.tolist(), mark_ids.tolist(), mark_heights.tolist()):
        update_col_ranges(p)
        heapq.heappush(heap, (p + h, p, ident))
        if len(heap) == 1 and ident > 0:
            update_bwt_pos(p, ident)
            set_bit(p, ident)
    update_col_ranges(n)
    update_bwt_pos(n, 0)

    order = np.argsort(np.array(bits, dtype=np.int64), kind="stable")
    return (np.array(bits, dtype=np.int64)[order],
            np.array(ids, dtype=np.int64)[order])


# ---------------------------------------------------------------------------
# col_bwt construction: split RLBWT runs at col_runs, attach ids + thresholds
# (col_bwt RLBWT ctor include/col_bwt.hpp:124-230 + read_thresholds :440-457)
# ---------------------------------------------------------------------------


def build_col_pml(heads: np.ndarray, lens: np.ndarray,
                  split_pos: np.ndarray, split_ids: np.ndarray,
                  thresholds_per_bwt_run: np.ndarray) -> LFTableArrays:
    """Build the queryable col_pml move table.

    Sub-run boundaries = BWT run starts ∪ split positions; each sub-run's
    col_id is the id attached to the largest split position <= its start
    (the curr_id persistence of the reference ctor); thresholds replicate per
    BWT run onto its equal-char sub-runs.
    """
    heads = normalize_heads(heads)
    lens = np.asarray(lens, dtype=np.int64)
    bwt_r = heads.size
    run_starts = np.zeros(bwt_r, dtype=np.int64)
    if bwt_r > 1:
        np.cumsum(lens[:-1], out=run_starts[1:])

    split_pos = np.asarray(split_pos, dtype=np.int64)
    split_ids = np.asarray(split_ids, dtype=np.int64)

    boundaries = np.union1d(run_starts, split_pos)
    # char / bwt-run of each sub-run
    owner = np.searchsorted(run_starts, boundaries, side="right") - 1
    sub_char = heads[owner]
    sub_thr = np.asarray(thresholds_per_bwt_run, dtype=np.int64)[owner]
    # id: largest split position <= sub-run start, persisting across runs;
    # sub-runs before the first split (or with no splits at all) have id 0.
    if split_pos.size:
        k = np.searchsorted(split_pos, boundaries, side="right") - 1
        sub_id = np.where(k >= 0, split_ids[np.maximum(k, 0)], 0)
    else:
        sub_id = np.zeros(boundaries.size, dtype=np.int64)

    n = int(lens.sum())
    sub_len = np.diff(np.r_[boundaries, n])
    keep = sub_len > 0
    boundaries, sub_char, sub_id, sub_thr, sub_len = (
        boundaries[keep], sub_char[keep], sub_id[keep], sub_thr[keep], sub_len[keep])

    tbl = build_lf_table(sub_char, sub_len)
    tbl.col_id = sub_id.astype(np.uint8)
    tbl.threshold = sub_thr
    tbl.bwt_r = bwt_r
    return tbl


def build_col_pml_from_plain_bwt(bwt: bytes | np.ndarray,
                                 split_pos: np.ndarray, split_ids: np.ndarray,
                                 thresholds_per_bwt_run: np.ndarray
                                 ) -> LFTableArrays:
    """col_bwt construction from the explicit BWT string (the plain-BWT
    constructor surface, include/col_bwt.hpp:232-329): run-length encode the
    raw BWT, then split at col_runs positions exactly like the RLBWT path.

    Note the reference's own plain-BWT ctor is dead code with a latent bug:
    its char counter ``i`` never increments inside the read loop (it only
    increments when a run is pushed, which is gated on ``i != 0`` — initially
    false and never made true), so the in-loop run push can never fire and
    nothing in the repo calls this ctor (build_col_bwt uses the RLBWT ctor at
    src/build_col_bwt.cpp:38).  This function implements the *intended*
    semantics, which — given col_split marks every BWT run head inside
    covered regions (include/col_split.hpp:258-372) — produce the identical
    table to the RLBWT path (differential-tested)."""
    arr = (np.frombuffer(bwt, dtype=np.uint8) if isinstance(bwt, bytes)
           else np.asarray(bwt, dtype=np.uint8))
    # terminator normalization happens BEFORE run detection in the reference
    # ctor (`if (c <= TERMINATOR) c = TERMINATOR` precedes the last_c compare)
    heads, lens = rle(normalize_heads(arr))
    return build_col_pml(heads, lens, split_pos, split_ids,
                         thresholds_per_bwt_run)


# ---------------------------------------------------------------------------
# the query recurrence (col_pml::_query_pml, include/col_bwt.hpp:498-529)
# ---------------------------------------------------------------------------


def query_pml_oracle(tbl: LFTableArrays, pattern: bytes
                     ) -> tuple[np.ndarray, np.ndarray]:
    """Per-base PML + CID for one pattern — THE loop the device kernels must
    reproduce exactly (SURVEY §3.3).  Returns (pml, cid) of length m in
    pattern order (values computed right-to-left, stored at m-1-i).
    """
    m = len(pattern)
    pml = np.zeros(m, dtype=np.int64)
    cid = np.zeros(m, dtype=np.int64)

    pos = tbl.n - 1
    interval = tbl.r - 1
    offset = tbl.get_length(interval) - 1
    length = 0

    for i in range(m):
        c = pattern[m - 1 - i]
        col_id = int(tbl.col_id[interval]) if tbl.col_id is not None else 0
        if int(tbl.char[interval]) == c:
            length += 1
        else:
            length = 0
            interval, offset = _threshold_step(tbl, interval, offset, pos, c)
        pml[m - 1 - i] = length
        cid[m - 1 - i] = col_id
        interval, offset, pos = lf_step_idx(tbl, interval, offset)
    return pml, cid


def _threshold_step(tbl: LFTableArrays, interval: int, offset: int,
                    pos: int, c: int) -> tuple[int, int]:
    """Threshold-based repositioning (include/col_bwt.hpp:531-574): take the
    successor c-run; if pos < its threshold (or no successor), prefer the
    predecessor when it exists."""
    new_interval, new_offset = interval, offset
    thr = tbl.n
    succ = succ_char(tbl, interval, c)
    if succ is not None:
        si, so = succ
        thr = int(tbl.threshold[si]) if tbl.threshold is not None else 0
        new_interval, new_offset = si, so
    if pos < thr:
        pred = pred_char(tbl, interval, c)
        if pred is not None:
            new_interval, new_offset = pred
    return new_interval, new_offset
