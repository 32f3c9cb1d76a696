"""Move-structure run splitting: bound the LF fast-forward at K steps — the
port's copy of colbwt_tpu/ops/run_split.py.

The reference's LF walk (include/ds/LF_table.hpp:256-259) advances through
destination runs until the offset fits — unbounded in the worst case.  Movi
bounds it by Nishimoto–Tabei-style run splitting [inferred, SURVEY §2.2]: here
we split source runs until every run's LF image overlaps at most `k` runs, so
the device kernel can replace the data-dependent while-loop with k-1 statically
unrolled conditional advances (pure gathers, no dynamic control flow).

Splitting is semantics-preserving for the query recurrence: sub-runs inherit
char / col_id / threshold, pred/succ jump targets land on the same rank
coordinates (first/last piece boundaries coincide with the original run's),
and LF is the same function of rank positions.  Differential tests assert
exact output equality split vs unsplit.
"""

from __future__ import annotations

import numpy as np

from colbwt_tpu_torch.ops.oracle import LFTableArrays, build_lf_table


def _lf_dest_positions(char: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Rank-coordinate LF destination start of each run (F start)."""
    f_order = np.argsort(char, kind="stable")
    f_start = np.zeros(char.size, dtype=np.int64)
    f_start[1:] = np.cumsum(lens[f_order][:-1])
    dest = np.empty(char.size, dtype=np.int64)
    dest[f_order] = f_start
    return dest


def split_runs_bounded_ff(tbl: LFTableArrays, k: int = 4, max_rounds: int = 512,
                          strict: bool = False) -> LFTableArrays:
    """Return a new LF table whose every run's LF image spans few runs,
    targeting <= k.

    Worklist formulation: position-level LF is unchanged by splitting (it is
    affine inside each original run), so everything runs in position space
    against the ORIGINAL table.  Round 1 checks every run; after a round cuts
    new boundaries, only runs whose LF images contain those boundaries (at
    most one per char per boundary, found by per-char image search) plus the
    pieces of the cut runs can newly violate — each tail round costs
    O(affected * log r) instead of the old O(r log r) full recompute
    (the docs/ROUND_NOTES.md item-5a straggler: ~20 tail rounds fixing <5k
    runs each at r=5.6M).

    Runs whose LF image overlaps *themselves* (long self-mapping repeats) can
    oscillate — each cut inserts a boundary into the run's own image — so
    exact k is not always reachable; after max_rounds the best achieved bound
    stands (query engines unroll to the *achieved* bound, read it back with
    max_ff_span).  strict=True raises instead."""
    if k < 1:
        raise ValueError("k must be >= 1")
    char0 = np.asarray(tbl.char, dtype=np.uint8)
    lens0 = np.asarray(tbl.length, dtype=np.int64)
    r0 = char0.size
    n = int(lens0.sum())
    starts0 = np.zeros(r0, dtype=np.int64)
    starts0[1:] = np.cumsum(lens0[:-1])
    dest0 = _lf_dest_positions(char0, lens0)

    # per-char original tiling for pre-image lookups: c-run images tile the
    # c-bucket contiguously in rank order
    per_char = []
    for c in np.unique(char0):
        runs_c = np.flatnonzero(char0 == c)
        c_imgs = dest0[runs_c]
        per_char.append((starts0[runs_c], c_imgs, int(c_imgs[0]),
                         int(c_imgs[-1] + lens0[runs_c[-1]])))

    def lf_pos(p: np.ndarray) -> np.ndarray:
        o = np.searchsorted(starts0, p, side="right") - 1
        return dest0[o] + (p - starts0[o])

    bounds = starts0
    cand = starts0  # run-start positions to (re)check
    converged = False
    for _ in range(max_rounds):
        # span of candidate runs under the current bounds
        i = np.searchsorted(bounds, cand, side="left")
        ends = np.where(i + 1 < bounds.size, bounds[np.minimum(i + 1,
                        bounds.size - 1)], n)
        ln = ends - cand
        d = lf_pos(cand)
        first_in = np.searchsorted(bounds, d, side="right")
        cnt = np.searchsorted(bounds, d + ln, side="left") - first_in
        cuts_per = np.maximum(cnt // k, 0)  # internal boundaries kept: k-1
        bad = np.flatnonzero(cuts_per > 0)
        if bad.size == 0:
            converged = True
            break
        # cut j of bad run b at the pre-image of its (k*j)-th internal
        # boundary (1-indexed), vectorized over all (run, cut) pairs
        c = cuts_per[bad]
        rep = np.repeat(bad, c)
        jj = np.arange(rep.size, dtype=np.int64) - np.repeat(
            np.cumsum(c) - c, c) + 1
        b_at = bounds[first_in[rep] + k * jj - 1]
        cut_abs = np.unique(cand[rep] + (b_at - d[rep]))
        # drop cuts that already are boundaries
        at = np.searchsorted(bounds, cut_abs)
        is_new = (at >= bounds.size) | (bounds[np.minimum(at,
                  bounds.size - 1)] != cut_abs)
        new_b = cut_abs[is_new]
        if new_b.size == 0:
            converged = True
            break
        bounds = np.insert(bounds, np.searchsorted(bounds, new_b), new_b)
        # next candidates: pieces of the cut runs + runs whose images
        # contain a new boundary (one per char, via original tiling)
        nxt = [cand[bad], new_b]
        for c_starts, c_imgs, blo, bhi in per_char:
            b = new_b[(new_b > blo) & (new_b < bhi)]
            if not b.size:
                continue
            j = np.searchsorted(c_imgs, b, side="right") - 1
            pre = c_starts[j] + (b - c_imgs[j])
            # start of the current run containing each pre-image
            at2 = np.searchsorted(bounds, pre, side="right") - 1
            nxt.append(bounds[at2])
        cand = np.unique(np.concatenate(nxt))
    if strict and not converged:
        raise RuntimeError(f"run splitting did not converge to k={k}")

    owner = np.searchsorted(starts0, bounds, side="right") - 1
    new_lens = np.diff(np.r_[bounds, n])
    out = build_lf_table(char0[owner], new_lens)
    out.col_id = (None if tbl.col_id is None
                  else np.asarray(tbl.col_id)[owner])
    out.threshold = (None if tbl.threshold is None
                     else np.asarray(tbl.threshold, dtype=np.int64)[owner])
    out.bwt_r = tbl.bwt_r
    return out


def split_runs_max_len(tbl: LFTableArrays, max_len: int) -> LFTableArrays:
    """Cut every run longer than max_len into <= max_len pieces.

    Needed by the wide (n >= 2**31) engines: intra-run offsets and
    destination offsets must fit one int32 limb (ops.query_mega_wide), so run
    lengths are capped at 2**29-class values.  Semantics-preserving for the
    same reason ff splitting is (sub-runs inherit char/col_id/threshold and
    LF is a function of rank positions).  Run AFTER this the ff-bound pass —
    ff cuts only shorten runs, so the cap survives; cap cuts can widen other
    runs' LF spans, which the ff pass then fixes.
    """
    if max_len < 1:
        raise ValueError("max_len must be >= 1")
    lens = np.asarray(tbl.length, dtype=np.int64)
    counts = (lens - 1) // max_len  # extra cuts per run
    bad = np.flatnonzero(counts > 0)
    if bad.size == 0:
        return tbl
    char = np.asarray(tbl.char, dtype=np.uint8)
    starts = np.zeros(char.size, dtype=np.int64)
    starts[1:] = np.cumsum(lens[:-1])
    c = counts[bad]
    rep = np.repeat(bad, c)
    jj = np.arange(rep.size, dtype=np.int64) - np.repeat(np.cumsum(c) - c, c) + 1
    cut_abs = starts[rep] + jj * max_len
    bounds = np.concatenate([starts, cut_abs])
    bounds.sort(kind="stable")
    owner = np.searchsorted(starts, bounds, side="right") - 1
    new_lens = np.diff(np.r_[bounds, int(lens.sum())])
    out = build_lf_table(char[owner], new_lens)
    out.col_id = None if tbl.col_id is None else np.asarray(tbl.col_id)[owner]
    out.threshold = (None if tbl.threshold is None
                     else np.asarray(tbl.threshold, dtype=np.int64)[owner])
    out.bwt_r = tbl.bwt_r
    return out


def max_ff_span(tbl: LFTableArrays) -> int:
    """Largest number of runs any run's LF image overlaps (the fast-forward
    bound actually achieved)."""
    char = np.asarray(tbl.char, dtype=np.uint8)
    lens = np.asarray(tbl.length, dtype=np.int64)
    starts = np.zeros(char.size, dtype=np.int64)
    starts[1:] = np.cumsum(lens[:-1])
    dest = _lf_dest_positions(char, lens)
    lo = np.searchsorted(starts, dest, side="right") - 1
    hi = np.searchsorted(starts, dest + lens - 1, side="right") - 1
    return int((hi - lo + 1).max(initial=1))
