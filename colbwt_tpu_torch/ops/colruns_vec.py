"""Vectorized find_col_runs for uniform interval heights (tunneled mode) —
the port's copy of colbwt_tpu/ops/colruns_vec.py.

The reference's sweep (col_split::find_col_runs, include/col_split.hpp:258-338)
is a priority-queue scan.  In tunneled mode every marked interval has height
exactly N (the document count), so ends arrive in start order — the heap is a
FIFO and the whole sweep collapses into rank arithmetic:

- open(x) = #starts <= x  -  #ends <= x   (the live-interval count)
- a start claims ownership iff nothing was open before it and its id > 0
  (the reference's "push into empty heap" branch);
- an end transfers ownership iff exactly one interval remains open (its id is
  the last start <= that end — contiguity of the open window);
- an end closes coverage (id 0) iff nothing remains open and the next event
  lies strictly beyond it;
- BWT run heads are then interleaved: a head coinciding with a transition is
  consumed by it, otherwise it carries the id of the latest transition
  strictly before it (update_bwt_pos's last_id semantics).

Differential-tested for exact equality against the heapq oracle; the general
(mixed-height, All-mode) case stays on oracle.find_col_runs_oracle.
"""

from __future__ import annotations

import numpy as np


def find_col_runs_uniform(mark_pos: np.ndarray, mark_ids: np.ndarray,
                          height: int, l_heads: np.ndarray, n: int
                          ) -> tuple[np.ndarray, np.ndarray]:
    """Exact vectorized equivalent of oracle.find_col_runs_oracle when every
    mark has the same height."""
    p = np.asarray(mark_pos, dtype=np.int64)
    ids = np.asarray(mark_ids, dtype=np.int64)
    if p.size == 0:
        return np.empty(0, dtype=np.int64), np.empty(0, dtype=np.int64)
    m = p.size
    e = p + height  # ends, strictly increasing like p

    # open-count before processing start i: intervals j < i with e_j > p_i
    # (the reference pops ends <= p_i before pushing start i)
    popped_before_start = np.searchsorted(e, p, side="right")  # e_j <= p_i
    open_before_start = np.arange(m) - np.minimum(popped_before_start,
                                                  np.arange(m))
    claim = (open_before_start == 0) & (ids > 0)

    # when end i is popped, the pop happens while processing the first start
    # k with p_k >= e_i (or the final flush); intervals open after the pop:
    # starts already pushed (j < k, i.e. p_j < e_i ... but pushes happen for
    # p_j <= current event; starts with p_j < e_i were pushed before e_i pops)
    # minus ends popped (j <= i).  Contiguity: open window is (i, last_pushed].
    last_pushed = np.searchsorted(p, e, side="left") - 1  # max j with p_j < e_i
    open_after_end = last_pushed - np.arange(m)
    pops = e <= n  # intervals running past n are never popped (final flush
    #                pops ends <= n only; include/col_split.hpp:336)
    transfer = pops & (open_after_end == 1)
    transfer_id = ids[np.minimum(last_pushed, m - 1)]

    # close: nothing open after, and the end lies strictly before the next
    # start (or before n for the trailing flush)
    next_start = np.full(m, n, dtype=np.int64)
    k = np.searchsorted(p, e, side="left")
    valid_next = k < m
    next_start[valid_next] = p[np.minimum(k, m - 1)][valid_next]
    close = pops & (open_after_end == 0) & (e < next_start)

    # transitions in sweep order: by position; at equal positions the
    # reference pops ends (<= idx) before pushing the start, so ends first
    t_pos = np.concatenate([p[claim], e[transfer], e[close]])
    t_id = np.concatenate([ids[claim], transfer_id[transfer],
                           np.zeros(int(close.sum()), dtype=np.int64)])
    t_kind = np.concatenate([np.ones(int(claim.sum()), dtype=np.int8),
                             np.zeros(int(transfer.sum()), dtype=np.int8),
                             np.zeros(int(close.sum()), dtype=np.int8)])
    order = np.lexsort((t_kind, t_pos))  # ends (kind 0) before starts (kind 1)
    return _interleave_heads(t_pos[order], t_id[order], l_heads)


def _interleave_heads(t_pos: np.ndarray, t_id: np.ndarray, l_heads: np.ndarray
                      ) -> tuple[np.ndarray, np.ndarray]:
    """Merge sorted transitions with BWT run heads (update_bwt_pos): heads
    coinciding with a transition are consumed; others carry the id of the
    latest transition strictly before them (last_id), 0 if none."""
    heads = np.asarray(l_heads, dtype=np.int64)
    consumed = np.isin(heads, t_pos)
    free_heads = heads[~consumed]
    j = np.searchsorted(t_pos, free_heads, side="left") - 1  # last transition < h
    head_ids = np.where(j >= 0, t_id[np.maximum(j, 0)], 0)

    bits = np.concatenate([t_pos, free_heads])
    out_ids = np.concatenate([t_id, head_ids])
    o = np.argsort(bits, kind="stable")
    return bits[o], out_ids[o]


def find_col_runs_mixed(mark_pos: np.ndarray, mark_ids: np.ndarray,
                        mark_heights: np.ndarray, l_heads: np.ndarray, n: int
                        ) -> tuple[np.ndarray, np.ndarray]:
    """Exact vectorized equivalent of oracle.find_col_runs_oracle for
    arbitrary (mixed) interval heights — the All-mode sweep.

    The priority-queue scan becomes a sorted event stream (ends before starts
    at equal positions; ends tie-broken by the reference's heap tuple order
    (end, start, id)) with three cumulative quantities:

    - open count: +1 per start, -1 per popped end (ends past n never pop);
    - running token sum: +(j+1) per start of mark j, -(j+1) per popped end —
      when exactly one interval is open, the sum IS its token (the classic
      unique-survivor identity), giving the transfer id in O(1);
    - next-start position: suffix scan, for the strictly-before close test.

    Claims fire at starts pushed into an empty heap (id > 0); transfers at
    pops leaving exactly one open interval whose end lies strictly beyond;
    closes at pops emptying the heap strictly before the next start (or n).
    Differential-tested against the heapq oracle.
    """
    p = np.asarray(mark_pos, dtype=np.int64)
    ids = np.asarray(mark_ids, dtype=np.int64)
    h = np.asarray(mark_heights, dtype=np.int64)
    if p.size == 0:
        return np.empty(0, dtype=np.int64), np.empty(0, dtype=np.int64)
    m = p.size
    e = p + h
    popped = e <= n  # final flush pops ends <= n only (include/col_split.hpp:336)

    end_tok = np.flatnonzero(popped)
    end_tok = end_tok[np.lexsort((ids[end_tok], p[end_tok], e[end_tok]))]
    ev_pos = np.concatenate([p, e[end_tok]])
    ev_start = np.concatenate([np.ones(m, dtype=bool),
                               np.zeros(end_tok.size, dtype=bool)])
    ev_tok = np.concatenate([np.arange(m, dtype=np.int64), end_tok])
    order = np.lexsort((ev_start, ev_pos))  # pos, then ends (False) first
    pos_s = ev_pos[order]
    start_s = ev_start[order]
    tok_s = ev_tok[order]

    sign = np.where(start_s, 1, -1)
    cnt = np.cumsum(sign)                       # open count after each event
    tsum = np.cumsum(sign * (tok_s + 1))        # sum of open tokens (+1 bias)

    claim = start_s & (cnt == 1) & (ids[tok_s] > 0)

    is_end = ~start_s
    ut = np.clip(tsum - 1, 0, m - 1)            # the unique open token if cnt==1
    transfer = is_end & (cnt == 1) & (e[ut] > pos_s)
    transfer_id = ids[ut]

    # next start event position after each stream index (suffix minimum of
    # start positions; positions are sorted, so a reversed cummin works)
    nsp = np.where(start_s, pos_s, n)
    next_start_pos = np.concatenate(
        [np.minimum.accumulate(nsp[::-1])[::-1][1:], [n]])
    close = is_end & (cnt == 0) & (pos_s < next_start_pos)

    t_mask = claim | transfer | close
    t_pos = pos_s[t_mask]
    t_id = np.where(claim, ids[np.clip(tok_s, 0, m - 1)],
                    np.where(transfer, transfer_id, 0))[t_mask]
    return _interleave_heads(t_pos, t_id, l_heads)
