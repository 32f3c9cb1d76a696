"""Host col-split walk for tunneled mode, with no JAX.

A copy of `col_split_tunneled_numpy` and its `_bin_id` helper from
colbwt_tpu/ops/colsplit_jax.py:127-213, whose module imports jax at load
time.  The port's build runs this walk on the host until the device FL
walk (colsplit_jax._tunneled_walk) is ported (ROADMAP Queue 1 item 10).
Outputs equal colbwt_tpu.ops.oracle.col_split_oracle(mode="tunnels").
"""

from __future__ import annotations

import numpy as np

from colbwt_tpu.ops.oracle import FLTableArrays


def _bin_id(ids: np.ndarray, id_bits: int) -> np.ndarray:
    id_max = 1 << id_bits
    ids = np.asarray(ids, dtype=np.int64)
    return np.where(ids >= id_max, (ids % (id_max - 1)) + 1, ids)


def col_split_tunneled_numpy(fl: FLTableArrays, mum_lens: np.ndarray,
                             mum_pos: np.ndarray, num_docs: int,
                             split_rate: int = 10, id_bits: int = 8
                             ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host int64 tunneled walk: (mark positions sorted, binned mark ids,
    mark heights).

    All MUM walkers advance one FL step per iteration, a walker dies when
    its N-high range fragments (a run boundary inside [p, p+N), detected as
    p+N-1 reaching past the next run start), and positions are marked every
    split_rate steps while alive (include/col_split.hpp:70-99).  Where two
    marks land on one position, the last in visit order (MUM position
    order, then step) wins.
    """
    M = int(np.asarray(mum_pos).size)
    if M == 0:
        z = np.empty(0, dtype=np.int64)
        return z, z.copy(), z.copy()
    N = num_docs
    idx = np.asarray(fl.idx, dtype=np.int64)
    nxt_start = np.empty(idx.size, dtype=np.int64)
    nxt_start[:-1] = idx[1:]
    nxt_start[-1] = fl.n
    dest_i = np.asarray(fl.dest_interval, dtype=np.int64)
    dest_o = np.asarray(fl.dest_offset, dtype=np.int64)

    order = np.argsort(np.asarray(mum_pos), kind="stable")
    pos0 = np.asarray(mum_pos, dtype=np.int64)[order]
    lens0 = np.asarray(mum_lens, dtype=np.int64)[order]
    c_ids0 = np.arange(1, M + 1, dtype=np.int64)
    g_t = int(lens0.max()) + 1  # visit-key stride

    # ascending by length: finished lanes form a moving prefix
    by_len = np.argsort(lens0, kind="stable")
    p = pos0[by_len].copy()
    lens = lens0[by_len]
    cid = c_ids0[by_len]
    alive = np.ones(M, dtype=bool)
    T = int(lens[-1])

    out_pos: list[np.ndarray] = []
    out_id: list[np.ndarray] = []
    out_visit: list[np.ndarray] = []
    for t in range(T):
        lo = int(np.searchsorted(lens, t, side="right"))
        if lo:  # drop finished lanes (and any dead lanes swept along)
            p, lens, cid, alive = p[lo:], lens[lo:], cid[lo:], alive[lo:]
        if p.size == 0:
            break
        i = np.searchsorted(idx, p, side="right") - 1
        frag = p + N - 1 >= nxt_start[i]
        alive &= ~frag
        if not alive.any():
            break  # every remaining lane is dead
        p_next = idx[dest_i[i]] + dest_o[i] + (p - idx[i])
        np.copyto(p, p_next, where=alive)
        if t % split_rate == 0:
            live = np.flatnonzero(alive)
            out_pos.append(p[live])
            out_id.append(cid[live])
            out_visit.append(cid[live] * g_t + t)
        # compact dead lanes once they dominate
        if t % 256 == 255 and alive.size and alive.mean() < 0.5:
            keep = alive
            p, lens, cid, alive = p[keep], lens[keep], cid[keep], alive[keep]

    if not out_pos:
        z = np.empty(0, dtype=np.int64)
        return z, z.copy(), z.copy()
    pos_all = np.concatenate(out_pos)
    ids_all = _bin_id(np.concatenate(out_id), id_bits)
    visit = np.concatenate(out_visit)
    o = np.lexsort((visit, pos_all))
    pos_s, ids_s = pos_all[o], ids_all[o]
    last = np.r_[pos_s[1:] != pos_s[:-1], True]
    heights = np.full(int(last.sum()), N, dtype=np.int64)
    return pos_s[last], ids_s[last], heights
