"""Col-split FL walk — port of colbwt_tpu/ops/colsplit_jax.py.

Every multi-MUM's N-high BWT range walks forward one FL step at a time,
and positions are marked every split_rate steps (include/col_split.hpp:
54-136).  All MUMs of a bucket advance in lockstep:

- tunnels mode: a MUM's range survives only while its FL image stays one
  contiguous range, so a walker is one (position, alive) pair — K10a
  `tunneled_walk` (replaces colsplit_jax.py:59 _tunneled_walk);
- all mode: the range is N unit walkers whose fragments split for good at
  run heads — K10b `all_walk` (replaces colsplit_jax.py:84 _all_walk),
  for N <= 64.

Both kernels are in csrc/colsplit.cu, each with its plain PyTorch version
(`tunneled_walk_ref`, `all_walk_ref`) beside it; a wrapper runs the plain
version only for tensors on the CPU, and for a CUDA tensor launches the
kernel or raises.  `col_split` is the driver of colsplit_jax.col_split_jax:
bucketing by step_budget, the visit keys and both mark merges (NumPy).

The host walkers — `col_split_tunneled_numpy` (int64, the n >= 2**31
lane) and `col_split_all_numpy` (fragment events, all mode at any N and
the wide lane) — are jax-free copies of colsplit_jax.py:133-299.
"""

from __future__ import annotations

from collections.abc import Iterator

import numpy as np
import torch

from colbwt_tpu_torch.models.tensors import wrap32
from colbwt_tpu_torch.ops.oracle import FLTableArrays
from colbwt_tpu_torch.ops import _kernels as K
from colbwt_tpu_torch.utils.device import resolve_device

FL_FIELDS = ("idx", "dest_interval", "dest_offset")


def fl_tensors(fl: FLTableArrays, device) -> dict[str, torch.Tensor]:
    """The FL table's arrays as int32 tensors on `device` (the counterpart
    of colsplit_jax.fl_device_arrays), and the rows K10a and K10b walk
    (`walk_rows`)."""
    dev = resolve_device(device)
    fd = {f: torch.from_numpy(np.asarray(getattr(fl, f), dtype=np.int32))
          .to(dev) for f in FL_FIELDS}
    fd["rows"] = walk_rows(fd)
    return fd


def walk_rows(fd: dict) -> torch.Tensor:
    """K10a's and K10b's move-structure rows, (r, 4) int32, one a run j:
    idx[j], the next run's start idx[j+1] (INT32_MAX past the last run,
    which the kernels never compare), dest_head = idx[clip(dest_interval[j])]
    + dest_offset[j] wrapped to int32, and clip(dest_interval[j]).  The
    plain versions do not read them."""
    idx = fd["idx"]
    r = idx.shape[0]
    dest = fd["dest_interval"].long().clamp(0, r - 1)
    nxt = torch.cat([idx[1:], idx.new_full((1,), (1 << 31) - 1)])
    head = wrap32(idx.long()[dest] + fd["dest_offset"].long())
    return torch.stack([idx, nxt, head, dest.to(torch.int32)], 1).contiguous()


def _take(arr: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    return arr[i.long().clamp(0, arr.shape[0] - 1)]  # jnp.take mode="clip"


def fl_unit_ref(fd: dict, p: torch.Tensor) -> torch.Tensor:
    """One FL step of int32 rank positions (colsplit_jax.py:49 _fl_unit)."""
    i = torch.searchsorted(fd["idx"], p, right=True).to(torch.int32) - 1
    return (_take(fd["idx"], _take(fd["dest_interval"], i))
            + _take(fd["dest_offset"], i) + (p - _take(fd["idx"], i)))


def tunneled_walk_ref(fd: dict, p0: torch.Tensor, lens: torch.Tensor,
                      num_steps: int, rate: int, num_docs: int
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain K10a: (pos int32 (T, M), valid bool (T, M)); step t marks the
    position after it while the range is whole, t % rate == 0 and
    t < len (colsplit_jax.py:59-81).  Dead lanes keep stepping."""
    M = p0.shape[0]
    pos = torch.empty((num_steps, M), dtype=torch.int32, device=p0.device)
    valid = torch.empty((num_steps, M), dtype=torch.bool, device=p0.device)
    p = p0
    alive = torch.ones(M, dtype=torch.bool, device=p0.device)
    for t in range(num_steps):
        i_lo = torch.searchsorted(fd["idx"], p, right=True)
        i_hi = torch.searchsorted(fd["idx"], p + num_docs - 1, right=True)
        alive = alive & (i_lo == i_hi)
        p = fl_unit_ref(fd, p)
        pos[t] = p
        valid[t] = alive & (t % rate == 0) & (t < lens)
    return pos, valid


def all_walk_ref(fd: dict, p0: torch.Tensor, lens: torch.Tensor,
                 num_steps: int, rate: int, num_docs: int
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain K10b: (pos, height int32 (T, M, N), valid bool (T, M, N)),
    valid at fragment-head walkers of active MUMs on marking steps
    (colsplit_jax.py:84-124)."""
    M = p0.shape[0]
    N = num_docs
    dev = p0.device
    d = torch.arange(N, dtype=torch.int32, device=dev)
    p = p0[:, None] + d[None, :]
    sep = torch.zeros((M, N), dtype=torch.bool, device=dev)
    pos = torch.empty((num_steps, M, N), dtype=torch.int32, device=dev)
    height = torch.empty_like(pos)
    valid = torch.empty((num_steps, M, N), dtype=torch.bool, device=dev)
    for t in range(num_steps):
        active = (t < lens)[:, None]
        flat = p.reshape(-1)
        i = torch.searchsorted(fd["idx"], flat, right=True).to(torch.int32) - 1
        run_start = _take(fd["idx"], i)
        is_head = (flat == run_start).reshape(M, N)
        sep = sep | (is_head & active & (d[None, :] > 0))
        p_next = (_take(fd["idx"], _take(fd["dest_interval"], i))
                  + _take(fd["dest_offset"], i)
                  + (flat - run_start)).reshape(M, N)
        p = torch.where(active, p_next, p)
        # a head's height is the distance to the next head above it
        first = sep | (d[None, :] == 0)
        head_or_n = torch.where(first, d[None, :], N)
        rev_cummin = torch.cummin(head_or_n.flip(1), dim=1).values.flip(1)
        next_head = torch.cat([rev_cummin[:, 1:],
                               head_or_n.new_full((M, 1), N)], dim=1)
        pos[t] = p
        height[t] = next_head - d[None, :]
        valid[t] = first & active & (t % rate == 0)
    return pos, height, valid


def _check_walk_args(fd: dict, p0: torch.Tensor, lens: torch.Tensor):
    dev = p0.device
    for f in FL_FIELDS:
        K.require(fd[f], f, torch.int32, dev)
    K.require(p0, "p0", torch.int32, dev)
    K.require(lens, "lens", torch.int32, dev)
    if p0.dim() != 1 or lens.shape != p0.shape:
        raise ValueError("p0 and lens must be 1-D of one length")
    r = fd["idx"].shape[0]
    if r < 1 or fd["dest_interval"].shape != (r,) \
            or fd["dest_offset"].shape != (r,):
        raise ValueError("the FL arrays must be 1-D of one length >= 1")
    return dev, r


def _check_rows(fd: dict, dev, r: int) -> None:
    K.require(fd["rows"], "rows", torch.int32, dev)
    K.require_aligned(fd["rows"], "rows", 16)
    if fd["rows"].shape != (r, 4):
        raise ValueError(f"rows must have shape ({r}, 4)")


def tunneled_walk(fd: dict, p0: torch.Tensor, lens: torch.Tensor,
                  num_steps: int, rate: int, num_docs: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """K10a (replaces colbwt_tpu/ops/colsplit_jax.py:59 _tunneled_walk):
    outputs as `tunneled_walk_ref`, walked over fd["rows"] (`fl_tensors`
    builds them).  CPU tensors take the plain version; CUDA tensors launch
    the kernel."""
    if p0.device.type == "cpu":
        return tunneled_walk_ref(fd, p0, lens, num_steps, rate, num_docs)
    dev, r = _check_walk_args(fd, p0, lens)
    _check_rows(fd, dev, r)
    M = p0.shape[0]
    pos = torch.empty((num_steps, M), dtype=torch.int32, device=dev)
    valid = torch.empty((num_steps, M), dtype=torch.bool, device=dev)
    if M and num_steps:
        code = K.on(dev).colbwt_tunneled_walk(
            fd["idx"].data_ptr(), fd["rows"].data_ptr(), r, p0.data_ptr(),
            lens.data_ptr(), M, int(num_steps), int(rate), int(num_docs),
            pos.data_ptr(), valid.data_ptr(), K.stream_handle(dev))
        K.check("tunneled_walk", code)
        K.launches["tunneled_walk"] += 1
    return pos, valid


def all_walk(fd: dict, p0: torch.Tensor, lens: torch.Tensor,
             num_steps: int, rate: int, num_docs: int
             ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K10b (replaces colbwt_tpu/ops/colsplit_jax.py:84 _all_walk): outputs
    as `all_walk_ref`, for num_docs <= 64, walked over fd["rows"] as K10a
    walks them.  CPU tensors take the plain version; CUDA tensors launch
    the kernel."""
    if p0.device.type == "cpu":
        return all_walk_ref(fd, p0, lens, num_steps, rate, num_docs)
    dev, r = _check_walk_args(fd, p0, lens)
    _check_rows(fd, dev, r)
    if not 1 <= num_docs <= 64:
        raise ValueError(f"all_walk takes 1 <= num_docs <= 64, got "
                         f"{num_docs} (col_split walks more on the host)")
    M = p0.shape[0]
    shape = (num_steps, M, num_docs)
    pos = torch.empty(shape, dtype=torch.int32, device=dev)
    height = torch.empty(shape, dtype=torch.int32, device=dev)
    valid = torch.empty(shape, dtype=torch.bool, device=dev)
    if M and num_steps:
        code = K.on(dev).colbwt_all_walk(
            fd["idx"].data_ptr(), fd["rows"].data_ptr(), r, p0.data_ptr(),
            lens.data_ptr(), M, int(num_steps), int(rate), int(num_docs),
            pos.data_ptr(), height.data_ptr(), valid.data_ptr(),
            K.stream_handle(dev))
        K.check("all_walk", code)
        K.launches["all_walk"] += 1
    return pos, height, valid


def _bin_id(ids: np.ndarray, id_bits: int) -> np.ndarray:
    id_max = 1 << id_bits
    ids = np.asarray(ids, dtype=np.int64)
    return np.where(ids >= id_max, (ids % (id_max - 1)) + 1, ids)


def _empty3() -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    z = np.empty(0, dtype=np.int64)
    return z, z.copy(), z.copy()


def _merge_marks(pos, ids, heights, visit, id_bits: int, tunneled: bool):
    """One mark per position from the walk's marks (lists of arrays):
    in tunnels mode the last in visit order wins, in all mode the first in
    visit order among the maximal heights."""
    if sum(x.size for x in pos) == 0:
        return _empty3()
    pos = np.concatenate(pos)
    ids = _bin_id(np.concatenate(ids), id_bits)
    heights = np.concatenate(heights)
    visit = np.concatenate(visit)
    if tunneled:
        o = np.lexsort((visit, pos))
        keep = np.r_[pos[o][1:] != pos[o][:-1], True]
    else:
        o = np.lexsort((visit, -heights, pos))
        keep = np.r_[True, pos[o][1:] != pos[o][:-1]]
    o = o[keep]
    return pos[o], ids[o], heights[o]


def buckets(len_sorted: np.ndarray, by_len: np.ndarray, tunneled: bool,
            num_docs: int, step_budget: int) -> Iterator[np.ndarray]:
    """MUM buckets in ascending length whose walk area (steps x MUMs, x N in
    all mode) stays within step_budget (colsplit_jax.py:334-347); each is a
    slice of `by_len`."""
    M = by_len.size
    start = 0
    while start < M:
        end = start + 1
        while end < M:
            area = int(len_sorted[by_len[end]]) * (end + 1 - start)
            if not tunneled:
                area *= num_docs
            if area > step_budget:
                break
            end += 1
        yield by_len[start:end]
        start = end


def col_split(fl: FLTableArrays, mum_lens: np.ndarray, mum_pos: np.ndarray,
              num_docs: int, split_rate: int = 10, mode: str = "tunnels",
              id_bits: int = 8, step_budget: int = 1 << 24, device=None
              ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Col-split on `device` (default cuda); the outputs of
    oracle.col_split_oracle and colsplit_jax.col_split_jax: (mark positions
    sorted, binned mark ids, mark heights), int64.  All mode with more than
    64 documents walks on the host (col_split_all_numpy), as in JAX."""
    dev = resolve_device(device)
    order = np.argsort(np.asarray(mum_pos), kind="stable")
    pos_sorted = np.asarray(mum_pos, dtype=np.int64)[order]
    len_sorted = np.asarray(mum_lens, dtype=np.int64)[order]
    c_ids = np.arange(1, order.size + 1, dtype=np.int64)
    if order.size == 0:
        return _empty3()
    tunneled = mode in ("tunnels", "tunneled")
    if not tunneled and num_docs > 64:
        return col_split_all_numpy(fl, mum_lens, mum_pos, num_docs,
                                   split_rate, id_bits)
    fd = fl_tensors(fl, dev)

    by_len = np.argsort(len_sorted, kind="stable")
    g_t = int(len_sorted.max()) + 1  # visit-key stride across buckets
    all_pos: list[np.ndarray] = []
    all_ids: list[np.ndarray] = []
    all_heights: list[np.ndarray] = []
    all_visit: list[np.ndarray] = []
    for sel in buckets(len_sorted, by_len, tunneled, num_docs, step_budget):
        T = int(len_sorted[sel].max())
        p0 = torch.from_numpy(pos_sorted[sel].astype(np.int32)).to(dev)
        lens = torch.from_numpy(len_sorted[sel].astype(np.int32)).to(dev)
        if tunneled:
            pos_t, valid_t = tunneled_walk(fd, p0, lens, T, split_rate,
                                           num_docs)
            hit = torch.nonzero(valid_t, as_tuple=True)
            t_idx, m_idx = (x.cpu().numpy() for x in hit)
            all_pos.append(pos_t[hit].cpu().numpy().astype(np.int64))
            all_ids.append(c_ids[sel][m_idx])
            all_heights.append(np.full(t_idx.size, num_docs, dtype=np.int64))
            # visit key: (c_id, t) lexicographic, comparable across buckets
            all_visit.append(c_ids[sel][m_idx] * g_t + t_idx)
        else:
            pos_t, h_t, valid_t = all_walk(fd, p0, lens, T, split_rate,
                                           num_docs)
            hit = torch.nonzero(valid_t, as_tuple=True)
            t_idx, m_idx, d_idx = (x.cpu().numpy() for x in hit)
            all_pos.append(pos_t[hit].cpu().numpy().astype(np.int64))
            all_ids.append(c_ids[sel][m_idx])
            all_heights.append(h_t[hit].cpu().numpy().astype(np.int64))
            all_visit.append((c_ids[sel][m_idx] * g_t + t_idx)
                             * (num_docs + 1) + d_idx)

    return _merge_marks(all_pos, all_ids, all_heights, all_visit, id_bits,
                        tunneled)


def col_split_tunneled_numpy(fl: FLTableArrays, mum_lens: np.ndarray,
                             mum_pos: np.ndarray, num_docs: int,
                             split_rate: int = 10, id_bits: int = 8
                             ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host int64 tunneled walk, the wide-n (n >= 2**31) lane: the outputs
    of `col_split(mode="tunnels")`.

    All MUM walkers advance one FL step per iteration, a walker dies when
    its N-high range fragments (a run boundary inside [p, p+N), detected as
    p+N-1 reaching past the next run start), and positions are marked every
    split_rate steps while alive (include/col_split.hpp:70-99).  Where two
    marks land on one position, the last in visit order (MUM position
    order, then step) wins.
    """
    M = int(np.asarray(mum_pos).size)
    if M == 0:
        return _empty3()
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

    out_h = [np.full(x.size, N, dtype=np.int64) for x in out_pos]
    return _merge_marks(out_pos, out_id, out_h, out_visit, id_bits, True)


def col_split_all_numpy(fl: FLTableArrays, mum_lens: np.ndarray,
                        mum_pos: np.ndarray, num_docs: int,
                        split_rate: int = 10, id_bits: int = 8
                        ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """All-mode col-split as a fragment-event walk on the host: the outputs
    of `col_split(mode="all")` at any N and any n, O(live fragments) a
    step instead of N walkers a MUM.

    A MUM's N-high range stays a set of contiguous fragments: a fragment
    [p, p+h) walks FL intact while no run starts fall in (p, p+h), and
    splits into sub-fragments at exactly those boundaries (splits are
    permanent, include/col_split.hpp:54-136).  Each fragment carries its
    offset d0 inside the original range, so the visit keys (mum, step,
    walker) and the first-among-maximal-height merge match the walkers'.
    """
    M = int(np.asarray(mum_pos).size)
    if M == 0:
        return _empty3()
    N = num_docs
    idx = np.asarray(fl.idx, dtype=np.int64)
    dest_pos = (idx[np.asarray(fl.dest_interval, dtype=np.int64)]
                + np.asarray(fl.dest_offset, dtype=np.int64))

    order = np.argsort(np.asarray(mum_pos), kind="stable")
    pos = np.asarray(mum_pos, dtype=np.int64)[order].copy()
    lens = np.asarray(mum_lens, dtype=np.int64)[order]
    cid = np.arange(1, M + 1, dtype=np.int64)
    g_t = int(lens.max()) + 1

    h = np.full(M, N, dtype=np.int64)
    d0 = np.zeros(M, dtype=np.int64)
    T = int(lens.max())

    out_pos: list[np.ndarray] = []
    out_id: list[np.ndarray] = []
    out_h: list[np.ndarray] = []
    out_visit: list[np.ndarray] = []
    for t in range(T):
        act = t < lens
        if not act.all():
            pos, h, d0, cid, lens = (pos[act], h[act], d0[act], cid[act],
                                     lens[act])
        if pos.size == 0:
            break
        # split phase: boundaries strictly inside (p, p+h) become new heads
        first_in = np.searchsorted(idx, pos, side="right")
        cnt = np.searchsorted(idx, pos + h, side="left") - first_in
        if cnt.max(initial=0) > 0:
            pieces = cnt + 1
            rep = np.repeat(np.arange(pos.size), pieces)
            jj = (np.arange(rep.size, dtype=np.int64)
                  - np.repeat(np.cumsum(pieces) - pieces, pieces))
            b_idx = first_in[rep] + jj - 1
            st = np.where(jj == 0, pos[rep], idx[np.maximum(b_idx, 0)])
            is_last = jj == cnt[rep]
            en = np.where(is_last, pos[rep] + h[rep],
                          idx[np.minimum(first_in[rep] + jj, idx.size - 1)])
            d0 = d0[rep] + (st - pos[rep])
            pos, h, cid, lens = st, en - st, cid[rep], lens[rep]
        # step phase: every fragment sits inside one run now
        i = np.searchsorted(idx, pos, side="right") - 1
        pos = dest_pos[i] + (pos - idx[i])
        if t % split_rate == 0:
            out_pos.append(pos.copy())
            out_id.append(cid.copy())
            out_h.append(h.copy())
            out_visit.append((cid * g_t + t) * (N + 1) + d0)

    return _merge_marks(out_pos, out_id, out_h, out_visit, id_bits, False)
