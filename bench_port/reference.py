"""The plain reference: per-base PML and CID of every read, worked out from
the collection itself in plain PyTorch (on the card when there is one) and
NumPy.

It imports nothing of the program and takes nothing the program made: it
derives the suffix array, LCP, BWT, thresholds, multi-MUMs, the col-split
marks and the col runs again from the documents.  The algorithms follow the
host specification the port carries (colbwt_tpu_torch/ops/oracle.py), written
here again in another form so that a fault of the program's path is not
shared by its judge:

- the suffix array by prefix doubling with `torch.sort`, the LCP by binary
  lifting over the doubling's rank arrays (the specification: prefix
  doubling with lexsort, then Kasai);
- thresholds by a scatter-min over (lcp, position) keys;
- multi-MUMs by sliding-window minima and maxima over the whole SA at once
  (the specification: one window at a time);
- the tunneled col-split walk with every MUM's block stepped together;
- `find_col_runs`, the event loop of the specification, frozen as it is
  (ops/oracle.py `find_col_runs_oracle`), with the run heads emitted in
  slices;
- the query in rank coordinates: a read's state is its rank position; a
  mismatch moves it to the previous or next occurrence of the character in
  the BWT by the successor run's threshold, and LF is the stable order of
  the BWT (the specification walks the run-length move table).

`split_rate`, `mode` and `id_bits` are the configuration's.  The control
(bench_port/control.py) calls the same code with one of them changed.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass

import numpy as np
import torch

TERMINATOR = 1
ACGT = b"ACGT"


@dataclass
class Reference:
    """What the query needs, every array on `device`."""

    n: int
    bwt: torch.Tensor          # uint8 (n,), separators as TERMINATOR
    lf: torch.Tensor           # int64 (n,): LF of each rank position
    occ: dict                  # char -> int64 sorted positions in the BWT
    run_starts: torch.Tensor   # int64 (r,): BWT run starts
    thr: torch.Tensor          # int64 (r,): threshold of each BWT run
    split_pos: torch.Tensor    # int64: col-run bit positions
    split_ids: torch.Tensor    # int64: their ids
    counts: dict               # n, bwt_r, mums, marks, col_runs


def concat_collection(docs: list[np.ndarray]):
    """(text uint8, sort ranks int64, doc ids int32) of the documents, each
    followed by a separator stored as TERMINATOR that sorts as the distinct
    symbol 1 + k below every byte b (rank N + b)."""
    N = len(docs)
    sizes = np.array([d.size + 1 for d in docs], dtype=np.int64)
    ends = np.cumsum(sizes)
    n = int(ends[-1])
    text = np.empty(n, dtype=np.uint8)
    body = np.ones(n, dtype=bool)
    body[ends - 1] = False
    text[body] = np.concatenate(docs)
    text[~body] = TERMINATOR
    if text[body].size and text[body].min() <= TERMINATOR:
        raise ValueError("document bytes must be > 1")
    ranks = text.astype(np.int64) + N
    ranks[ends - 1] = 1 + np.arange(N, dtype=np.int64)
    doc_ids = np.repeat(np.arange(N, dtype=np.int32), sizes)
    return text, ranks, doc_ids


def suffix_array(ranks: torch.Tensor) -> tuple[torch.Tensor, list]:
    """(SA, levels): prefix doubling by sorting packed (rank, next rank)
    keys; levels[j] ranks the suffixes by their first 2**j symbols (past the
    end sorts lowest), the last level has every rank distinct."""
    n = ranks.numel()
    dev = ranks.device
    _, rank = torch.unique(ranks, return_inverse=True)
    rank = rank.to(torch.int64)
    levels = [rank.to(torch.int32)]
    k = 1
    while int(rank.max()) < n - 1:
        nxt = torch.full_like(rank, -1)
        nxt[:n - k] = rank[k:]
        key, order = torch.sort(rank * (n + 1) + (nxt + 1))
        changed = torch.ones(n, dtype=torch.int64, device=dev)
        changed[1:] = (key[1:] != key[:-1]).to(torch.int64)
        rank = torch.empty_like(rank)
        rank[order] = torch.cumsum(changed, 0) - 1
        levels.append(rank.to(torch.int32))
        k *= 2
    sa = torch.empty(n, dtype=torch.int64, device=dev)
    sa[rank] = torch.arange(n, dtype=torch.int64, device=dev)
    return sa, levels


def lcp_from_levels(sa: torch.Tensor, levels: list) -> torch.Tensor:
    """lcp[i] = LCP(suffix sa[i-1], suffix sa[i]), lcp[0] = 0, by lifting
    through the levels from the longest prefixes down."""
    n = sa.numel()
    a, b = sa[:-1], sa[1:]
    ell = torch.zeros(n - 1, dtype=torch.int64, device=sa.device)
    for j in range(len(levels) - 1, -1, -1):
        lvl = levels[j]
        pa, pb = a + ell, b + ell
        inside = (pa < n) & (pb < n)
        same = inside & (lvl[pa.clamp(max=n - 1)] == lvl[pb.clamp(max=n - 1)])
        ell += same.to(torch.int64) << j
    return torch.cat([torch.zeros(1, dtype=torch.int64, device=sa.device),
                      ell])


def rle(bwt: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(heads, run starts, run lengths) of the BWT."""
    n = bwt.numel()
    change = torch.ones(n, dtype=torch.bool, device=bwt.device)
    change[1:] = bwt[1:] != bwt[:-1]
    starts = torch.nonzero(change).flatten()
    lens = torch.diff(starts, append=torch.tensor([n], device=bwt.device))
    return bwt[starts], starts, lens


def thresholds(heads, starts, lens, lcp) -> torch.Tensor:
    """One threshold a BWT run: for a run of char c, the first position of
    the least LCP in (end of the previous c-run, start of the run]; 0 for
    the first c-run."""
    n = lcp.numel()
    dev = lcp.device
    thr = torch.zeros(heads.numel(), dtype=torch.int64, device=dev)
    bits = max(int(n - 1).bit_length(), 1)
    pos = torch.arange(n, dtype=torch.int64, device=dev)
    key = (lcp << bits) | pos
    for c in torch.unique(heads).tolist():
        runs = torch.nonzero(heads == c).flatten()
        if runs.numel() < 2:
            continue
        lo = starts[runs[:-1]] + lens[runs[:-1]]
        hi = starts[runs[1:]]
        seg = torch.searchsorted(hi, pos)
        inside = seg < hi.numel()
        inside &= lo[seg.clamp(max=hi.numel() - 1)] <= pos
        best = torch.full((hi.numel(),), torch.iinfo(torch.int64).max,
                          dtype=torch.int64, device=dev)
        best.scatter_reduce_(0, seg[inside], key[inside], "amin")
        thr[runs[1:]] = best & ((1 << bits) - 1)
    return thr


def sliding(x: torch.Tensor, w: int, op: str) -> torch.Tensor:
    """out[i] = min (op "min") or max (op "max") of x[i:i+w], for
    i in [0, len(x) - w], by prefix and suffix scans over blocks of w."""
    m = x.numel()
    if w == 1:
        return x.clone()
    pad = (-m) % w
    fill = (torch.iinfo(x.dtype).max if op == "min"
            else torch.iinfo(x.dtype).min)
    xp = torch.cat([x, torch.full((pad,), fill, dtype=x.dtype,
                                  device=x.device)]).view(-1, w)
    scan = torch.cummin if op == "min" else torch.cummax
    pre = scan(xp, dim=1).values.flatten()
    suf = scan(xp.flip(1), dim=1).values.flip(1).flatten()
    i = torch.arange(m - w + 1, device=x.device)
    pick = torch.minimum if op == "min" else torch.maximum
    return pick(suf[i], pre[i + w - 1])


def multi_mums(ranks, sa, lcp, doc_ids, N: int, min_mum: int):
    """(lengths, rank positions) of the multi-MUMs, ascending by position:
    windows [i, i+N) of the SA whose shared prefix ell = min lcp[i+1..i+N-1]
    is at least min_mum and longer than lcp[i] and lcp[i+N], that hold one
    suffix of every document, and whose left characters are not all
    equal."""
    n = sa.numel()
    dev = sa.device
    z = torch.empty(0, dtype=torch.int64, device=dev)
    if N < 2 or n < N:
        return z, z
    W = n - N + 1
    ell = sliding(lcp[1:], N - 1, "min")[:W]
    lcp_ext = torch.cat([lcp, torch.zeros(1, dtype=lcp.dtype, device=dev)])
    ok = (ell >= min_mum) & (lcp_ext[:W] < ell) & (lcp_ext[N:N + W] < ell)
    # one suffix a document: no position's previous same-document position
    # lies inside the window
    docs = doc_ids[sa].to(torch.int64)
    order = torch.sort(docs * n + torch.arange(n, device=dev)).indices
    prev = torch.full((n,), -1, dtype=torch.int64, device=dev)
    same = docs[order[1:]] == docs[order[:-1]]
    prev[order[1:][same]] = order[:-1][same]
    ok &= sliding(prev, N, "max")[:W] < torch.arange(W, device=dev)
    # left-maximal: some left character differs inside the window
    left = ranks[(sa - 1) % n]
    change = torch.zeros(n, dtype=torch.int64, device=dev)
    change[1:] = (left[1:] != left[:-1]).to(torch.int64)
    csum = torch.cumsum(change, 0)
    i = torch.arange(W, device=dev)
    ok &= (csum[i + N - 1] - csum[i]) > 0
    pos = torch.nonzero(ok).flatten()
    return ell[pos], pos


def col_split_tunneled(heads, lens, mum_lens, mum_pos, N: int,
                       split_rate: int, id_bits: int):
    """(mark positions, ids) of the tunneled col-split walk: each MUM's
    block of N rank positions steps forward (FL) while it lies inside one
    F-run, and every split_rate-th block, from the first step on, is marked
    with the MUM's 1-based rank order as its id, binned into
    [1, 2**id_bits - 1]; a later MUM's mark replaces an earlier one at the
    same position.  Every mark is N high."""
    dev = heads.device
    f_order = torch.sort(heads.to(torch.int64), stable=True).indices
    f_len = lens[f_order]
    f_idx = torch.cumsum(f_len, 0) - f_len
    f_end = f_idx + f_len
    l_start = (torch.cumsum(lens, 0) - lens)[f_order]

    def frun(p):
        return torch.searchsorted(f_idx, p, right=True) - 1

    def fl(p, j):
        return l_start[j] + (p - f_idx[j])

    M = mum_pos.numel()
    cid = torch.arange(1, M + 1, dtype=torch.int64, device=dev)
    p = mum_pos.clone()
    j = frun(p)
    alive = p + N <= f_end[j]
    p = torch.where(alive, fl(p, j), p)
    steps = int(mum_lens.max()) if M else 0
    got_p, got_id = [], []
    for t in range(steps):
        act = alive & (t < mum_lens)
        if t % split_rate == 0:
            got_p.append(p[act])
            got_id.append(cid[act])
        j = frun(p)
        alive = act & (p + N <= f_end[j])
        p = torch.where(alive, fl(p, j), p)
        if t % 64 == 63:  # drop the walkers that are done
            keep = torch.nonzero(alive).flatten()
            p, alive, cid, mum_lens = (p[keep], alive[keep], cid[keep],
                                       mum_lens[keep])
    if not got_p:
        z = torch.empty(0, dtype=torch.int64, device=dev)
        return z, z
    pos = torch.cat(got_p)
    ids = torch.cat(got_id)
    # last writer wins: the largest id at each position
    order = torch.sort(pos * (M + 1) + ids).indices
    pos, ids = pos[order], ids[order]
    last = torch.ones(pos.numel(), dtype=torch.bool, device=dev)
    last[:-1] = pos[1:] != pos[:-1]
    pos, ids = pos[last], ids[last]
    id_max = 1 << id_bits
    ids = torch.where(ids >= id_max, ids % (id_max - 1) + 1, ids)
    return pos, ids


def find_col_runs(mark_pos: np.ndarray, mark_ids: np.ndarray, height: int,
                  l_heads: np.ndarray, n: int
                  ) -> tuple[np.ndarray, np.ndarray]:
    """The col runs' (bit positions, ids): the event loop of the
    specification (ops/oracle.py `find_col_runs_oracle`, col_split's
    find_col_runs), frozen, every mark `height` high; the run heads between
    two events are emitted as one slice, in the loop's order."""
    if mark_pos.size == 0:
        return np.empty(0, dtype=np.int64), np.empty(0, dtype=np.int64)
    parts: list = []  # (positions, id) in the order the loop sets them
    heap: list = []
    cursor = 0
    last_id = 0

    def set_bit(pos: int, ident: int) -> None:
        parts.append((np.array([pos], dtype=np.int64), ident))

    def update_bwt_pos(idx: int, ident: int) -> None:
        nonlocal cursor, last_id
        k = int(np.searchsorted(l_heads, idx, side="left"))
        if k > cursor:
            parts.append((l_heads[cursor:k], last_id))
            cursor = k
        if cursor < l_heads.size and l_heads[cursor] == idx:
            cursor += 1
        last_id = ident

    def update_col_ranges(idx: int) -> None:
        while heap and heap[0][0] <= idx:
            end, _start, _ident = heapq.heappop(heap)
            if len(heap) == 1 and heap[0][0] > end:
                keep_id = heap[0][2]
                update_bwt_pos(end, keep_id)
                set_bit(end, keep_id)
            elif not heap and end < idx:
                update_bwt_pos(end, 0)
                set_bit(end, 0)

    for p, ident in zip(mark_pos.tolist(), mark_ids.tolist()):
        update_col_ranges(p)
        heapq.heappush(heap, (p + height, p, ident))
        if len(heap) == 1 and ident > 0:
            update_bwt_pos(p, ident)
            set_bit(p, ident)
    update_col_ranges(n)
    update_bwt_pos(n, 0)
    bits = np.concatenate([b for b, _ in parts])
    ids = np.concatenate([np.full(b.size, i, dtype=np.int64)
                          for b, i in parts])
    order = np.argsort(bits, kind="stable")
    return bits[order], ids[order]


def build(docs: list[np.ndarray], min_mum: int, split_rate: int = 10,
          mode: str = "tunnels", id_bits: int = 8,
          device: torch.device | str = "cpu") -> Reference:
    """Everything the query needs, derived from the documents."""
    if mode != "tunnels":
        raise ValueError("the reference walks the tunneled col-split only")
    dev = torch.device(device)
    text_np, ranks_np, doc_np = concat_collection(docs)
    n = text_np.size
    text = torch.from_numpy(text_np).to(dev)
    ranks = torch.from_numpy(ranks_np).to(dev)
    sa, levels = suffix_array(ranks)
    lcp = lcp_from_levels(sa, levels)
    del levels
    bwt = text[(sa - 1) % n]
    heads, starts, lens = rle(bwt)
    thr = thresholds(heads, starts, lens, lcp)
    mlen, mpos = multi_mums(ranks, sa, lcp,
                            torch.from_numpy(doc_np).to(dev), len(docs),
                            min_mum)
    del sa, lcp, ranks
    mark_pos, mark_ids = col_split_tunneled(heads, lens, mlen, mpos,
                                            len(docs), split_rate, id_bits)
    bits, ids = find_col_runs(mark_pos.cpu().numpy(), mark_ids.cpu().numpy(),
                              len(docs), starts.cpu().numpy(), n)
    lf = torch.empty(n, dtype=torch.int64, device=dev)
    lf[torch.sort(bwt, stable=True).indices] = torch.arange(n, device=dev)
    occ = {c: torch.nonzero(bwt == c).flatten() for c in ACGT}
    counts = {"n": n, "bwt_r": int(heads.numel()), "mums": int(mpos.numel()),
              "marks": int(mark_pos.numel()),
              "col_runs": int(torch.unique(torch.cat([
                  starts, torch.from_numpy(bits).to(dev)])).numel())}
    return Reference(n=n, bwt=bwt, lf=lf, occ=occ, run_starts=starts,
                     thr=thr, split_pos=torch.from_numpy(bits).to(dev),
                     split_ids=torch.from_numpy(ids).to(dev), counts=counts)


def query(ref: Reference, reads: np.ndarray, lens: np.ndarray
          ) -> tuple[np.ndarray, np.ndarray]:
    """PML and CID (int64, (B, W)) of reads given as a left-aligned (B, W)
    uint8 matrix and their lengths; column j of a read holds its base j,
    the columns past its length 0."""
    dev = ref.bwt.device
    B, W = reads.shape
    R = torch.from_numpy(np.ascontiguousarray(reads)).to(dev)
    L = torch.from_numpy(lens.astype(np.int64)).to(dev)
    pos = torch.full((B,), ref.n - 1, dtype=torch.int64, device=dev)
    match_len = torch.zeros(B, dtype=torch.int64, device=dev)
    pml = torch.zeros((B, W), dtype=torch.int64, device=dev)
    cid = torch.zeros((B, W), dtype=torch.int64, device=dev)
    rows = torch.arange(B, device=dev)
    has_split = ref.split_pos.numel() > 0
    for s in range(int(L.max()) if B else 0):
        act = s < L
        col = (L - 1 - s).clamp(min=0)
        c = R[rows, col]
        if has_split:
            k = torch.searchsorted(ref.split_pos, pos, right=True) - 1
            here_id = torch.where(k >= 0, ref.split_ids[k.clamp(min=0)], 0)
        else:
            here_id = torch.zeros_like(pos)
        hit = ref.bwt[pos] == c
        match_len = torch.where(hit, match_len + 1, 0)
        new = pos
        for ch, occ in ref.occ.items():
            sel = ~hit & (c == ch)
            if occ.numel() == 0:
                continue
            k = torch.searchsorted(occ, pos, right=True)
            succ = occ[k.clamp(max=occ.numel() - 1)]
            has_succ = k < occ.numel()
            run = torch.searchsorted(ref.run_starts, succ, right=True) - 1
            thr = torch.where(has_succ, ref.thr[run], ref.n)
            pred = occ[(k - 1).clamp(min=0)]
            to = torch.where(has_succ, succ, pos)
            to = torch.where((pos < thr) & (k > 0), pred, to)
            new = torch.where(sel, to, new)
        pml[rows[act], col[act]] = match_len[act]
        cid[rows[act], col[act]] = here_id[act]
        pos = torch.where(act, ref.lf[new], pos)
        match_len = torch.where(act, match_len, 0)
    return pml.cpu().numpy(), (cid & 0xFF).cpu().numpy()


def records(docs: list[np.ndarray], build_cfg: dict, seqs: np.ndarray,
            lens: np.ndarray, device, block: int = 1 << 16,
            **override) -> tuple[np.ndarray, np.ndarray, dict]:
    """PML and CID of every read under the configuration's build flags
    (`build_cfg`: min_mum, split_rate, mode, id_bits), any of them replaced
    by `override`; the reads go through the query in blocks of rows."""
    b = {**build_cfg, **override}
    ref = build(docs, b["min_mum"], b["split_rate"], b["mode"], b["id_bits"],
                device=device)
    pml = np.empty(seqs.shape, dtype=np.int64)
    cid = np.empty(seqs.shape, dtype=np.int64)
    for a in range(0, lens.size, block):
        pml[a:a + block], cid[a:a + block] = query(ref, seqs[a:a + block],
                                                   lens[a:a + block])
    return pml, cid, ref.counts
