"""Device index construction — port of colbwt_tpu/ops/construct_jax.py:
the suffix array and LCP (the build's route without the native library),
the multi-MUM scan and the thresholds.

Suffix array, LCP and thresholds, kernels in csrc/suffix.cu:

- K11a `doubling_round` (replaces construct_jax.py:51 `_doubling_round`
  and :39 `_rerank`): one prefix-doubling round, sort by (rank, rank at
  i+k) and dense re-rank.  The kernel takes the order by (rank at i+k, i)
  from the previous round's order (`next_rank_order_ref` is that step in
  plain PyTorch) and radix-sorts it stably by the 32-bit rank alone; the
  plain version keeps JAX's two stable argsorts.  `suffix_array`
  (construct_jax.py:70) drives the rounds with JAX's early exit, one
  workspace for all of them, and keeps the per-round ranks (the pyramid)
  on the device.
- K11b `lcp_lift` (replaces construct_jax.py:106 `lcp_from_pyramid`):
  the LCP of SA neighbours by power-of-two probes through the pyramid,
  walked in text order (Kasai's) so each position starts from the bound
  its predecessor leaves; the plain version keeps JAX's descending lift.
- K12 `segmented_argmin` (replaces construct_jax.py:494
  `_segmented_argmin`): the first argmin of the LCP over each segment
  between two runs of one character, the work split by positions (a warp
  a run of tiles of _ARGMIN_TILE positions of the segments' span, packed
  64-bit (lcp, position) keys, a segment that crosses tiles finished by a
  second kernel through an `ArgminWorkspace`); `compute_thresholds`
  (construct_jax.py:505) drives it, one call (two launches) a character.

A multi-MUM of N documents is a height-N window [i, i+N) of the suffix
array whose suffixes come one from each document, share a prefix of length
ell = min lcp[i+1 .. i+N-1] >= min_mum that neither neighbour shares
(lcp[i] < ell, lcp[i+N] < ell), and are left-maximal (the preceding
characters are not all equal).  oracle.find_multi_mums is the definition.

One kernel carries both device forms, `mum_window` in csrc/construct.cu
(a block a tile of window starts staged in shared memory, ell by doubling
passes there, left-maximality by a prefix count, coverage tested lazily;
one launch), for N up to _TILE_MAX_N; above it the wrapper routes by shape
to the large-N route (`mum_window_route`), two launches whose work a
window start does not grow with N: the least lcp and any run change of
tiles of `span_tile(N)` positions into a scratch array, then a block a
span of _SPAN starts, each window's head and tail by segmented scans of
the span and the tiles between from the scratch; coverage only where the
other conditions hold (such windows are disjoint, at most C/N + 1 a
chunk), by a shared bitmap of the window's ids.  Both forms serve:

- K8 (replaces construct_jax.py:245 `_mum_scan_chunk`): the window test
  on one chunk of C positions with a 2N+2 halo; `find_multi_mums_chunked`
  streams fixed-size chunks from (possibly memmapped) host arrays, so
  device memory is O(C) at any n;
- K9 (replaces construct_jax.py:193 `multi_mum_scan`): the test over the
  whole array, padded as one chunk.  Its plain version keeps JAX's
  argsort-built next-same-doc array, so kernel = plain at K9's shape also
  checks the capped-distance rewrite.

`find_multi_mums` routes as `find_multi_mums_jax` does: the one-shot scan
below _CHUNKED_SCAN_MIN_N, the chunked one from there.  Each wrapper runs
its plain version only for tensors on the CPU; for a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from colbwt_tpu_torch.ops import _kernels as K
from colbwt_tpu_torch.ops.oracle import normalize_heads
from colbwt_tpu_torch.utils.device import resolve_device

# above this n, stream fixed-size chunks instead of the one-shot scan
# (construct_jax.py:463): O(C) device memory at any n
_CHUNKED_SCAN_MIN_N = 1 << 22
# csrc/construct.cu kMumTileMaxN: the largest N of mum_window's tile route
# (its coverage test is a 64-bit mask up to 64 documents, a probe that
# grows as N**2 past it; on the H100 the large-N route beat it from 96
# documents on and lost at 64, PERF.md); above it the large-N route
_TILE_MAX_N = 64
# csrc/construct.cu kSpan: the large-N route's window starts a block, and
# its largest tile
_SPAN = 2048
# csrc/suffix.cu kArgTile: positions a warp of segmented_argmin takes at a
# time (its workspace: a key a tile)
_ARGMIN_TILE = 512
# csrc/suffix.cu: positions a radix-sort tile holds, the digit width, the
# state's histogram (4 passes of 256 counts) and tile counters in bytes,
# pyramid levels a launch takes
_RADIX_TILE = 4096
_DIGIT_BITS = 8
_STATE_HEAD_BYTES = 4 * 256 * 4 + 16 * 4
_MAX_LEVELS = 32


def _shift_left(x: torch.Tensor, k: int, fill: int) -> torch.Tensor:
    """y[i] = x[i+k] with y[i >= n-k] = fill."""
    if k == 0:
        return x
    if k >= x.shape[0]:
        return torch.full_like(x, fill)
    return torch.cat([x[k:], x.new_full((k,), fill)])


def _int32_on(x, dev: torch.device) -> torch.Tensor:
    """An array or a tensor as an int32 tensor on `dev`."""
    if not torch.is_tensor(x):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(dev, torch.int32)


def _check_n(n: int) -> None:
    if n < 1 or n >= 2**31:
        raise ValueError(f"n = {n}: the int32 construction needs "
                         "1 <= n < 2**31")


# ---------------------------------------------------------------------------
# suffix array by prefix doubling (K11a), LCP by lifting (K11b)
# ---------------------------------------------------------------------------


def doubling_round_ref(rank: torch.Tensor, k: int
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain K11a, construct_jax.py:51-67: sort by (rank, next_rank) with
    next_rank[i] = rank[i+k] (-1 where i >= n-k) by two stable argsorts,
    then re-rank densely.  (order int32, new_rank int32, max rank as a
    0-d int32 tensor)."""
    next_rank = _shift_left(rank, k, -1)
    o1 = torch.sort(next_rank, stable=True).indices
    order = o1[torch.sort(rank[o1], stable=True).indices]
    hi_s, lo_s = rank[order], next_rank[order]
    changed = torch.ones(rank.shape[0], dtype=torch.int32, device=rank.device)
    changed[1:] = ((hi_s[1:] != hi_s[:-1])
                   | (lo_s[1:] != lo_s[:-1])).to(torch.int32)
    ranks_sorted = torch.cumsum(changed, 0, dtype=torch.int32) - 1
    new_rank = torch.empty_like(ranks_sorted)
    new_rank[order] = ranks_sorted
    return order.to(torch.int32), new_rank, ranks_sorted[-1]


def next_rank_order_ref(order: torch.Tensor, k: int) -> torch.Tensor:
    """The order by (next_rank[i], i), next_rank[i] = rank[i+k] (-1 where
    i >= n-k), from `order`, the stable argsort of rank (the previous
    round's order): the positions max(n-k, 0) .. n-1 in index order, then
    order[j] - k for each j with order[j] >= k, in order.  K11a's first
    radix pass reads this sequence straight from `order`.  int32."""
    n = order.shape[0]
    head = torch.arange(max(n - k, 0), n, dtype=torch.int32,
                        device=order.device)
    return torch.cat([head, (order[order >= k] - k).to(torch.int32)])


def key_passes(max_rank: int) -> int:
    """K11a's 8-bit radix passes for ranks up to `max_rank`."""
    return max(1, -(-int(max_rank).bit_length() // _DIGIT_BITS))


def round_launches(passes: int, with_order: bool) -> int:
    """Launches a K11a round makes: a memset, the histogram, a scatter a
    pass (twice without a given order: the argsort first) and the
    re-rank."""
    return 3 + passes * (1 if with_order else 2)


class DoublingWorkspace:
    """K11a's scratch for n positions, made once per `suffix_array` and
    reused by every round: two key and two value arrays of n, and the state
    (histogram, tile counters, look-back words; zeroed once, since every
    pass tags its words with its own epoch)."""

    def __init__(self, n: int, device: torch.device):
        self.n = n
        self.keys = torch.empty(2, n, dtype=torch.int32, device=device)
        self.vals = torch.empty(2, n, dtype=torch.int32, device=device)
        # csrc/suffix.cu doubling_state_bytes
        self.state = torch.zeros(
            _STATE_HEAD_BYTES + -(-2 * n // _RADIX_TILE) * 256 * 8,
            dtype=torch.uint8, device=device)
        self.epoch = 1  # each sort pass and re-rank takes the next one


def doubling_round(rank: torch.Tensor, k: int, max_rank: int,
                   order: torch.Tensor | None = None,
                   workspace: DoublingWorkspace | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K11a: one prefix-doubling round, outputs as `doubling_round_ref`.
    CPU tensors take the plain version.  CUDA tensors launch
    `doubling_round`, which radix-sorts keys of bit_length(max_rank) bits:
    `max_rank` must be the largest value of `rank` (the previous round's,
    which `suffix_array` reads back anyway) and `order`, when given, its
    stable argsort (the previous round's order); without it the kernel
    sorts 0 .. n-1 by rank first.  `workspace` (made here when absent) is
    reused across rounds."""
    if rank.device.type == "cpu":
        return doubling_round_ref(rank, k)
    dev = rank.device
    K.require(rank, "rank", torch.int32, dev)
    n = rank.shape[0]
    _check_n(n)
    if max_rank < 0 or max_rank >= 2**31:
        raise ValueError(f"max_rank = {max_rank}: ranks must be int32 >= 0")
    if order is not None:
        K.require(order, "order", torch.int32, dev)
        if order.shape != (n,):
            raise ValueError(f"order has shape {tuple(order.shape)}, "
                             f"expected ({n},)")
    ws = workspace or DoublingWorkspace(n, dev)
    if ws.n != n or ws.state.device != dev:
        raise ValueError(f"workspace is for n = {ws.n} on {ws.state.device}")
    passes = key_passes(max_rank)
    epoch = ws.epoch
    ws.epoch += passes * (1 if order is not None else 2) + 1
    out = torch.empty(n, dtype=torch.int32, device=dev)
    new_rank = torch.empty(n, dtype=torch.int32, device=dev)
    top = torch.empty((), dtype=torch.int32, device=dev)
    code = K.on(dev).colbwt_doubling_round(
        rank.data_ptr(), n, int(k), passes,
        None if order is None else order.data_ptr(),
        ws.keys[0].data_ptr(), ws.keys[1].data_ptr(), ws.vals[0].data_ptr(),
        ws.vals[1].data_ptr(), ws.state.data_ptr(), ws.state.numel(), epoch,
        out.data_ptr(), new_rank.data_ptr(), top.data_ptr(),
        K.stream_handle(dev))
    K.check("doubling_round", code)
    K.launches["doubling_round"] += 1
    return out, new_rank, top


def suffix_array(ranks0: np.ndarray, with_pyramid: bool = False,
                 device=None):
    """Prefix-doubling suffix array on `device` (default cuda), the rounds
    of construct_jax.py:70 suffix_array_jax: ceil(log2(max(n, 2))) rounds
    at most, k doubling, stopping once the largest rank is n - 1 (read back
    once a round).  Each round after the first hands K11a the previous
    round's order, and all share one workspace.  Returns int32 tensors
    (sa, rank[, pyramid]); pyramid[j] ranks the substrings of length
    2**(j+1) and stays on the device."""
    dev = resolve_device(device)
    r0 = np.asarray(ranks0)
    n = int(r0.size)
    _check_n(n)
    num_rounds = max(1, math.ceil(math.log2(max(n, 2))))
    rank = torch.from_numpy(r0.astype(np.int32)).to(dev)
    max_rank = int(r0.max())
    ws = DoublingWorkspace(n, dev) if dev.type == "cuda" else None
    pyramid = []
    sa = None
    k = 1
    for _ in range(num_rounds):
        sa, rank, top = doubling_round(rank, k, max_rank, sa, ws)
        if with_pyramid:
            pyramid.append(rank)
        k *= 2
        max_rank = int(top)
        if max_rank == n - 1:
            break
    if with_pyramid:
        return sa, rank, pyramid
    return sa, rank


def lcp_from_pyramid_ref(ranks0: torch.Tensor, sa: torch.Tensor,
                         pyramid: list[torch.Tensor]) -> torch.Tensor:
    """Plain K11b, construct_jax.py:106-134: lcp[i] = LCE(sa[i-1], sa[i])
    by probes of widths 2**R ... 2 (pyramid[R-1] ... pyramid[0]) and 1
    (ranks0); out-of-range probes read -1 for a and -2 for b.  int32."""
    n = sa.shape[0]
    a = sa[:-1].to(torch.int64)
    b = sa[1:].to(torch.int64)
    h = torch.zeros_like(a)

    def probe(level, width):
        pa, pb = a + h, b + h
        ra = torch.where(pa < n, level[pa.clamp(max=n - 1)], -1)
        rb = torch.where(pb < n, level[pb.clamp(max=n - 1)], -2)
        return h + torch.where(ra == rb, width, 0)

    for j in range(len(pyramid) - 1, -1, -1):
        h = probe(pyramid[j], 1 << (j + 1))
    h = probe(ranks0, 1)
    lcp = torch.zeros(n, dtype=torch.int32, device=sa.device)
    lcp[1:] = h.to(torch.int32)
    return lcp


def lcp_from_pyramid(ranks0, sa: torch.Tensor, pyramid: list[torch.Tensor]
                     ) -> torch.Tensor:
    """K11b (replaces construct_jax.py:106 lcp_from_pyramid and :137
    lcp_jax): the int32 LCP array from `suffix_array`'s sa and pyramid (or
    its first levels: the values are capped at 2**(len(pyramid)+1) - 1);
    `ranks0` (an array or a tensor) goes to sa's device as int32.  CPU
    tensors take the plain version; CUDA tensors launch `lcp_lift`, which
    walks the text in Kasai's order and so needs sa to be the suffix order
    of the text that ranks0 and the pyramid rank."""
    dev = sa.device
    r0 = _int32_on(ranks0, dev)
    if dev.type == "cpu":
        return lcp_from_pyramid_ref(r0, sa, pyramid)
    n = sa.shape[0]
    _check_n(n)
    if len(pyramid) > _MAX_LEVELS:
        raise ValueError(f"{len(pyramid)} pyramid levels; the kernel takes "
                         f"at most {_MAX_LEVELS}")
    named = [("sa", sa), ("ranks0", r0),
             *((f"pyramid[{j}]", p) for j, p in enumerate(pyramid))]
    for name, t in named:
        K.require(t, name, torch.int32, dev)
        if t.shape != (n,):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected ({n},)")
    levels = (ctypes.c_void_p * len(pyramid))(*(p.data_ptr()
                                                for p in pyramid))
    # the entry point takes the top level as the inverse suffix array when
    # it is one (it reads the top level's rank of sa[n-1] on the card), else
    # scatters the inverse into lcp before the walk
    plcp = torch.empty(n, dtype=torch.int32, device=dev)
    lcp = torch.empty(n, dtype=torch.int32, device=dev)
    code = K.on(dev).colbwt_lcp_lift(r0.data_ptr(), sa.data_ptr(), levels,
                                     len(pyramid), n, plcp.data_ptr(),
                                     lcp.data_ptr(), K.stream_handle(dev))
    K.check("lcp_lift", code)
    K.launches["lcp_lift"] += 1
    return lcp


# ---------------------------------------------------------------------------
# thresholds by segmented first argmin (K12)
# ---------------------------------------------------------------------------


def segmented_argmin_ref(lcp: torch.Tensor, lo: torch.Tensor,
                         hi: torch.Tensor) -> torch.Tensor:
    """Plain K12, construct_jax.py:494-502 with the segment ids of :527-535:
    for m disjoint ascending segments [lo[s], hi[s]] (int64, inclusive) the
    first position of the minimum of `lcp` (int32) in each, by two
    segment-min passes over a per-position segment id.  int64 (m)."""
    n, m = lcp.shape[0], lo.shape[0]
    dev = lcp.device
    big = torch.iinfo(torch.int32).max
    bounds = torch.stack([lo, hi + 1], dim=1).reshape(-1)
    pos = torch.arange(n, dtype=torch.int64, device=dev)
    pos_seg = torch.searchsorted(bounds, pos, right=True)
    seg_id = torch.where(pos_seg % 2 == 1, pos_seg // 2, m)  # m: the rest
    mins = torch.full((m + 1,), big, dtype=torch.int32, device=dev)
    mins = mins.scatter_reduce(0, seg_id, lcp, "amin")
    cand = torch.where(lcp == mins[seg_id], pos, big)
    first = torch.full((m + 1,), big, dtype=torch.int64, device=dev)
    return first.scatter_reduce(0, seg_id, cand, "amin")[:m]


def argmin_tiles(n: int) -> int:
    """The tiles `segmented_argmin` splits an lcp of n positions into at
    most (the segments' span, from lo[0] rounded down to a multiple of 32,
    takes the first of them); its workspace holds a key a tile."""
    return -(-n // _ARGMIN_TILE)


class ArgminWorkspace:
    """K12's scratch for an lcp of n positions, made once per
    `compute_thresholds` and reused for every character: a key a tile, all
    ones between calls (the second kernel puts back each key it takes), and
    the id of the segment that starts in the tile and crosses its end."""

    def __init__(self, n: int, device: torch.device):
        self.n = n
        tiles = argmin_tiles(n)
        self.keys = torch.full((tiles,), -1, dtype=torch.int64, device=device)
        self.owner = torch.empty(tiles, dtype=torch.int32, device=device)


def segmented_argmin(lcp: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                     workspace: ArgminWorkspace | None = None
                     ) -> torch.Tensor:
    """K12: outputs as `segmented_argmin_ref`.  CPU tensors take the plain
    version; CUDA tensors launch `segmented_argmin` (two kernels), which
    needs the segments nonempty, disjoint and ascending within lcp.
    `workspace` (made here when absent) is reused across calls."""
    if lcp.device.type == "cpu":
        return segmented_argmin_ref(lcp, lo, hi)
    dev = lcp.device
    n = lcp.shape[0]
    _check_n(n)
    K.require(lcp, "lcp", torch.int32, dev)
    K.require(lo, "lo", torch.int64, dev)
    K.require(hi, "hi", torch.int64, dev)
    m = lo.shape[0]
    if hi.shape != (m,):
        raise ValueError("lo and hi must have the same shape")
    out = torch.empty(m, dtype=torch.int64, device=dev)
    if m == 0:
        return out
    ws = workspace or ArgminWorkspace(n, dev)
    if ws.n != n or ws.keys.device != dev:
        raise ValueError(f"workspace is for n = {ws.n} on {ws.keys.device}")
    code = K.on(dev).colbwt_segmented_argmin(
        lcp.data_ptr(), n, lo.data_ptr(), hi.data_ptr(), m,
        ws.keys.data_ptr(), ws.owner.data_ptr(), out.data_ptr(),
        K.stream_handle(dev))
    K.check("segmented_argmin", code)
    K.launches["segmented_argmin"] += 1
    return out


def threshold_segments(heads: np.ndarray, lens: np.ndarray
                       ) -> list[tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """(runs, lo, hi) for each character with two runs or more: run
    runs[s] takes its threshold over (end of the previous run of its
    character, its own start], int64, as construct_jax.py:522-528."""
    heads = normalize_heads(heads)
    lens = np.asarray(lens, dtype=np.int64)
    starts = np.zeros(heads.size, dtype=np.int64)
    starts[1:] = np.cumsum(lens[:-1])
    ends = starts + lens - 1
    segs = []
    for c in np.unique(heads):
        runs_c = np.flatnonzero(heads == c)
        if runs_c.size >= 2:
            segs.append((runs_c[1:], ends[runs_c[:-1]] + 1,
                         starts[runs_c[1:]]))
    return segs


def compute_thresholds(heads: np.ndarray, lens: np.ndarray, lcp,
                       device=None) -> np.ndarray:
    """Thresholds on `device` (default cuda), the contract of
    oracle.compute_thresholds and construct_jax.py:505
    compute_thresholds_jax: run i of character c gets the first position of
    the minimum LCP over (end of the previous c-run, start of run i]; 0 for
    the first c-run.  `lcp` is an array or a tensor.  int64 (r)."""
    dev = resolve_device(device)
    lens = np.asarray(lens, dtype=np.int64)
    n = int(lens.sum())
    if n >= 2**31:
        raise ValueError(f"n = {n}: the device thresholds need n < 2**31 "
                         "(oracle.compute_thresholds_fast takes any n)")
    lcp_t = _int32_on(lcp, dev)
    ws = ArgminWorkspace(n, dev) if dev.type == "cuda" else None
    thresholds = np.zeros(lens.size, dtype=np.int64)
    for runs, lo, hi in threshold_segments(heads, lens):
        arg = segmented_argmin(lcp_t, torch.from_numpy(lo).to(dev),
                               torch.from_numpy(hi).to(dev), ws)
        thresholds[runs] = arg.cpu().numpy()
    return thresholds


# ---------------------------------------------------------------------------
# multi-MUM scan (K8, K9)
# ---------------------------------------------------------------------------


def sliding_min_ref(x: torch.Tensor, w: int) -> torch.Tensor:
    """out[i] = min(x[i : i+w]), x[>= n] read as +inf (w >= 1); both
    regimes of construct_jax.py:158 `_sliding_min`: binary doubling for
    w < 128, van Herk/Gil-Werman block cummins from there."""
    if w == 1:
        return x
    n = x.shape[0]
    big = torch.iinfo(x.dtype).max
    if w < 128:
        f = x
        s = 1
        while 2 * s <= w:
            f = torch.minimum(f, _shift_left(f, s, big))
            s *= 2
        return torch.minimum(f, _shift_left(f, w - s, big))
    pad = (-n) % w + w  # round up + one spare block
    blocks = torch.cat([x, x.new_full((pad,), big)]).reshape(-1, w)
    p = torch.cummin(blocks, dim=1).values.reshape(-1)
    s = torch.cummin(blocks.flip(1), dim=1).values.flip(1).reshape(-1)
    return torch.minimum(s[:n], p[w - 1:n + w - 1])


def packbits_little(bits: torch.Tensor) -> torch.Tensor:
    """jnp.packbits(bits, bitorder="little"): ceil(len/8) uint8."""
    n = bits.shape[0]
    b = torch.zeros(-(-n // 8) * 8, dtype=torch.uint8, device=bits.device)
    b[:n] = bits.to(torch.uint8)
    weights = torch.tensor([1, 2, 4, 8, 16, 32, 64, 128], dtype=torch.uint8,
                           device=bits.device)
    return (b.reshape(-1, 8) * weights).sum(dim=1, dtype=torch.uint8)


def unpackbits_little(packed: torch.Tensor, n: int) -> torch.Tensor:
    """The first n bits of little-bit-order `packed`, as bool."""
    shifts = torch.arange(8, dtype=torch.uint8, device=packed.device)
    bits = (packed[:, None] >> shifts) & 1
    return bits.reshape(-1)[:n].bool()


def multi_mum_scan_ref(lcp: torch.Tensor, sa_docs: torch.Tensor,
                       prev_rank: torch.Tensor, num_docs: int, min_mum: int
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain K9: (is_mum bool (n), ell int32 (n)) over int32 lcp, per-rank
    document ids and preceding-character ranks, as construct_jax.py:193-242
    computes them (next-same-doc array built by a stable argsort)."""
    n = lcp.shape[0]
    N = num_docs
    dev = lcp.device
    lcp_ext = torch.cat([lcp, lcp.new_zeros(N)])  # lcp[>= n] = 0
    ell = sliding_min_ref(lcp_ext[1:], N - 1)[:n]
    uniq = (lcp_ext[:n] < ell) & (lcp_ext[N:N + n] < ell)

    pos = torch.arange(n, dtype=torch.int32, device=dev)
    order = torch.sort(sa_docs, stable=True).indices
    pos_sorted = pos[order]
    doc_sorted = sa_docs[order]
    nxt_sorted = torch.cat([pos_sorted[1:], pos.new_full((1,), n)])
    same_doc = torch.cat([doc_sorted[1:] == doc_sorted[:-1],
                          torch.zeros(1, dtype=torch.bool, device=dev)])
    nxt_sorted = torch.where(same_doc, nxt_sorted, n)
    nxt = torch.zeros(n, dtype=torch.int32, device=dev)
    nxt[order] = nxt_sorted
    covers = sliding_min_ref(nxt, N) >= pos + N

    run_change = torch.ones(n, dtype=torch.int32, device=dev)
    run_change[1:] = (prev_rank[1:] != prev_rank[:-1]).to(torch.int32)
    run_id = torch.cumsum(run_change, 0, dtype=torch.int32)
    last = torch.cat([run_id[N - 1:], run_id.new_full((N - 1,), -1)])
    left_max = run_id != last

    is_mum = (ell >= min_mum) & uniq & covers & left_max & (pos <= n - N)
    return is_mum, ell


def mum_scan_chunk_ref(lcp_s: torch.Tensor, docs_s: torch.Tensor,
                       chg_s: torch.Tensor, limit: int, min_mum: int,
                       num_docs: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain K8, construct_jax.py:245-301: (hits packed little-endian,
    ceil(C/8) uint8; ell int32 (C)) for one chunk of C = len - (2N+2)
    window starts.  lcp_s int32, docs_s uint16 or int32 (widened here:
    torch has little uint16 arithmetic), chg_s uint8 run-change marks;
    window starts past `limit` are out of range."""
    N = num_docs
    C = lcp_s.shape[0] - (2 * N + 2)
    dev = lcp_s.device
    ell = sliding_min_ref(lcp_s[1:1 + C + N], N - 1)[:C]
    uniq = (lcp_s[:C] < ell) & (lcp_s[N:N + C] < ell)

    # capped next-same-doc distances: d[j] = least t in [1, N+1] with
    # docs[j+t] == docs[j], else N+1 (exact: a longer distance never breaks
    # a window), then min over the window of j + d[j] must reach i + N
    docs = docs_s.to(torch.int32)
    probe_len = C + N
    d = torch.full((probe_len,), N + 1, dtype=torch.int32, device=dev)
    for t in range(1, N + 2):
        match = docs[t:t + probe_len] == docs[:probe_len]
        d = torch.where(match & (d == N + 1), t, d)
    y = torch.arange(probe_len, dtype=torch.int32, device=dev) + d
    i_local = torch.arange(C, dtype=torch.int32, device=dev)
    covers = sliding_min_ref(y, N)[:C] >= i_local + N

    # left-maximality: a run change in (i, i+N-1]
    neg_chg = -chg_s[1:1 + C + N].to(torch.int32)
    left_max = sliding_min_ref(neg_chg, N - 1)[:C] < 0

    is_mum = ((ell >= min_mum) & uniq & covers & left_max
              & (i_local <= limit))
    return packbits_little(is_mum), ell


def mum_window_route(num_docs: int) -> str:
    """The kernels `mum_scan_chunk` launches for N documents: "tile" (one
    launch) up to _TILE_MAX_N, "two-pass" (the tiles' summaries, then a
    block a span of window starts) above it."""
    return "tile" if num_docs <= _TILE_MAX_N else "two-pass"


def span_tile(num_docs: int) -> int:
    """The large-N route's tile for N documents (csrc/construct.cu
    span_tile_shift): _SPAN from N = _SPAN + 2, else the largest power of
    two <= N - 2, 1 below N = 3; a window's first and last positions lie
    in different tiles."""
    t = 1
    while 2 * t <= min(num_docs - 2, _SPAN):
        t *= 2
    return t


def mum_scan_chunk(lcp_s: torch.Tensor, docs_s: torch.Tensor,
                   chg_s: torch.Tensor, limit: int, min_mum: int,
                   num_docs: int) -> tuple[torch.Tensor, torch.Tensor]:
    """K8 (replaces colbwt_tpu/ops/construct_jax.py:245 _mum_scan_chunk):
    the window test on one chunk, outputs as `mum_scan_chunk_ref`.  CPU
    tensors take the plain version; CUDA tensors launch `mum_window`, by
    the route `mum_window_route` picks for the shape."""
    if lcp_s.device.type == "cpu":
        return mum_scan_chunk_ref(lcp_s, docs_s, chg_s, limit, min_mum,
                                  num_docs)
    dev = lcp_s.device
    N = int(num_docs)
    L = lcp_s.shape[0]
    C = L - (2 * N + 2)
    if N < 2 or C < 1 or L >= 2**31:
        raise ValueError(f"need num_docs >= 2 and 1 <= C, C + 2N + 2 < 2**31 "
                         f"(num_docs={N}, length {L})")
    K.require(lcp_s, "lcp_s", torch.int32, dev)
    if docs_s.dtype not in (torch.uint16, torch.int32):
        raise ValueError(f"docs_s has dtype {docs_s.dtype}, expected uint16 "
                         "or int32")
    K.require(docs_s, "docs_s", docs_s.dtype, dev)
    K.require(chg_s, "chg_s", torch.uint8, dev)
    if docs_s.shape != (L,) or chg_s.shape != (L,):
        raise ValueError(f"lcp_s, docs_s and chg_s must all have shape ({L},)")
    # whole 32-bit ballot words; the tail past ceil(C/8) bytes is dropped
    packed = torch.empty(-(-C // 32) * 4, dtype=torch.uint8, device=dev)
    ell = torch.empty(C, dtype=torch.int32, device=dev)
    limit = max(min(int(limit), C), -1)  # in-chunk arithmetic is int32
    args = (lcp_s.data_ptr(), docs_s.data_ptr(),
            1 if docs_s.dtype == torch.uint16 else 0, chg_s.data_ptr(), C, N,
            limit, int(min_mum))
    if mum_window_route(N) == "tile":
        code = K.on(dev).colbwt_mum_window(
            *args, packed.data_ptr(), ell.data_ptr(), K.stream_handle(dev))
    else:
        # a tile's (least lcp, any run change), int32 pairs
        tiles = -(-L // span_tile(N))
        scratch = torch.empty(2 * tiles, dtype=torch.int32, device=dev)
        code = K.on(dev).colbwt_mum_window_two_pass(
            *args, scratch.data_ptr(), 8 * tiles, packed.data_ptr(),
            ell.data_ptr(), K.stream_handle(dev))
    K.check("mum_window", code)
    # every call; the large-N route's also under its own name
    K.launches["mum_window"] += 1
    if mum_window_route(N) != "tile":
        K.launches["mum_window_two_pass"] += 1
    return packed[:-(-C // 8)], ell


def multi_mum_scan(lcp: torch.Tensor, sa_docs: torch.Tensor,
                   prev_rank: torch.Tensor, num_docs: int, min_mum: int
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """K9 (replaces construct_jax.py:193 multi_mum_scan): (is_mum, ell) over
    the whole array.  CPU tensors take the plain version; on CUDA the whole
    array is padded as one chunk (lcp 0, documents -1, run changes 1 past
    n) and `mum_window` runs once."""
    if lcp.device.type == "cpu":
        return multi_mum_scan_ref(lcp, sa_docs, prev_rank, num_docs, min_mum)
    n = lcp.shape[0]
    packed, ell = mum_scan_chunk(*pad_whole_array(lcp, sa_docs, prev_rank,
                                                  num_docs),
                                 n - num_docs, min_mum, num_docs)
    return unpackbits_little(packed, n), ell


def pad_whole_array(lcp: torch.Tensor, sa_docs: torch.Tensor,
                    prev_rank: torch.Tensor, num_docs: int
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K9's one chunk: (lcp_s int32, docs_s int32, chg_s uint8) of n + 2N +
    2 positions, lcp 0, documents -1 and run changes 1 past n."""
    n = lcp.shape[0]
    dev = lcp.device
    L = n + 2 * num_docs + 2
    lcp_s = torch.zeros(L, dtype=torch.int32, device=dev)
    lcp_s[:n] = lcp
    docs_s = torch.full((L,), -1, dtype=torch.int32, device=dev)
    docs_s[:n] = sa_docs
    chg_s = torch.ones(L, dtype=torch.uint8, device=dev)
    chg_s[1:n] = (prev_rank[1:] != prev_rank[:-1]).to(torch.uint8)
    return lcp_s, docs_s, chg_s


def _slice_padded(arr, s: int, size: int, fill: int, dtype) -> np.ndarray:
    sl = np.array(arr[s:s + size], dtype=dtype)  # a writable copy
    if sl.size < size:
        sl = np.concatenate([sl, np.full(size - sl.size, fill, dtype)])
    return sl


def _run_change_slice(run_change, s: int, size: int, n: int) -> np.ndarray:
    """Bits [s, s+size) of little-endian packed run-change marks as uint8,
    1 past n.  Any s: the slice starts at byte s >> 3, bit s & 7."""
    b0, off = s >> 3, s & 7
    nb = (off + size + 7) >> 3
    raw = np.asarray(run_change[b0:b0 + nb])
    if raw.size < nb:
        raw = np.concatenate([raw, np.full(nb - raw.size, 0xFF, np.uint8)])
    bits = np.unpackbits(raw, bitorder="little")[off:off + size]
    if s + size > n:
        bits[max(0, n - s):] = 1
    return bits


def find_multi_mums_chunked(lcp, sa_docs, run_change, num_docs: int,
                            min_mum: int, chunk: int = 1 << 26, log=None,
                            run_change_packed: bool = False,
                            start_chunk: int = 0,
                            max_chunks: int | None = None,
                            info: dict | None = None, device=None
                            ) -> tuple[np.ndarray, np.ndarray]:
    """The multi-MUM scan streamed through `device` (default cuda) in chunks
    of C = min(chunk, next power of two >= n, at least 8192) positions; the
    outputs of oracle.find_multi_mums, (lengths, positions) int64.

    Inputs may be memmaps: one chunk slice (plus its 2N+2 halo) is read at
    a time.  With `run_change_packed`, `run_change` holds little-endian
    bit-packed marks (mum_scan_stream.write_run_change_bits).
    `start_chunk`/`max_chunks` scan a sub-range (positions stay global) and
    `info["next_chunk"]` reports the first chunk not scanned."""
    import time

    dev = resolve_device(device)
    n = int(lcp.shape[0])
    N = num_docs
    halo = 2 * N + 2
    C = min(chunk, 1 << max(13, (max(n, 2) - 1).bit_length()))
    use_u16 = N < 65535
    docs_dtype = np.uint16 if use_u16 else np.int32
    docs_fill = 65535 if use_u16 else -1

    def upload(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    out_lens: list[np.ndarray] = []
    out_pos: list[np.ndarray] = []
    t0 = time.perf_counter()
    n_chunks = -(-n // C)
    k_end = (n_chunks if max_chunks is None
             else min(n_chunks, start_chunk + max_chunks))
    for k in range(start_chunk, k_end):
        s = k * C
        rc = (_run_change_slice(run_change, s, C + halo, n)
              if run_change_packed
              else _slice_padded(run_change, s, C + halo, 1, np.uint8))
        packed, ell = mum_scan_chunk(
            upload(_slice_padded(lcp, s, C + halo, 0, np.int32)),
            upload(_slice_padded(sa_docs, s, C + halo, docs_fill,
                                 docs_dtype)),
            upload(rc), min(n - N - s, C), min_mum, N)
        bits = np.unpackbits(packed.cpu().numpy(), bitorder="little")[:C]
        pos_local = np.flatnonzero(bits)
        # ell at the hits, indices clipped as construct_jax._gather_i32
        idx = torch.from_numpy(pos_local).to(dev).clamp(0, C - 1)
        out_lens.append(ell[idx].cpu().numpy().astype(np.int64))
        out_pos.append(pos_local.astype(np.int64) + s)
    if info is not None:
        info["next_chunk"] = k_end
    if log:
        log(f"mum-scan chunks [{start_chunk},{k_end}) of {n_chunks} "
            f"(C = {C:,}, N = {N}): {time.perf_counter() - t0:.1f}s")
    if not out_pos:
        z = np.empty(0, dtype=np.int64)
        return z, z.copy()
    return np.concatenate(out_lens), np.concatenate(out_pos)


def find_multi_mums(ranks: np.ndarray, sa: np.ndarray, lcp: np.ndarray,
                    doc_ids: np.ndarray, num_docs: int, min_mum: int = 1,
                    log=None, device=None) -> tuple[np.ndarray, np.ndarray]:
    """oracle.find_multi_mums' signature and outputs on `device` (default
    cuda), routed as construct_jax.find_multi_mums_jax: the one-shot scan
    (K9) below _CHUNKED_SCAN_MIN_N, the chunked scan (K8) from there."""
    dev = resolve_device(device)
    if num_docs < 2:
        return np.empty(0, dtype=np.int64), np.empty(0, dtype=np.int64)
    sa = np.asarray(sa)
    prev_rank = np.asarray(ranks)[sa - 1]
    sa_docs = np.asarray(doc_ids)[sa]
    if sa.shape[0] >= _CHUNKED_SCAN_MIN_N:
        run_change = np.ones(sa.shape[0], dtype=np.uint8)
        np.not_equal(prev_rank[1:], prev_rank[:-1],
                     out=run_change[1:].view(bool))
        return find_multi_mums_chunked(lcp, sa_docs.astype(np.int32),
                                       run_change, num_docs, min_mum,
                                       log=log, device=dev)

    def up(a):
        return torch.from_numpy(np.asarray(a, dtype=np.int32)).to(dev)

    is_mum, ell = multi_mum_scan(up(lcp), up(sa_docs), up(prev_rank),
                                 num_docs, min_mum)
    pos = torch.nonzero(is_mum).reshape(-1)
    return (ell[pos].cpu().numpy().astype(np.int64),
            pos.cpu().numpy().astype(np.int64))
