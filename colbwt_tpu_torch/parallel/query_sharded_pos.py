"""Position-sharded positional-automaton engine: dp×ip mesh, one sum over
"ip" per k characters — port of colbwt_tpu/parallel/query_sharded_pos.py.

The pos tables (ops/query_pos.py) cost (sigma+1)**k · n · 8 bytes.  Here the
(A^k, n, 2) table splits in contiguous POSITION blocks over "ip": shard i
holds positions [i·n_local, (i+1)·n_local) of every key, and each step every
shard answers the batch's row fetch at (key, pos) from its block (the masked
gather of parallel/mesh.py), summed over "ip" into (B, 2) rows: B × 8 bytes
per k characters.  Sharding also relaxes the int32 index bound: each shard
indexes key · n_local + local_pos, so A^k · n/ip < 2**31 suffices.

T1 (A · n · 8 bytes, A = sigma + 1, every dense char a key) is built with
the port's K1 (query_pos.build_t1) and replicated, and each shard composes
its own T_k block from it with K13d `compose_sharded_tk`; positions past n
(the ip padding) get inert self-loop rows.

The scan (K13e) takes one of two routes (`scan_row`), by where the dp
row's shards lie.  All on the row's device: the chunk scan
`sharded_scan_pos` runs every step of the batch in one launch, each lane
reading its row from the owning shard, pos and the match length in
registers.  Spread over cards or ranks: `step_row` fetches each step's
rows with one launch a card, sums them over "ip", and advances the scan k
characters with the per-step kernel `sharded_step_pos` through a launcher
made once a batch (`StepPos`), on (M, B) pattern columns and an (M, B)
output plane.  The kernels are in csrc/query_sharded.cu, each with its
plain PyTorch version beside its wrapper (`sharded_scan_pos_ref`, the step
loop of the plain fetch and `sharded_step_pos_ref`).  A CPU tensor takes
the plain version; a CUDA tensor launches the kernel or raises.

Reads split over "dp" and never communicate.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from colbwt_tpu_torch.models.index import ColPmlIndex
from colbwt_tpu_torch.ops import _kernels as K
from colbwt_tpu_torch.ops import query_pos
from colbwt_tpu_torch.parallel.mesh import (Mesh, pad_batch, resolve_mesh,
                                            shard_pointers, shard_reads,
                                            sharded_fetch_ref, unpad)

INT32_MAX = 2**31 - 1


def choose_k_sharded(index: ColPmlIndex, ip: int,
                     hbm_budget_bytes: int = 10 << 30) -> int:
    """Largest k whose PER-SHARD table block fits the budget, whose
    per-shard gather indices fit int32, and whose positions fit 32-k bits
    (T1 stays replicated, so A * n <= 2**31 is also required)."""
    if index.wide or (index.sigma + 1) * index.n > INT32_MAX:
        return 0
    A = index.sigma + 1
    n_local = -(-index.n // ip)
    best = 0
    for k in (1, 2, 3, 4):
        if ((A ** k) * n_local > INT32_MAX
                or index.n > (1 << query_pos.pos_bits(k))):
            break
        if (A ** k) * n_local * 8 > hbm_budget_bytes:
            break
        best = k
    return best


# ---------------------------------------------------------------------------
# K13d: one shard's block of T_k
# ---------------------------------------------------------------------------

def compose_sharded_tk_ref(t1: torch.Tensor, n: int, n_local: int, lo: int,
                           A: int, k: int) -> torch.Tensor:
    """Plain PyTorch K13d; same contract as `compose_sharded_tk`."""
    pb = query_pos.pos_bits(k)
    t1_mask = query_pos.pos_mask(1)
    dev = t1.device
    gpos = lo + torch.arange(n_local, dtype=torch.int64, device=dev)
    gp = gpos.clamp(max=n - 1)
    rows_total = t1.shape[0]
    out = torch.empty((A ** k * n_local, 2), dtype=torch.int32, device=dev)

    def take(i):
        return t1[i.clamp(0, rows_total - 1)]

    for key in range(A ** k):
        digits, rem = [], key
        for j in range(k):
            p = A ** (k - 1 - j)
            digits.append(rem // p)
            rem %= p
        first = take(digits[0] * n + gp)
        pos = first[:, 0] & t1_mask
        w0 = ((first[:, 0] >> query_pos.T1_POS_BITS) & 1) << pb
        w1 = first[:, 1]
        for j in range(1, k):
            nxt = take(digits[j] * n + pos.long())
            pos = nxt[:, 0] & t1_mask
            w0 = w0 | (((nxt[:, 0] >> query_pos.T1_POS_BITS) & 1) << (pb + j))
            w1 = w1 | ((nxt[:, 1] & 0xFF) << (8 * j))
        w0 = w0 | pos
        # ip-padding rows (gpos >= n) are inert self-loops, never reached
        inside = gpos < n
        out[key * n_local:(key + 1) * n_local, 0] = torch.where(
            inside, w0, gp.to(torch.int32))
        out[key * n_local:(key + 1) * n_local, 1] = torch.where(inside, w1, 0)
    return out


def compose_sharded_tk(t1: torch.Tensor, n: int, n_local: int, lo: int,
                       A: int, k: int) -> torch.Tensor:
    """K13d (replaces colbwt_tpu/parallel/query_sharded_pos.py:66
    _build_sharded_tk): the (A^k · n_local, 2) int32 block of T_k for
    positions [lo, lo + n_local), composed from the replicated T1 ((A·n, 2),
    the k=1 layout) by k chained T1 gathers per row; the kernel follows
    the chain of a key's first k - 1 digits once for all A last digits.  The first processed
    char is the key's high digit; its match bit lands at pos_bits(k) and its
    col id in byte 0.  Rows past n are self-loops [min(gpos, n-1), 0].  CPU
    tensors take the plain version; CUDA tensors launch the kernel."""
    if t1.device.type == "cpu":
        return compose_sharded_tk_ref(t1, n, n_local, lo, A, k)
    dev = t1.device
    K.require(t1, "t1", torch.int32, dev)
    if t1.dim() != 2 or t1.shape[1] != 2 or t1.shape[0] < A * n:
        raise ValueError(f"t1 {tuple(t1.shape)} must be ({A * n}, 2)")
    if not 1 <= k <= query_pos.MAX_K:
        raise ValueError(f"k must be in [1, {query_pos.MAX_K}]")
    out = torch.empty((A ** k * n_local, 2), dtype=torch.int32, device=dev)
    code = K.on(dev).colbwt_compose_sharded_tk(
        t1.data_ptr(), t1.shape[0], int(n), int(n_local), int(lo), int(A),
        int(k), out.data_ptr(), K.stream_handle(dev))
    K.check("compose_sharded_tk", code)
    K.launches["compose_sharded_tk"] += 1
    return out


def shard_pos_tables(index: ColPmlIndex, mesh: Mesh, k: int | None = None,
                     hbm_budget_bytes: int = 10 << 30) -> dict:
    ip = mesh.ip
    if k is None:
        k = choose_k_sharded(index, ip, hbm_budget_bytes)
        if k == 0:
            raise ValueError("no k fits the per-shard HBM budget")
    A = index.sigma + 1
    n = index.n
    n_local = -(-n // ip)
    if index.wide or (A ** k) * n_local > INT32_MAX \
            or n > (1 << query_pos.pos_bits(k)) or A * n > INT32_MAX:
        raise ValueError(
            f"sharded positional tables need A**k * n/ip <= 2**31, "
            f"A * n <= 2**31 (T1 is replicated), and n <= 2**(32-k) "
            f"(A={A}, k={k}, n={n}, ip={ip})")
    C = min(n, query_pos._T1_CHUNK)

    def t1_on(dev):
        return query_pos.build_t1(index, np.arange(A),
                                  query_pos.t1_inputs(index, C, dev), C)

    t1 = mesh.replicate(t1_on)  # every char a key: A = sigma + 1
    table = mesh.shard(lambda i, dev: compose_sharded_tk(
        t1[str(dev)], n, n_local, i * n_local, A, k))
    del t1
    return {"table": table, "n": n, "n_local": n_local, "k": k, "A": A}


# ---------------------------------------------------------------------------
# K13e: the scan
# ---------------------------------------------------------------------------

def step_keys(cols: torch.Tensor, t: int, k: int, A: int) -> torch.Tensor:
    """The key of step t of a scan over (M, B) pattern columns: processed
    chars t·k .. t·k+k-1 (rows M-1-t·k down to M-k-t·k), the first the high
    digit, in int32."""
    M = cols.shape[0]
    key = torch.zeros(cols.shape[1], dtype=torch.int32, device=cols.device)
    for j in range(k):
        key = key * A + cols[M - 1 - (t * k + j)].to(torch.int32)
    return key


def sharded_step_pos_ref(rows, pos, mlen, patterns, t: int, k: int, A: int,
                         packed, g_next, s_next) -> None:
    """Plain PyTorch K13e; same contract as `sharded_step_pos`."""
    M = patterns.shape[0]
    pb = query_pos.pos_bits(k)
    w0, w1 = rows[:, 0], rows[:, 1]
    ln = mlen
    for j in range(k):
        m = (w0 >> (pb + j)) & 1
        ln = (ln + 1) * m
        packed[M - 1 - (t * k + j)] = (ln << 8) | ((w1 >> (8 * j)) & 0xFF)
    pos.copy_(w0 & query_pos.pos_mask(k))
    mlen.copy_(ln)
    if (t + 1) * k < M:
        g_next.copy_(pos)
        s_next.copy_(step_keys(patterns, t + 1, k, A))


class _StepPosArgs(ctypes.Structure):
    """K13e's parameter block (csrc/query_sharded.cu StepPosArgs, field for
    field)."""
    _fields_ = K.block_fields(
        ("rows", "p"), ("pos", "p"), ("mlen", "p"), ("patterns", "p"),
        ("B", "i"), ("M", "i"), ("k", "i"), ("A", "i"), ("packed", "p"),
        ("g_next", "p"), ("s_next", "p"), ("stream", "p"))


def step_pos_params(rows, pos, mlen, patterns, k: int, A: int, packed,
                    g_next, s_next) -> _StepPosArgs:
    """The parameter block of `StepPos`'s arguments, unchecked (StepPos
    checks them first), on the current stream of the patterns' card."""
    M, B = patterns.shape
    return _StepPosArgs(
        rows.data_ptr(), pos.data_ptr(), mlen.data_ptr(),
        patterns.data_ptr(), B, M, int(k), int(A), packed.data_ptr(),
        g_next.data_ptr(), s_next.data_ptr(), K.stream_handle(patterns.device))


class StepPos(K.BatchLauncher):
    """K13e's launcher for one batch: `sharded_step_pos`'s arguments but
    the step, checked once here (device, dtype, shape, contiguity, the
    rows' 8-byte alignment, M a multiple of k), their pointers kept in a
    parameter block; a call launches step t (the plain version on the
    CPU)."""

    entry, kernel = "colbwt_sharded_step_pos", "sharded_step_pos"
    params = staticmethod(step_pos_params)
    ref = staticmethod(sharded_step_pos_ref)

    def __init__(self, rows, pos, mlen, patterns, k: int, A: int, packed,
                 g_next, s_next):
        dev = patterns.device
        K.require(patterns, "patterns", torch.uint8, dev)
        if patterns.dim() != 2:
            raise ValueError("patterns must be (M, B)")
        M, B = patterns.shape
        if not 1 <= k <= query_pos.MAX_K or M % k:
            raise ValueError(f"a (M={M}, B) scan at k={k}: M must be a "
                             f"multiple of k in [1, {query_pos.MAX_K}]")
        K.require(rows, "rows", torch.int32, dev)
        K.require_aligned(rows, "rows", 8)
        if rows.shape != (B, 2):
            raise ValueError(f"rows must have shape ({B}, 2)")
        for name, t in (("pos", pos), ("mlen", mlen), ("g_next", g_next),
                        ("s_next", s_next)):
            K.require(t, name, torch.int32, dev)
            if t.shape != (B,):
                raise ValueError(f"{name} must have shape ({B},)")
        K.require(packed, "packed", torch.int32, dev)
        if packed.shape != (M, B):
            raise ValueError(f"packed must have shape ({M}, {B})")
        self._steps = M // k
        super().__init__(dev, (rows, pos, mlen, patterns, k, A, packed,
                               g_next, s_next), B)

    def args(self, t: int) -> tuple:
        """`sharded_step_pos`'s arguments for step t."""
        a = self._fixed
        return a[:4] + (t,) + a[4:]

    def check_call(self, t: int) -> None:
        if not 0 <= t < self._steps:
            raise ValueError(f"step {t} of {self._steps}")


def sharded_step_pos(rows, pos, mlen, patterns, t: int, k: int, A: int,
                     packed, g_next, s_next) -> None:
    """K13e per step (replaces one step of the lax.scan of
    colbwt_tpu/parallel/query_sharded_pos.py:162 _sharded_pos_query, for
    `step_row`): step t of the positional scan from the summed (B, 2) rows
    at (key, pos).  `patterns` is the batch's (M, B) uint8 columns (M a
    multiple of k).  Writes the packed outputs ln << 8 | cid of processed
    chars t·k .. t·k+k-1 (rows M-1-q of `packed`, (M, B) int32), updates
    (pos, mlen) in place, and writes the next step's position and key into
    g_next and s_next.  The state runs on past a read's end (`lengths` play
    no part, as in JAX).  One call, checked in full (a `StepPos` made and
    called once); CPU tensors take the plain version, CUDA tensors launch
    the kernel."""
    StepPos(rows, pos, mlen, patterns, k, A, packed, g_next, s_next)(t)


def sharded_scan_pos_ref(shards: list, L: int, patterns, k: int, A: int,
                         n: int) -> torch.Tensor:
    """Plain PyTorch K13e chunk scan; same contract as `sharded_scan_pos`:
    a step loop of the plain fetch (the sum over the shards) and the plain
    step."""
    dev = patterns.device
    B, M = patterns.shape
    if B == 0 or M == 0:
        return torch.zeros((B, M), dtype=torch.int32, device=dev)
    cols = patterns.t().contiguous()
    packed = torch.zeros((M, B), dtype=torch.int32, device=dev)
    pos = torch.full((B,), n - 1, dtype=torch.int32, device=dev)
    mlen = torch.zeros((B,), dtype=torch.int32, device=dev)
    g, s = pos.clone(), step_keys(cols, 0, k, A)
    for t in range(M // k):
        rows = sharded_fetch_ref(shards, g, s, L, L)
        sharded_step_pos_ref(rows, pos, mlen, cols, t, k, A, packed, g, s)
    return packed.t().contiguous()


def sharded_scan_pos(shards: list, L: int, patterns, k: int, A: int, n: int
                     ) -> torch.Tensor:
    """K13e chunk scan (replaces the lax.scan inside shard_map of
    colbwt_tpu/parallel/query_sharded_pos.py:162 _sharded_pos_query): all
    M/k steps of a (B, M) uint8 right-aligned batch (M a multiple of k) in
    one launch, every shard of the dp row on this card, from pos n - 1 and
    match length 0.  shards[i] is the T_k table's (A**k · L, 2) int32 shard
    i (positions [i·L, (i+1)·L) of every key); a position that no shard
    owns reads as zeros.  Returns the packed (B, M) int32 outputs ln << 8 |
    cid.  CPU tensors take the plain version; CUDA tensors launch the
    kernel."""
    if patterns.device.type == "cpu":
        return sharded_scan_pos_ref(shards, L, patterns, k, A, n)
    dev = patterns.device
    if any(t is None for t in shards):
        raise ValueError("the chunk scan needs every shard on the card")
    tab = shard_pointers(shards, dev, 2)
    K.require(patterns, "patterns", torch.uint8, dev)
    if patterns.dim() != 2:
        raise ValueError("patterns must be (B, M)")
    B, M = patterns.shape
    if not 1 <= k <= query_pos.MAX_K or M % k:
        raise ValueError(f"a (B, M={M}) scan at k={k}: M must be a multiple "
                         f"of k in [1, {query_pos.MAX_K}]")
    # a column-major plane (a warp's stores of a step coalesced),
    # transposed here as the JAX scan transposes its stacked steps
    packed = torch.empty((M, B), dtype=torch.int32, device=dev)
    if B and M:
        code = K.on(dev).colbwt_sharded_scan_pos(
            tab.data_ptr(), len(shards), int(L), patterns.data_ptr(), B, M,
            int(k), int(A), int(n), packed.data_ptr(), K.stream_handle(dev))
        K.check("sharded_scan_pos", code)
        K.launches["sharded_scan_pos"] += 1
    return packed.t().contiguous()


def step_row(mesh: Mesh, st: dict, d: int, patterns: torch.Tensor
             ) -> torch.Tensor:
    """The per-step route of `scan_row`: each step one fetch a card of the
    row's shards it holds, the sum over "ip" (adds across cards, all_reduce
    across ranks) into one (B, 2) buffer, then the per-step kernel
    `sharded_step_pos`.  The batch's patterns are transposed once to (M, B)
    columns, the fetch and the step prepared once (their checks made here:
    `Mesh.gatherer`, `StepPos`), and the (M, B) plane, which the steps
    write whole, transposed once at the end."""
    dev = patterns.device
    B, M = patterns.shape
    if B == 0 or M == 0:
        return torch.zeros((B, M), dtype=torch.int32, device=dev)
    k, A, n, L = st["k"], st["A"], st["n"], st["n_local"]
    cols = patterns.t().contiguous()
    packed = torch.empty((M, B), dtype=torch.int32, device=dev)
    pos = torch.full((B,), n - 1, dtype=torch.int32, device=dev)
    mlen = torch.zeros((B,), dtype=torch.int32, device=dev)
    g, s = pos.clone(), step_keys(cols, 0, k, A)
    rows = torch.empty((B, 2), dtype=torch.int32, device=dev)
    step = StepPos(rows, pos, mlen, cols, k, A, packed, g, s)
    fetch = mesh.gatherer(st["table"], d, L, g, s, stride=L, out=rows)
    for t in range(M // k):
        fetch()
        step(t)
    return packed.t().contiguous()


def scan_row(mesh: Mesh, st: dict, d: int, patterns: torch.Tensor
             ) -> torch.Tensor:
    """dp row d's scan of (B, M) uint8 dense ids (M a multiple of k):
    returns the packed (B, M) int32 outputs ln << 8 | cid.

    The route follows where the row's shards lie: all of them on the row's
    device (a repeated device list, any ip = 1 mesh, every CPU mesh) takes
    the chunk scan `sharded_scan_pos`, one launch; shards on other cards or
    ranks take `step_row`."""
    dev = patterns.device
    cards = mesh.card_shards(st["table"], d)
    if len(cards) == 1 and str(cards[0][0]) == str(dev) and all(
            t is not None for t in cards[0][1]):
        return sharded_scan_pos(cards[0][1], st["n_local"], patterns,
                                st["k"], st["A"], st["n"])
    return step_row(mesh, st, d, patterns)


def query_batch_sharded_pos(index: ColPmlIndex, patterns: list[bytes],
                            mesh: Mesh | None = None, dp: int | None = None,
                            ip: int = 1, max_len: int | None = None,
                            st: dict | None = None, k: int | None = None
                            ) -> tuple[list[np.ndarray], list[np.ndarray]]:
    mesh = resolve_mesh(mesh, dp, ip)
    st = st or shard_pos_tables(index, mesh, k)
    m_raw = max_len if max_len is not None else max(
        (len(p) for p in patterns), default=1)
    M = -(-m_raw // st["k"]) * st["k"]
    enc, lens = pad_batch(index, patterns, mesh.dp, M)
    (packed,) = mesh.collect({d: (scan_row(mesh, st, d, p),)
                              for d, (p, _) in shard_reads(enc, lens,
                                                           mesh).items()})
    return unpad(packed >> 8, packed & 0xFF, lens, len(patterns))
