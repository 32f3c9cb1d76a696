"""Interval-sharded mega engine: dp×ip mesh, one sum over "ip" per
character step — port of colbwt_tpu/parallel/query_sharded_mega.py.

The mega table ((sigma+1)·r × 16, ops/query_mega.py) splits into contiguous
row blocks over "ip"; each step every shard answers the batch's row fetch at
c·r + interval from its block (the masked gather of parallel/mesh.py) and
the sum over "ip" assembles the (B, 16) rows.  Run lengths, which the
fast-forward rounds past the first read, are replicated.  Reads split over
"dp" and never communicate.

A chunk of the scan takes one of two routes (`scan_chunk`), by where the
dp row's shards lie.  All on the row's device: K13b/K13c
`sharded_scan_mega` (csrc/query_mega.cu) runs every step of the chunk in
one launch, each lane reading its row from the owning shard, state in
registers.  Spread over cards or ranks: `step_chunk` fetches each step's
rows with one launch a card, sums them over "ip", and applies the per-step
kernel `sharded_step_mega` (csrc/query_sharded.cu) through a launcher made
once a chunk (`StepMega`), on (C, B) pattern columns and output planes.
Both serve the narrow engine here and the wide one (two limbs, parallel/
query_sharded_mega_wide.py); each kernel has its plain PyTorch version
beside it (`sharded_scan_mega_ref`, the step loop of the plain fetch and
`sharded_step_mega_ref`).  A CPU tensor takes the plain version; a CUDA
tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from colbwt_tpu_torch.models.index import ColPmlIndex
from colbwt_tpu_torch.models.tensors import to_device
from colbwt_tpu_torch.ops import _kernels as K
from colbwt_tpu_torch.ops import query_mega
from colbwt_tpu_torch.ops.query_mega_wide import LIMB, _lt
from colbwt_tpu_torch.ops.query_xla import _gather
from colbwt_tpu_torch.parallel.mesh import (Mesh, pad_batch, resolve_mesh,
                                            shard_pointers, shard_reads,
                                            sharded_fetch_ref, unpad)


def shard_mega(index: ColPmlIndex, mesh: Mesh, mt: dict | None = None
               ) -> dict:
    """Pad the mega table to an ip multiple with zero rows and place it on
    the mesh: shard i holds rows [i·rows_local, (i+1)·rows_local).  `mt` is
    a `build_mega_table` dict of either package (default: the port's, built
    on the host)."""
    mt = mt or query_mega.build_mega_table(index, device="cpu")

    def host_array(a) -> np.ndarray:
        return (a.cpu().numpy() if isinstance(a, torch.Tensor)
                else np.asarray(a))

    mega = host_array(mt["mega"])
    ip = mesh.ip
    rows = mega.shape[0]
    pad = (-rows) % ip
    if pad:
        mega = np.concatenate(
            [mega, np.zeros((pad, mega.shape[1]), mega.dtype)])
    rl = mega.shape[0] // ip
    length = host_array(mt["length"])
    return {
        "mega": mesh.shard(lambda i, dev: to_device(
            mega[i * rl:(i + 1) * rl], dev)),
        # run lengths replicated (4 B/run) for the fast-forward rounds
        # beyond the precomputed first one
        "length": mesh.replicate(lambda dev: to_device(length, dev)),
        "rows_padded": mega.shape[0],
        "n": int(np.asarray(mt["n"])),
        "r": int(np.asarray(mt["r"])),
        "last_len": int(np.asarray(mt["last_len"])),
    }


def sharded_step_mega_ref(rows, length, r: int, n_lo: int, n_hi: int, state,
                          patterns, lengths, s: int, step_offset: int,
                          ff_bound: int, pml, cid, g_next,
                          wide: bool) -> None:
    """Plain PyTorch K13b/K13c; same contract as `sharded_step_mega`."""
    C = patterns.shape[0]
    col = C - 1 - s
    if wide:  # colbwt_tpu/parallel/query_sharded_mega_wide.py:127-172
        interval, offset, pos_lo, pos_hi, mlen = state
        mc = rows[:, 0]
        match = (mc >> 8) == 1
        cid_out = mc & 0xFF
        doff = rows[:, 2] + offset
        lf_lo = rows[:, 3] + offset
        carry = (lf_lo >= LIMB).to(torch.int32)
        lf_lo = lf_lo - carry * LIMB
        lf_hi = rows[:, 4] + carry
        di0 = rows[:, 1]
        take_pred = (~match & _lt(pos_hi, pos_lo, rows[:, 7], rows[:, 6])
                     & (rows[:, 12] >= 0))
        take_succ = ~match & ~take_pred & _lt(rows[:, 7], rows[:, 6], n_hi,
                                              n_lo)
        P, S = 12, 8
    else:  # colbwt_tpu/parallel/query_sharded_mega.py:76-112
        interval, offset, pos_lo, mlen = state
        match = rows[:, 0] == 1
        cid_out = rows[:, 1]
        doff = rows[:, 3] + offset
        lf_lo = rows[:, 4] + offset
        di0 = rows[:, 2]
        take_pred = ~match & (pos_lo < rows[:, 6]) & (rows[:, 10] >= 0)
        take_succ = ~match & ~take_pred & (rows[:, 6] < n_lo)
        P, S = 10, 7
    over = doff >= rows[:, 5]
    di = di0 + over.to(torch.int32)
    doff = doff - torch.where(over, rows[:, 5], 0)
    for _ in range(ff_bound - 2):
        ln = _gather(length, di)
        over = doff >= ln
        di = di + over.to(torch.int32)
        doff = doff - torch.where(over, ln, 0)

    def pick(j, lf):
        return torch.where(take_pred, rows[:, P + j],
                           torch.where(take_succ, rows[:, S + j], lf))

    new = [pick(0, di), pick(1, doff), pick(2, lf_lo)]
    if wide:
        new.append(pick(3, lf_hi))
    nlen = torch.where(match, mlen + 1, 0)
    new.append(nlen)
    valid = s + step_offset < lengths
    for t, v in zip(state, new):
        t.copy_(torch.where(valid, v, t))
    pml[col] = torch.where(valid, nlen, 0)
    cid[col] = torch.where(valid, cid_out, 0)
    if s + 1 < C:
        g_next.copy_(patterns[col - 1].to(torch.int32) * r + state[0])


class _StepMegaArgs(ctypes.Structure):
    """K13b/K13c's parameter block (csrc/query_sharded.cu StepMegaArgs,
    field for field)."""
    _fields_ = K.block_fields(
        ("rows", "p"), ("length", "p"), ("r", "i"), ("n_lo", "i"),
        ("n_hi", "i"), ("interval", "p"), ("offset", "p"), ("pos_lo", "p"),
        ("pos_hi", "p"), ("mlen", "p"), ("patterns", "p"), ("lengths", "p"),
        ("B", "i"), ("C", "i"), ("step_offset", "i"), ("ff_bound", "i"),
        ("wide", "i"), ("pml", "p"), ("cid", "p"), ("g_next", "p"),
        ("stream", "p"))


def step_mega_params(rows, length, r: int, n_lo: int, n_hi: int, state,
                     patterns, lengths, step_offset: int, ff_bound: int,
                     pml, cid, g_next, wide: bool) -> _StepMegaArgs:
    """The parameter block of `StepMega`'s arguments, unchecked (StepMega
    checks them first), on the current stream of the patterns' card."""
    C, B = patterns.shape
    ptrs = [t.data_ptr() for t in state]
    if not wide:
        ptrs.insert(3, None)  # no pos_hi
    return _StepMegaArgs(
        rows.data_ptr(), length.data_ptr(), int(r), int(n_lo), int(n_hi),
        *ptrs, patterns.data_ptr(), lengths.data_ptr(), B, C,
        int(step_offset), int(ff_bound), int(wide), pml.data_ptr(),
        cid.data_ptr(), g_next.data_ptr(), K.stream_handle(patterns.device))


class StepMega(K.BatchLauncher):
    """K13b/K13c's launcher for one chunk: `sharded_step_mega`'s arguments
    but the step, checked once here (device, dtype, shape, contiguity, the
    rows' 16-byte alignment), their pointers kept in a parameter block; a
    call launches step s (the plain version on the CPU)."""

    entry, kernel = "colbwt_sharded_step_mega", "sharded_step_mega"
    params = staticmethod(step_mega_params)
    ref = staticmethod(sharded_step_mega_ref)

    def __init__(self, rows, length, r: int, n_lo: int, n_hi: int, state,
                 patterns, lengths, step_offset: int, ff_bound: int, pml,
                 cid, g_next, wide: bool):
        dev = patterns.device
        K.require(patterns, "patterns", torch.uint8, dev)
        if patterns.dim() != 2:
            raise ValueError("patterns must be (C, B)")
        C, B = patterns.shape
        K.require(rows, "rows", torch.int32, dev)
        K.require_aligned(rows, "rows", 16)
        if rows.shape != (B, 16):
            raise ValueError(f"rows must have shape ({B}, 16)")
        K.require(length, "length", torch.int32, dev)
        if len(state) != (5 if wide else 4):
            raise ValueError("state has the wrong arity")
        for name, t in ((("lengths", lengths), ("g_next", g_next))
                        + tuple((f"state[{j}]", x)
                                for j, x in enumerate(state))):
            K.require(t, name, torch.int32, dev)
            if t.shape != (B,):
                raise ValueError(f"{name} must have shape ({B},)")
        for name, t in (("pml", pml), ("cid", cid)):
            K.require(t, name, torch.int32, dev)
            if t.shape != (C, B):
                raise ValueError(f"{name} must have shape ({C}, {B})")
        self._C = C
        super().__init__(dev, (rows, length, r, n_lo, n_hi, state, patterns,
                               lengths, step_offset, ff_bound, pml, cid,
                               g_next, wide), B)

    def args(self, s: int) -> tuple:
        """`sharded_step_mega`'s arguments for step s."""
        a = self._fixed
        return a[:8] + (s,) + a[8:]

    def check_call(self, s: int) -> None:
        if not 0 <= s < self._C:
            raise ValueError(f"step {s} of {self._C}")


def sharded_step_mega(rows, length, r: int, n_lo: int, n_hi: int, state,
                      patterns, lengths, s: int, step_offset: int,
                      ff_bound: int, pml, cid, g_next, wide: bool) -> None:
    """K13b/K13c per step (replaces one step of
    colbwt_tpu/parallel/query_sharded_mega.py:53 _sharded_mega_query and
    query_sharded_mega_wide.py:101 _sharded_mega_wide_chunk, for
    `step_chunk`): step s of a chunk's backward scan from the summed
    (B, 16) rows at c·r + interval.  `patterns` is the chunk's (C, B)
    uint8 columns (step s reads row C-1-s).  `state` is (interval, offset,
    pos, mlen) narrow or (interval, offset, pos_lo, pos_hi, mlen) wide,
    updated in place where step_offset + s < lengths; row C-1-s of the
    (C, B) int32 planes pml and cid is written (0 past a read's end);
    g_next gets the next step's row index.  n is (n_lo, n_hi) limbs wide,
    n_lo alone narrow.  One call, checked in full (a `StepMega` made and
    called once); CPU tensors take the plain version, CUDA tensors launch
    the kernel."""
    StepMega(rows, length, r, n_lo, n_hi, state, patterns, lengths,
             step_offset, ff_bound, pml, cid, g_next, wide)(s)


def sharded_scan_mega_ref(shards: list, L: int, length, r: int, n_lo: int,
                          n_hi: int, state, patterns, lengths,
                          step_offset: int, ff_bound: int, wide: bool
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch K13b/K13c chunk scan; same contract as
    `sharded_scan_mega`: a step loop of the plain fetch (the sum over the
    shards) and the plain step."""
    dev = patterns.device
    B, C = patterns.shape
    if B == 0 or C == 0:
        return (torch.zeros((B, C), dtype=torch.int32, device=dev),
                torch.zeros((B, C), dtype=torch.int32, device=dev))
    cols = patterns.t().contiguous()
    pml = torch.zeros((C, B), dtype=torch.int32, device=dev)
    cid = torch.zeros((C, B), dtype=torch.int32, device=dev)
    g = cols[C - 1].to(torch.int32) * r + state[0]
    for s in range(C):
        rows = sharded_fetch_ref(shards, g, None, L)
        sharded_step_mega_ref(rows, length, r, n_lo, n_hi, state, cols,
                              lengths, s, step_offset, ff_bound, pml, cid, g,
                              wide)
    return pml.t().contiguous(), cid.t().contiguous()


def sharded_scan_mega(shards: list, L: int, length, r: int, n_lo: int,
                      n_hi: int, state, patterns, lengths, step_offset: int,
                      ff_bound: int, wide: bool
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """K13b/K13c chunk scan (replaces the lax.scan inside shard_map of
    colbwt_tpu/parallel/query_sharded_mega.py:53 _sharded_mega_query and
    query_sharded_mega_wide.py:101 _sharded_mega_wide_chunk): all C steps
    of a (B, C) uint8 chunk in one launch, every shard of the dp row on
    this card.  shards[i] is the mega table's (L, 16) int32 shard i (rows
    [i·L, (i+1)·L)); a row that no shard owns reads as zeros.  `state` is
    (interval, offset, pos, mlen) narrow or (interval, offset, pos_lo,
    pos_hi, mlen) wide, updated in place where step_offset + s < lengths;
    returns (pml, cid), each (B, C) int32, 0 past a read's end.  n is
    (n_lo, n_hi) limbs wide, n_lo alone narrow.  CPU tensors take the plain
    version; CUDA tensors launch the kernel (csrc/query_mega.cu)."""
    if patterns.device.type == "cpu":
        return sharded_scan_mega_ref(shards, L, length, r, n_lo, n_hi, state,
                                     patterns, lengths, step_offset,
                                     ff_bound, wide)
    dev = patterns.device
    B, C = patterns.shape
    if any(t is None for t in shards):
        raise ValueError("the chunk scan needs every shard on the card")
    tab = shard_pointers(shards, dev, 16)
    K.require(patterns, "patterns", torch.uint8, dev)
    K.require(length, "length", torch.int32, dev)
    if len(state) != (5 if wide else 4):
        raise ValueError("state has the wrong arity")
    for name, t in ((("lengths", lengths),)
                    + tuple((f"state[{j}]", x) for j, x in enumerate(state))):
        K.require(t, name, torch.int32, dev)
        if t.shape != (B,):
            raise ValueError(f"{name} must have shape ({B},)")
    # column-major planes (coalesced stores: 318 MB at G-mega's batch),
    # transposed here as the JAX scan transposes its stacked steps
    pml = torch.empty((C, B), dtype=torch.int32, device=dev)
    cid = torch.empty((C, B), dtype=torch.int32, device=dev)
    ptrs = [t.data_ptr() for t in state]
    if not wide:
        ptrs.insert(3, None)  # no pos_hi
    n = int(n_hi) * LIMB + int(n_lo) if wide else int(n_lo)
    if B and C:
        code = K.on(dev).colbwt_sharded_scan_mega(
            int(wide), tab.data_ptr(), len(shards), int(L), length.data_ptr(),
            int(r), n, patterns.data_ptr(), lengths.data_ptr(), *ptrs,
            int(step_offset), B, C, int(ff_bound), pml.data_ptr(),
            cid.data_ptr(), K.stream_handle(dev))
        K.check("sharded_scan_mega", code)
        K.launches["sharded_scan_mega"] += 1
    return pml.t().contiguous(), cid.t().contiguous()


def _row_args(st: dict, wide: bool) -> tuple[int, int, int]:
    """(r, n_lo, n_hi) of a placed mega table."""
    return (st["r"],) + ((st["n_lo"], st["n_hi"]) if wide else (st["n"], 0))


def step_chunk(mesh: Mesh, st: dict, d: int, patterns: torch.Tensor,
               lengths: torch.Tensor, state, step_offset: int, ff_bound: int,
               wide: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """The per-step route of `scan_chunk`: each step one fetch a card of
    the row's shards it holds, the sum over "ip" (adds across cards,
    all_reduce across ranks) into one (B, 16) buffer, then the per-step
    kernel `sharded_step_mega`.  The chunk's patterns are transposed once
    to (C, B) columns, the fetch and the step prepared once (their checks
    made here: `Mesh.gatherer`, `StepMega`), and the (C, B) planes, which
    the steps write whole, transposed once at the end."""
    dev = patterns.device
    B, C = patterns.shape
    if B == 0 or C == 0:
        return (torch.zeros((B, C), dtype=torch.int32, device=dev),
                torch.zeros((B, C), dtype=torch.int32, device=dev))
    L = st["rows_padded"] // mesh.ip
    r, n_lo, n_hi = _row_args(st, wide)
    cols = patterns.t().contiguous()
    pml = torch.empty((C, B), dtype=torch.int32, device=dev)
    cid = torch.empty((C, B), dtype=torch.int32, device=dev)
    g = cols[C - 1].to(torch.int32) * r + state[0]
    rows = torch.empty((B, 16), dtype=torch.int32, device=dev)
    fetch = mesh.gatherer(st["mega"], d, L, g, out=rows)  # the summed fetch
    step = StepMega(rows, st["length"][str(dev)], r, n_lo, n_hi, state, cols,
                    lengths, step_offset, ff_bound, pml, cid, g, wide)
    for s in range(C):
        fetch()
        step(s)
    return pml.t().contiguous(), cid.t().contiguous()


def scan_chunk(mesh: Mesh, st: dict, d: int, patterns: torch.Tensor,
               lengths: torch.Tensor, state, step_offset: int, ff_bound: int,
               wide: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """One chunk of dp row d's backward scan (uint8 (B, C) dense ids on the
    row's device) with the carried `state`, updated in place; steps count
    from step_offset.  Returns (pml, cid), each (B, C) int32.

    The route follows where the row's shards lie: all of them on the row's
    device (a repeated device list, any ip = 1 mesh, every CPU mesh) takes
    the chunk scan `sharded_scan_mega`, one launch; shards on other cards
    or ranks take `step_chunk`."""
    dev = patterns.device
    cards = mesh.card_shards(st["mega"], d)
    if len(cards) == 1 and str(cards[0][0]) == str(dev) and all(
            t is not None for t in cards[0][1]):
        r, n_lo, n_hi = _row_args(st, wide)
        return sharded_scan_mega(cards[0][1], st["rows_padded"] // mesh.ip,
                                 st["length"][str(dev)], r, n_lo, n_hi,
                                 state, patterns, lengths, step_offset,
                                 ff_bound, wide)
    return step_chunk(mesh, st, d, patterns, lengths, state, step_offset,
                      ff_bound, wide)


def query_batch_sharded_mega(index: ColPmlIndex, patterns: list[bytes],
                             mesh: Mesh | None = None, dp: int | None = None,
                             ip: int = 1, max_len: int | None = None,
                             st: dict | None = None
                             ) -> tuple[list[np.ndarray], list[np.ndarray]]:
    mesh = resolve_mesh(mesh, dp, ip)
    st = st or shard_mega(index, mesh)
    enc, lens = pad_batch(index, patterns, mesh.dp, max_len)
    outs = {}
    for d, (p, ln) in shard_reads(enc, lens, mesh).items():
        def full(v):
            return torch.full((p.shape[0],), v, dtype=torch.int32,
                              device=p.device)

        state = (full(st["r"] - 1), full(st["last_len"] - 1),
                 full(st["n"] - 1), full(0))
        outs[d] = scan_chunk(mesh, st, d, p, ln, state, 0, index.ff_bound,
                             wide=False)
    pml, cid = mesh.collect(outs)
    return unpad(pml, cid, lens, len(patterns))
