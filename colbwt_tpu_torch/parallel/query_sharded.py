"""Interval-sharded, data-parallel compact query engine — port of
colbwt_tpu/parallel/query_sharded.py.

Reads split over "dp" and never communicate.  The run table splits over
"ip" in contiguous run blocks; every table access is a masked gather summed
over "ip" (parallel/mesh.py).  The recurrence is the compact engine's
query_step (colbwt_tpu/ops/query_xla.py:89), whose gathers depend on each
other, so one character step is a chain of gather rounds, each a fetch of
packed run rows (one sum a round, where JAX sums one field at a time: the
same values) followed by the step kernel:

  1 run row at interval and jump row [succ, pred] at (c, interval)
  2 run rows at succ and pred (threshold and length)
  3 run row at the new interval (dest_interval, dest_offset)
  4 run row at dest (idx, then the first fast-forward round)
  5 run row at dest, ff_bound - 2 more times (fast-forward)

K13a has two routes (csrc/query_sharded.cu), chosen by where the row's
shards lie, each with its plain PyTorch version beside it:

- every shard of the dp row on the row's card (a repeated device list, any
  ip = 1 mesh, every CPU mesh): the chunk scan `sharded_scan_compact`, all
  the steps of the batch in one launch, the rounds' reads made in the
  kernel from the shards on the card;
- shards on other cards or ranks: `round_row`, each round a fetch a card
  summed over "ip" (`Mesh.gatherer`), then the round kernel
  `sharded_step_compact` through a launcher made once a batch
  (`RoundCompact`), on (M, B) pattern columns and output planes.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises.  The engine needs a run-split index (ff_bound >= 1): the unbounded
fast-forward would read run lengths of other shards.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from colbwt_tpu_torch.models.index import ColPmlIndex
from colbwt_tpu_torch.ops import _kernels as K
from colbwt_tpu_torch.parallel.mesh import (Mesh, pad_batch, resolve_mesh,
                                            shard_index, shard_pointers,
                                            shard_reads, sharded_fetch_ref,
                                            unpad)

# columns of the packed run row (mesh.SOA_FIELDS)
F_CHAR, F_IDX, F_LEN, F_DI, F_DOFF, F_CID, F_THR = range(7)
# rows of the per-lane scratch carried between rounds (S_SI, S_PI, S_DI
# unwritten: g_a and g_b hold those values)
S_CID, S_MATCH, S_SI, S_PI, S_NOFF, S_NLEN, S_DI, S_DOFF, S_NPOS = range(9)
SCRATCH_ROWS = 9


def rounds(ff_bound: int) -> list[int]:
    """The gather rounds of one character step."""
    return [1, 2, 3, 4] + [5] * max(ff_bound - 2, 0)


def sharded_step_compact_ref(rnd: int, last: bool, row_a, row_b, scratch,
                             state, patterns, lengths, i: int, r: int, n: int,
                             ff_bound: int, pml, cid, g_a, g_b, s_b) -> None:
    """Plain PyTorch K13a; same contract as `sharded_step_compact`."""
    interval, offset, pos, length = state
    sc = scratch
    M = patterns.shape[0]
    a = row_a
    if rnd == 1:
        c = patterns[M - 1 - i].to(torch.int32)
        sc[S_CID] = a[:, F_CID]
        sc[S_MATCH] = (a[:, F_CHAR] == c).to(torch.int32)
        g_a.copy_(row_b[:, 0])
        g_b.copy_(row_b[:, 1])
        return
    if rnd == 2:
        si, pi = g_a, g_b  # round 1 left succ and pred there
        has_succ = si < r
        has_pred = pi >= 0
        thr = torch.where(has_succ, a[:, F_THR], n)
        use_pred = (pos < thr) & has_pred
        ti = torch.where(use_pred, pi, torch.where(has_succ, si, interval))
        toff = torch.where(use_pred, row_b[:, F_LEN] - 1,
                           torch.where(has_succ, 0, offset))
        match = sc[S_MATCH] != 0
        sc[S_NOFF] = torch.where(match, offset, toff)
        sc[S_NLEN] = torch.where(match, length + 1, 0)
        g_a.copy_(torch.where(match, interval, ti))
        return
    npos = None
    if rnd == 3:
        di = a[:, F_DI]
        doff = a[:, F_DOFF] + sc[S_NOFF]
    else:
        di, doff = g_a.clone(), sc[S_DOFF].clone()  # the last round's di
        if rnd == 4:
            npos = a[:, F_IDX] + doff
        if rnd == 5 or ff_bound >= 2:
            ln = a[:, F_LEN]
            over = doff >= ln
            di = di + over.to(torch.int32)
            doff = doff - torch.where(over, ln, 0)
    g_a.copy_(di)
    if not last:
        sc[S_DOFF] = doff
        if npos is not None:
            sc[S_NPOS] = npos
        return
    if npos is None:
        npos = sc[S_NPOS]
    valid = i < lengths
    nlen = sc[S_NLEN]
    interval.copy_(torch.where(valid, di, interval))
    offset.copy_(torch.where(valid, doff, offset))
    pos.copy_(torch.where(valid, npos, pos))
    length.copy_(torch.where(valid, nlen, length))
    pml[M - 1 - i] = torch.where(valid, nlen, 0)
    cid[M - 1 - i] = torch.where(valid, sc[S_CID], 0)
    if i + 1 < M:
        g_a.copy_(interval)
        g_b.copy_(interval)
        s_b.copy_(patterns[M - 2 - i].to(torch.int32))


class _RoundCompactArgs(ctypes.Structure):
    """K13a's parameter block (csrc/query_sharded.cu RoundCompactArgs,
    field for field)."""
    _fields_ = K.block_fields(
        ("row_a", "p"), ("row_jump", "p"), ("row_run", "p"),
        ("scratch", "p"), ("interval", "p"), ("offset", "p"), ("pos", "p"),
        ("length", "p"), ("patterns", "p"), ("lengths", "p"), ("B", "i"),
        ("M", "i"), ("r", "i"), ("n", "i"), ("ff_bound", "i"), ("pml", "p"),
        ("cid", "p"), ("g_a", "p"), ("g_b", "p"), ("s_b", "p"),
        ("stream", "p"))


def round_compact_params(row_a, row_jump, row_run, scratch, state, patterns,
                         lengths, r: int, n: int, ff_bound: int, pml, cid,
                         g_a, g_b, s_b) -> _RoundCompactArgs:
    """The parameter block of `RoundCompact`'s arguments, unchecked
    (RoundCompact checks them first), on the current stream of the
    patterns' card."""
    M, B = patterns.shape
    return _RoundCompactArgs(
        row_a.data_ptr(), None if row_jump is None else row_jump.data_ptr(),
        None if row_run is None else row_run.data_ptr(), scratch.data_ptr(),
        *(t.data_ptr() for t in state), patterns.data_ptr(),
        lengths.data_ptr(), B, M, int(r), int(n), int(ff_bound),
        pml.data_ptr(), cid.data_ptr(), g_a.data_ptr(), g_b.data_ptr(),
        s_b.data_ptr(), K.stream_handle(patterns.device))


def _round_args(fixed: tuple, rnd: int, last: bool, i: int) -> tuple:
    """`sharded_step_compact`'s arguments for round rnd of step i from a
    launcher's (row_a, row_jump, row_run, scratch, state, patterns,
    lengths, r, n, ff_bound, pml, cid, g_a, g_b, s_b)."""
    row_b = fixed[1] if rnd == 1 else fixed[2] if rnd == 2 else None
    return ((rnd, bool(last), fixed[0], row_b) + fixed[3:7] + (i,)
            + fixed[7:])


class RoundCompact(K.BatchLauncher):
    """K13a's launcher for one batch: `sharded_step_compact`'s arguments
    but the round, `last` and the step, with the rows of rounds 1 and 2
    apart (row_jump (B, 2), row_run (B, 8); None where no call makes that
    round), checked once here (device, dtype, shape, contiguity), their
    pointers kept in a parameter block; a call launches one round (the
    plain version on the CPU)."""

    entry, kernel = "colbwt_sharded_step_compact", "sharded_step_compact"
    params = staticmethod(round_compact_params)
    ref = staticmethod(sharded_step_compact_ref)

    def __init__(self, row_a, row_jump, row_run, scratch, state, patterns,
                 lengths, r: int, n: int, ff_bound: int, pml, cid, g_a, g_b,
                 s_b):
        dev = patterns.device
        K.require(patterns, "patterns", torch.uint8, dev)
        if patterns.dim() != 2:
            raise ValueError("patterns must be (M, B)")
        M, B = patterns.shape
        for name, t, w in (("row_a", row_a, 8), ("row_jump", row_jump, 2),
                           ("row_run", row_run, 8)):
            if t is None and name != "row_a":
                continue
            K.require(t, name, torch.int32, dev)
            if t.shape != (B, w):
                raise ValueError(f"{name} must have shape ({B}, {w})")
        K.require(scratch, "scratch", torch.int32, dev)
        if scratch.shape != (SCRATCH_ROWS, B):
            raise ValueError(f"scratch must have shape ({SCRATCH_ROWS}, {B})")
        if len(state) != 4:
            raise ValueError("state is (interval, offset, pos, length)")
        for name, t in ((("lengths", lengths), ("g_a", g_a), ("g_b", g_b),
                         ("s_b", s_b))
                        + tuple((f"state[{j}]", x)
                                for j, x in enumerate(state))):
            K.require(t, name, torch.int32, dev)
            if t.shape != (B,):
                raise ValueError(f"{name} must have shape ({B},)")
        for name, t in (("pml", pml), ("cid", cid)):
            K.require(t, name, torch.int32, dev)
            if t.shape != (M, B):
                raise ValueError(f"{name} must have shape ({M}, {B})")
        self._M = M
        super().__init__(dev, (row_a, row_jump, row_run, scratch, state,
                               patterns, lengths, r, n, ff_bound, pml, cid,
                               g_a, g_b, s_b), B)

    def args(self, rnd: int, last: bool, i: int) -> tuple:
        """`sharded_step_compact`'s arguments for this call."""
        return _round_args(self._fixed, rnd, last, i)

    def check_call(self, rnd: int, last: bool, i: int) -> None:
        if not 0 <= i < self._M or rnd not in (1, 2, 3, 4, 5):
            raise ValueError(f"step {i} of {self._M}, round {rnd}")
        if rnd in (1, 2) and self._fixed[rnd] is None:
            raise ValueError(f"round {rnd} needs its rows")

    def per_call(self, rnd: int, last: bool, i: int) -> tuple:
        return rnd, int(last), i


def sharded_step_compact(rnd: int, last: bool, row_a, row_b, scratch, state,
                         patterns, lengths, i: int, r: int, n: int,
                         ff_bound: int, pml, cid, g_a, g_b, s_b) -> None:
    """K13a (replaces colbwt_tpu/parallel/query_sharded.py:54
    _sharded_query, the step of colbwt_tpu/ops/query_xla.py:89
    query_step): gather round `rnd` (`rounds`) of character step i, from the
    summed rows row_a (B, 8) and row_b ((B, 2) jump rows in round 1, (B, 8)
    run rows in round 2).  `patterns` is the batch's (M, B) uint8 columns
    (step i reads row M-1-i).  Carries in `scratch` (9, B) the values that
    a later round reads and no other argument holds (S_CID, S_MATCH,
    S_NOFF, S_NLEN, S_DOFF, S_NPOS: succ and pred stay in g_a and g_b
    after round 1, the destination run in g_a; the last round stores
    none); the last round of the step updates `state` (interval, offset,
    pos, length)
    where i < lengths and writes row M-1-i of the (M, B) int32 planes pml
    and cid.  Writes the next round's global row indices into g_a (run
    rows) and g_b (jump rows with selector s_b, or run rows), all in place.
    One call, checked in full (a `RoundCompact` made and called once); CPU
    tensors take the plain version, CUDA tensors launch the kernel."""
    RoundCompact(row_a, row_b if rnd == 1 else None,
                 row_b if rnd == 2 else None, scratch, state, patterns,
                 lengths, r, n, ff_bound, pml, cid, g_a, g_b, s_b)(
        rnd, last, i)


def _round_scan(gather, launcher, state, patterns, lengths, r: int, n: int,
                ff_bound: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Every character step of a (B, M) batch as gather rounds.
    gather(table, g, s, out) prepares the summed fetch of "soa" run rows or
    "jump" rows (selector s) at g into out, a callable; `launcher` makes
    the round caller (`RoundCompact`, or `_plain_rounds`).  The patterns
    are transposed once to (M, B) columns, the fetches and the rounds
    prepared once, and the (M, B) planes, which the last rounds write
    whole, transposed at the end.  Updates `state` in place; returns (pml,
    cid), each (B, M)."""
    dev = patterns.device
    B, M = patterns.shape
    if B == 0 or M == 0:
        return (torch.zeros((B, M), dtype=torch.int32, device=dev),
                torch.zeros((B, M), dtype=torch.int32, device=dev))
    cols = patterns.t().contiguous()
    pml = torch.empty((M, B), dtype=torch.int32, device=dev)
    cid = torch.empty((M, B), dtype=torch.int32, device=dev)
    scratch = torch.zeros((SCRATCH_ROWS, B), dtype=torch.int32, device=dev)
    g_a, g_b = state[0].clone(), state[0].clone()
    s_b = cols[M - 1].to(torch.int32)
    row_a = torch.empty((B, 8), dtype=torch.int32, device=dev)
    row_jump = torch.empty((B, 2), dtype=torch.int32, device=dev)
    row_run = torch.empty((B, 8), dtype=torch.int32, device=dev)
    fetch_a = gather("soa", g_a, None, row_a)
    fetch_jump = gather("jump", g_b, s_b, row_jump)
    fetch_run = gather("soa", g_b, None, row_run)
    step = launcher(row_a, row_jump, row_run, scratch, state, cols, lengths,
                    r, n, ff_bound, pml, cid, g_a, g_b, s_b)
    seq = rounds(ff_bound)
    for i in range(M):
        for t, rnd in enumerate(seq):
            fetch_a()
            if rnd == 1:
                fetch_jump()
            elif rnd == 2:
                fetch_run()
            step(rnd, t == len(seq) - 1, i)
    return pml.t().contiguous(), cid.t().contiguous()


def _plain_rounds(*fixed):
    """The round caller of the plain version: `RoundCompact`'s arguments,
    each call `sharded_step_compact_ref`."""
    return lambda rnd, last, i: sharded_step_compact_ref(
        *_round_args(fixed, rnd, last, i))


def sharded_scan_compact_ref(soa: list, jump: list, L: int, patterns,
                             lengths, state, r: int, n: int, ff_bound: int
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch K13a chunk scan; same contract as
    `sharded_scan_compact`: the rounds of every step, each the plain fetch
    (the sum over the shards) and the plain round."""
    def gather(table, g, s, out):
        shards, stride = (soa, 0) if table == "soa" else (jump, L)
        return lambda: sharded_fetch_ref(shards, g, s, L, stride, out)

    return _round_scan(gather, _plain_rounds, state, patterns, lengths, r, n,
                       ff_bound)


def sharded_scan_compact(soa: list, jump: list, L: int, patterns, lengths,
                         state, r: int, n: int, ff_bound: int
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """K13a chunk scan (replaces the lax.scan inside shard_map of
    colbwt_tpu/parallel/query_sharded.py:56 _sharded_query, its step
    colbwt_tpu/ops/query_xla.py:89 query_step): all M steps of a (B, M)
    uint8 right-aligned batch in one launch, every shard of the dp row on
    this card.  soa[i] is shard i's (L, 8) int32 run rows (global rows
    [i·L, (i+1)·L)), jump[i] its (σ'·L, 2) jump rows [succ, pred] at c·L +
    local run; a row that no shard owns reads as zeros.  `state`
    (interval, offset, pos, length), each (B,) int32, is updated in place
    where a step lies inside its read (i < lengths); returns (pml, cid),
    each (B, M) int32, 0 past a read's end.  CPU tensors take the plain
    version; CUDA tensors launch the kernel."""
    if patterns.device.type == "cpu":
        return sharded_scan_compact_ref(soa, jump, L, patterns, lengths,
                                        state, r, n, ff_bound)
    dev = patterns.device
    B, M = patterns.shape
    if len(soa) != len(jump) or any(t is None for t in soa + jump):
        raise ValueError("the chunk scan needs every shard on the card")
    soa_tab = shard_pointers(soa, dev, 8)
    jump_tab = shard_pointers(jump, dev, 2)
    K.require(patterns, "patterns", torch.uint8, dev)
    for name, t in ((("lengths", lengths),)
                    + tuple((f"state[{j}]", x) for j, x in enumerate(state))):
        K.require(t, name, torch.int32, dev)
        if t.shape != (B,):
            raise ValueError(f"{name} must have shape ({B},)")
    if len(state) != 4:
        raise ValueError("state is (interval, offset, pos, length)")
    # the kernel writes column-major planes (coalesced stores), transposed
    # here as the JAX scan transposes its stacked steps
    pml = torch.empty((M, B), dtype=torch.int32, device=dev)
    cid = torch.empty((M, B), dtype=torch.int32, device=dev)
    if B and M:
        code = K.on(dev).colbwt_sharded_scan_compact(
            soa_tab.data_ptr(), jump_tab.data_ptr(), len(soa), int(L),
            patterns.data_ptr(), lengths.data_ptr(),
            *(t.data_ptr() for t in state), B, M, int(r), int(n),
            int(ff_bound), pml.data_ptr(), cid.data_ptr(),
            K.stream_handle(dev))
        K.check("sharded_scan_compact", code)
        K.launches["sharded_scan_compact"] += 1
    return pml.t().contiguous(), cid.t().contiguous()


def round_row(mesh: Mesh, tb: dict, d: int, patterns: torch.Tensor,
              lengths: torch.Tensor, state, ff_bound: int
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """The per-round route of `scan_row`: each gather round one fetch a
    card of the row's shards it holds, summed over "ip" (adds across cards,
    all_reduce across ranks), then the round kernel
    `sharded_step_compact`, each prepared once for the batch
    (`Mesh.gatherer`, `RoundCompact`)."""
    L = tb["r_padded"] // mesh.ip

    def gather(table, g, s, out):
        return mesh.gatherer(tb[table], d, L, g, s,
                             stride=0 if s is None else L, out=out)

    return _round_scan(gather, RoundCompact, state, patterns, lengths,
                       tb["r"], tb["n"], ff_bound)


def scan_row(mesh: Mesh, tb: dict, d: int, patterns: torch.Tensor,
             lengths: torch.Tensor, state, ff_bound: int
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """The backward scan of dp row d's (B, M) batch from `state`, updated
    in place.  The route follows where the row's shards lie: all of them on
    the row's device takes the chunk scan `sharded_scan_compact`, one
    launch; shards on other cards or ranks take `round_row`."""
    dev = patterns.device
    cards = mesh.card_shards(tb["soa"], d)
    if len(cards) == 1 and str(cards[0][0]) == str(dev) and all(
            t is not None for t in cards[0][1]):
        (_, jump), = mesh.card_shards(tb["jump"], d)
        return sharded_scan_compact(cards[0][1], jump,
                                    tb["r_padded"] // mesh.ip, patterns,
                                    lengths, state, tb["r"], tb["n"],
                                    ff_bound)
    return round_row(mesh, tb, d, patterns, lengths, state, ff_bound)


def query_row(mesh: Mesh, tb: dict, d: int, patterns: torch.Tensor,
              lengths: torch.Tensor, ff_bound: int
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """The backward scan of dp row d's (B, M) right-aligned batch (uint8
    dense ids on the row's device) against the sharded index `tb`
    (mesh.shard_index).  Returns (pml, cid), each (B, M) int32."""
    dev = patterns.device
    B, M = patterns.shape
    if B == 0 or M == 0:
        return (torch.zeros((B, M), dtype=torch.int32, device=dev),
                torch.zeros((B, M), dtype=torch.int32, device=dev))
    n, r = tb["n"], tb["r"]

    def full(v):
        return torch.full((B,), v, dtype=torch.int32, device=dev)

    # start offset: length[r - 1] - 1, read through the masked gather
    last = mesh.gather(tb["soa"], d, tb["r_padded"] // mesh.ip,
                       torch.full((1,), r - 1, dtype=torch.int32,
                                  device=dev))
    state = (full(r - 1), (last[:, F_LEN] - 1).expand(B).contiguous(),
             full(n - 1), full(0))
    return scan_row(mesh, tb, d, patterns, lengths, state, ff_bound)


def query_batch_sharded(index: ColPmlIndex, patterns: list[bytes],
                        mesh: Mesh | None = None, dp: int | None = None,
                        ip: int = 1, max_len: int | None = None
                        ) -> tuple[list[np.ndarray], list[np.ndarray]]:
    """Host API: encode, shard over the mesh, query, unpad.

    Pads the batch up to a dp multiple with empty reads (masked out)."""
    if index.ff_bound < 1:
        raise ValueError(
            "sharded query needs a run-split index (ColPmlIndex.build with "
            "ff_bound >= 1): the dynamic fast-forward would read local-only "
            "run lengths")
    mesh = resolve_mesh(mesh, dp, ip)
    enc, lens = pad_batch(index, patterns, mesh.dp, max_len)
    tb = shard_index(index, mesh)
    rows = shard_reads(enc, lens, mesh)
    pml, cid = mesh.collect({d: query_row(mesh, tb, d, p, ln, index.ff_bound)
                             for d, (p, ln) in rows.items()})
    return unpad(pml, cid, lens, len(patterns))
