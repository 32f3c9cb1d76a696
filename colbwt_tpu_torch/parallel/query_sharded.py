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
  summed over "ip" (`Mesh.gather`), then the round kernel
  `sharded_step_compact`.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises.  The engine needs a run-split index (ff_bound >= 1): the unbounded
fast-forward would read run lengths of other shards.
"""

from __future__ import annotations

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
# rows of the per-lane scratch carried between rounds
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
    M = patterns.shape[1]
    a = row_a
    if rnd == 1:
        c = patterns[:, M - 1 - i].to(torch.int32)
        sc[S_CID] = a[:, F_CID]
        sc[S_MATCH] = (a[:, F_CHAR] == c).to(torch.int32)
        sc[S_SI] = row_b[:, 0]
        sc[S_PI] = row_b[:, 1]
        g_a.copy_(row_b[:, 0])
        g_b.copy_(row_b[:, 1])
        return
    if rnd == 2:
        si, pi = sc[S_SI], sc[S_PI]
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
    if rnd == 3:
        di = a[:, F_DI]
        doff = a[:, F_DOFF] + sc[S_NOFF]
    else:
        di, doff = sc[S_DI], sc[S_DOFF]
        if rnd == 4:
            sc[S_NPOS] = a[:, F_IDX] + doff
        if rnd == 5 or ff_bound >= 2:
            ln = a[:, F_LEN]
            over = doff >= ln
            di = di + over.to(torch.int32)
            doff = doff - torch.where(over, ln, 0)
    sc[S_DI] = di
    sc[S_DOFF] = doff
    g_a.copy_(di)
    if not last:
        return
    valid = i < lengths
    nlen = sc[S_NLEN]
    interval.copy_(torch.where(valid, di, interval))
    offset.copy_(torch.where(valid, doff, offset))
    pos.copy_(torch.where(valid, sc[S_NPOS], pos))
    length.copy_(torch.where(valid, nlen, length))
    pml[:, M - 1 - i] = torch.where(valid, nlen, 0)
    cid[:, M - 1 - i] = torch.where(valid, sc[S_CID], 0)
    if i + 1 < M:
        g_a.copy_(interval)
        g_b.copy_(interval)
        s_b.copy_(patterns[:, M - 2 - i].to(torch.int32))


def sharded_step_compact(rnd: int, last: bool, row_a, row_b, scratch, state,
                         patterns, lengths, i: int, r: int, n: int,
                         ff_bound: int, pml, cid, g_a, g_b, s_b) -> None:
    """K13a (replaces colbwt_tpu/parallel/query_sharded.py:54
    _sharded_query, the step of colbwt_tpu/ops/query_xla.py:89
    query_step): gather round `rnd` (`rounds`) of character step i, from the
    summed rows row_a (B, 8) and row_b ((B, 2) jump rows in round 1, (B, 8)
    run rows in round 2).  Carries its values in `scratch` (9, B); the last
    round of the step updates `state` (interval, offset, pos, length) where
    i < lengths and writes column M-1-i of pml and cid.  Writes the next
    round's global row indices into g_a (run rows) and g_b (jump rows with
    selector s_b, or run rows), all in place.  CPU tensors take the plain
    version; CUDA tensors launch the kernel."""
    if patterns.device.type == "cpu":
        return sharded_step_compact_ref(rnd, last, row_a, row_b, scratch,
                                        state, patterns, lengths, i, r, n,
                                        ff_bound, pml, cid, g_a, g_b, s_b)
    dev = patterns.device
    B, M = patterns.shape
    K.require(patterns, "patterns", torch.uint8, dev)
    K.require(row_a, "row_a", torch.int32, dev)
    if row_a.shape != (B, 8):
        raise ValueError(f"row_a must have shape ({B}, 8)")
    if rnd in (1, 2):
        K.require(row_b, "row_b", torch.int32, dev)
        if row_b.shape != (B, 2 if rnd == 1 else 8):
            raise ValueError(f"row_b has shape {tuple(row_b.shape)}")
    K.require(scratch, "scratch", torch.int32, dev)
    if scratch.shape != (SCRATCH_ROWS, B):
        raise ValueError(f"scratch must have shape ({SCRATCH_ROWS}, {B})")
    for name, t in ((("lengths", lengths), ("g_a", g_a), ("g_b", g_b),
                     ("s_b", s_b))
                    + tuple((f"state[{j}]", x) for j, x in enumerate(state))):
        K.require(t, name, torch.int32, dev)
        if t.shape != (B,):
            raise ValueError(f"{name} must have shape ({B},)")
    for name, t in (("pml", pml), ("cid", cid)):
        K.require(t, name, torch.int32, dev)
        if t.shape != (B, M):
            raise ValueError(f"{name} must have shape ({B}, {M})")
    if not 0 <= i < M or rnd not in (1, 2, 3, 4, 5):
        raise ValueError(f"step {i} of {M}, round {rnd}")
    if B:
        code = K.on(dev).colbwt_sharded_step_compact(
            rnd, int(last), row_a.data_ptr(),
            row_b.data_ptr() if rnd in (1, 2) else None, scratch.data_ptr(),
            *(t.data_ptr() for t in state), patterns.data_ptr(),
            lengths.data_ptr(), B, M, int(i), int(r), int(n), int(ff_bound),
            pml.data_ptr(), cid.data_ptr(), g_a.data_ptr(), g_b.data_ptr(),
            s_b.data_ptr(), K.stream_handle(dev))
        K.check("sharded_step_compact", code)
        K.launches["sharded_step_compact"] += 1


def _round_scan(run, jump, step, state, patterns, lengths, r: int, n: int,
                ff_bound: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Every character step of a (B, M) batch as gather rounds: run(g) and
    jump(g, s) return the summed (B, 8) run rows and (B, 2) jump rows, `step`
    is `sharded_step_compact` or its plain version.  Updates `state` in
    place; returns (pml, cid)."""
    dev = patterns.device
    B, M = patterns.shape
    pml = torch.zeros((B, M), dtype=torch.int32, device=dev)
    cid = torch.zeros((B, M), dtype=torch.int32, device=dev)
    if B == 0 or M == 0:
        return pml, cid
    scratch = torch.zeros((SCRATCH_ROWS, B), dtype=torch.int32, device=dev)
    g_a, g_b = state[0].clone(), state[0].clone()
    s_b = patterns[:, M - 1].to(torch.int32)
    seq = rounds(ff_bound)
    for i in range(M):
        for t, rnd in enumerate(seq):
            row_a = run(g_a)
            row_b = (jump(g_b, s_b) if rnd == 1
                     else run(g_b) if rnd == 2 else None)
            step(rnd, t == len(seq) - 1, row_a, row_b, scratch, state,
                 patterns, lengths, i, r, n, ff_bound, pml, cid, g_a, g_b,
                 s_b)
    return pml, cid


def sharded_scan_compact_ref(soa: list, jump: list, L: int, patterns,
                             lengths, state, r: int, n: int, ff_bound: int
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch K13a chunk scan; same contract as
    `sharded_scan_compact`: the rounds of every step, each the plain fetch
    (the sum over the shards) and the plain round."""
    return _round_scan(lambda g: sharded_fetch_ref(soa, g, None, L),
                       lambda g, s: sharded_fetch_ref(jump, g, s, L, L),
                       sharded_step_compact_ref, state, patterns, lengths,
                       r, n, ff_bound)


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
    `sharded_step_compact`."""
    L = tb["r_padded"] // mesh.ip
    return _round_scan(
        lambda g: mesh.gather(tb["soa"], d, L, g),
        lambda g, s: mesh.gather(tb["jump"], d, L, g, s, stride=L),
        sharded_step_compact, state, patterns, lengths, tb["r"], tb["n"],
        ff_bound)


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
