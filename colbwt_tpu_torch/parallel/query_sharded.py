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

K13a `sharded_step_compact` (csrc/query_sharded.cu) carries the rounds,
with the plain PyTorch version `sharded_step_compact_ref` beside it.  A CPU
tensor takes the plain version; a CUDA tensor launches the kernel or
raises.  The engine needs a run-split index (ff_bound >= 1): the unbounded
fast-forward would read run lengths of other shards.
"""

from __future__ import annotations

import numpy as np
import torch

from colbwt_tpu_torch.models.index import ColPmlIndex
from colbwt_tpu_torch.ops import _kernels as K
from colbwt_tpu_torch.parallel.mesh import (Mesh, pad_batch, resolve_mesh,
                                            shard_index, shard_reads, unpad)

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


def query_row(mesh: Mesh, tb: dict, d: int, patterns: torch.Tensor,
              lengths: torch.Tensor, ff_bound: int
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """The backward scan of dp row d's (B, M) right-aligned batch (uint8
    dense ids on the row's device) against the sharded index `tb`
    (mesh.shard_index).  Returns (pml, cid), each (B, M) int32."""
    dev = patterns.device
    B, M = patterns.shape
    n, r = tb["n"], tb["r"]
    L = tb["r_padded"] // mesh.ip
    soa, jump = tb["soa"], tb["jump"]
    pml = torch.zeros((B, M), dtype=torch.int32, device=dev)
    cid = torch.zeros((B, M), dtype=torch.int32, device=dev)
    if B == 0 or M == 0:
        return pml, cid

    def full(v):
        return torch.full((B,), v, dtype=torch.int32, device=dev)

    # start offset: length[r - 1] - 1, read through the masked gather
    last = mesh.gather(soa, d, L, torch.full((1,), r - 1, dtype=torch.int32,
                                             device=dev))
    state = (full(r - 1), (last[:, F_LEN] - 1).expand(B).contiguous(),
             full(n - 1), full(0))
    scratch = torch.zeros((SCRATCH_ROWS, B), dtype=torch.int32, device=dev)
    g_a, g_b = full(r - 1), full(r - 1)
    s_b = patterns[:, M - 1].to(torch.int32)
    seq = rounds(ff_bound)
    for i in range(M):
        for t, rnd in enumerate(seq):
            row_a = mesh.gather(soa, d, L, g_a)
            row_b = (mesh.gather(jump, d, L, g_b, s_b, stride=L) if rnd == 1
                     else mesh.gather(soa, d, L, g_b) if rnd == 2 else None)
            sharded_step_compact(rnd, t == len(seq) - 1, row_a, row_b,
                                 scratch, state, patterns, lengths, i, r, n,
                                 ff_bound, pml, cid, g_a, g_b, s_b)
    return pml, cid


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
