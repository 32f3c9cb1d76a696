"""Compact query engine — port of colbwt_tpu/ops/query_xla.py.

The table-free engine: each step reads the structure-of-arrays index
directly (col_id, char, pred/succ jump rows, threshold, the LF destination)
and fast-forwards over run lengths.  It answers small one-shot queries and
the non-ACGT stragglers of the positional engine when the general T1 does
not fit.

One kernel carries it, K4 in csrc/query_xla.cu (replaces query_xla.py:153
query_batch_device with query_step, lf_fast_forward and _gather_jump), with
the plain PyTorch version `query_batch_device_ref` beside it.  The kernel
reads the 32-byte run rows and [succ, pred] pairs that `index_tensors`
puts on a CUDA device (models/tensors.py compact_rows, jump_pairs); the
plain version reads the index's fields.  The wrapper runs the plain
version only for tensors on the CPU; for a CUDA tensor it launches the
kernel or raises.
"""

from __future__ import annotations

import numpy as np
import torch

from colbwt_tpu_torch.models.index import ColPmlIndex
from colbwt_tpu_torch.models.tensors import index_tensors, to_device
from colbwt_tpu_torch.ops import _kernels as K
from colbwt_tpu_torch.utils.device import resolve_device


def _gather(arr: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    return arr[i.long().clamp(0, arr.shape[0] - 1)]  # jnp.take mode="clip"


def query_batch_device_ref(tb: dict, patterns: torch.Tensor,
                           lengths: torch.Tensor, ff_bound: int = 0
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch K4: the backward scan of a (B, M) right-aligned batch,
    one batched step per character (query_xla.py:89-150)."""
    patterns = patterns.to(torch.int32)
    B, M = patterns.shape
    r, n = tb["r"], tb["n"]
    dev = patterns.device

    def gather(name, i):
        return _gather(tb[name], i)

    def gather_jump(which, c, interval):
        flat = c.long() * r + interval.long()
        return _gather(tb[which].reshape(-1), flat)

    interval = torch.full((B,), r - 1, dtype=torch.int32, device=dev)
    offset = (tb["length"][r - 1] - 1).expand(B).clone()
    pos = torch.full((B,), n - 1, dtype=torch.int32, device=dev)
    length = torch.zeros((B,), dtype=torch.int32, device=dev)
    pml = torch.empty((B, M), dtype=torch.int32, device=dev)
    cid = torch.empty((B, M), dtype=torch.int32, device=dev)
    for i in range(M):
        c = patterns[:, M - 1 - i]
        valid = i < lengths  # right-aligned: step i valid while i < m
        cid_out = gather("col_id", interval)
        match = gather("char", interval) == c

        si = gather_jump("succ_jump", c, interval)
        pi = gather_jump("pred_jump", c, interval)
        has_succ = si < r
        has_pred = pi >= 0
        thr = torch.where(has_succ, gather("threshold", si), n)
        use_pred = (pos < thr) & has_pred
        # no succ and no pred -> keep the current state
        ti = torch.where(use_pred, pi, torch.where(has_succ, si, interval))
        toff = torch.where(use_pred, gather("length", pi) - 1,
                           torch.where(has_succ, 0, offset))

        new_interval = torch.where(match, interval, ti)
        new_offset = torch.where(match, offset, toff)
        new_length = torch.where(match, length + 1, 0)

        # LF step (include/ds/LF_table.hpp:251-268)
        di = gather("dest_interval", new_interval)
        doff = gather("dest_offset", new_interval) + new_offset
        new_pos = gather("idx", di) + doff
        if ff_bound > 0:
            for _ in range(ff_bound - 1):
                ln = gather("length", di)
                over = doff >= ln
                di = di + over.to(torch.int32)
                doff = doff - torch.where(over, ln, 0)
        else:  # until every lane has landed
            while True:
                ln = gather("length", di)
                over = doff >= ln
                if not bool(over.any()):
                    break
                di = di + over.to(torch.int32)
                doff = doff - torch.where(over, ln, 0)

        # frozen lanes (padding) keep their state
        interval = torch.where(valid, di, interval)
        offset = torch.where(valid, doff, offset)
        pos = torch.where(valid, new_pos, pos)
        length = torch.where(valid, new_length, length)
        pml[:, M - 1 - i] = torch.where(valid, new_length, 0)
        cid[:, M - 1 - i] = torch.where(valid, cid_out, 0)
    return pml, cid


def query_batch_device(tb: dict, patterns: torch.Tensor,
                       lengths: torch.Tensor, ff_bound: int = 0
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """K4 (replaces colbwt_tpu/ops/query_xla.py:153 query_batch_device):
    (pml, cid), each (B, M) int32 aligned with `patterns` (dense char ids,
    right-aligned; left-pad columns are 0).  ff_bound = 0 fast-forwards
    until landing; ff_bound = K >= 1 takes K-1 bounded rounds (run-split
    indexes).  CPU tensors take the plain version; CUDA tensors launch the
    kernel over tb["rows"] and tb["pairs"] (`index_tensors` on the card)."""
    patterns = patterns.to(torch.int32).contiguous()
    if patterns.device.type == "cpu":
        return query_batch_device_ref(tb, patterns, lengths, ff_bound)
    dev = patterns.device
    B, M = patterns.shape
    r = tb["r"]
    rows, pairs = tb["rows"], tb["pairs"]
    K.require(rows, "rows", torch.int32, dev)
    K.require_aligned(rows, "rows", 16)
    K.require(pairs, "pairs", torch.int32, dev)
    K.require_aligned(pairs, "pairs", 8)
    if rows.shape != (r, 8) or pairs.dim() != 2 or pairs.shape[1] != 2:
        raise ValueError(f"rows must have shape ({r}, 8), pairs (J, 2)")
    K.require(lengths, "lengths", torch.int32, dev)
    if lengths.shape != (B,):
        raise ValueError(f"lengths must have shape ({B},)")
    pml = torch.empty((B, M), dtype=torch.int32, device=dev)
    cid = torch.empty((B, M), dtype=torch.int32, device=dev)
    if B and M:
        code = K.on(dev).colbwt_query_batch_xla(
            rows.data_ptr(), pairs.data_ptr(), r, pairs.shape[0], tb["n"],
            patterns.data_ptr(), lengths.data_ptr(), B, M, int(ff_bound),
            pml.data_ptr(), cid.data_ptr(), K.stream_handle(dev))
        K.check("query_batch_xla", code)
        K.launches["query_batch_xla"] += 1
    return pml, cid


def query_batch(index: ColPmlIndex, patterns: list[bytes],
                max_len: int | None = None, ff_bound: int | None = None,
                device=None) -> tuple[list[np.ndarray], list[np.ndarray]]:
    """Host API: encode, run on `device` (default cuda), unpad.  ff_bound
    defaults to the index's recorded bound (0 = unbounded)."""
    dev = resolve_device(device)
    tb = index_tensors(index, dev)
    enc, lens = index.encode_patterns(patterns, max_len)
    k = index.ff_bound if ff_bound is None else ff_bound
    pml, cid = query_batch_device(tb, to_device(enc, dev),
                                  to_device(lens, dev), ff_bound=k)
    pml = pml.cpu().numpy()
    cid = cid.cpu().numpy()
    M = enc.shape[1]
    return ([pml[b, M - int(lens[b]):] for b in range(len(patterns))],
            [cid[b, M - int(lens[b]):] for b in range(len(patterns))])
