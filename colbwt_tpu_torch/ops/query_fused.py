"""Fused-gather query engine — port of colbwt_tpu/ops/query_fused.py.

The query recurrence (col_pml::_query_pml, include/col_bwt.hpp:498-574)
restructured to K+1 gathers a step: one 32-byte run row (char, col_id,
dest_interval, dest_offset, lf_pos0 = idx[dest] + dest_offset, length), one
32-byte jump row that holds the whole mismatch outcome for (char, run) (the
successor's threshold and the LF-stepped, fast-forwarded successor and
predecessor states), and ff_bound - 1 run lengths for the LF fast-forward of
the match path.  Memory: 32 B a run plus 32 B a (char, run).

The port's run row also carries, in its column 6 (0 in JAX's), the first
fast-forward round's run length, length[clip(dest_interval)]: the length
JAX's first round gathers, which depends only on the run row.  The kernel
and the plain version take it from there, so at ff_bound 2 a step's loads
wait on no other load of the step; rounds 2.. still gather `length`.

`build_fused_tables` is host NumPy, as in JAX (query_fused.py:41-105), and
uploads both row tables through utils/xfer.upload_chunked (K14).  The scan
is K7 in csrc/query_fused.cu (replaces query_fused.py:108
query_batch_fused), with the plain PyTorch version
`query_batch_fused_ref` beside it, which repeats the scan body op for op.
The wrapper runs the plain version only for tensors on the CPU; for a CUDA
tensor it launches the kernel or raises.  The kernel writes column-major
(M, B) planes and the wrapper transposes them on the device, so callers get
(B, M) as before.
"""

from __future__ import annotations

import numpy as np
import torch

from colbwt_tpu_torch.models.index import ColPmlIndex
from colbwt_tpu_torch.models.tensors import to_device
from colbwt_tpu_torch.ops import _kernels as K
from colbwt_tpu_torch.utils.device import resolve_device
from colbwt_tpu_torch.utils.xfer import upload_chunked

NO_STATE = -1


def fused_rows(index: ColPmlIndex) -> tuple[np.ndarray, np.ndarray]:
    """(run_rows (r, 8), jump_rows ((sigma+1)*r, 8)), int32 host arrays
    (query_fused.py:41-95); run_rows[:, 6] is the first fast-forward
    round's length, length[clip(dest_interval)]."""
    if index.wide:
        raise ValueError("n >= 2**31: int32 positions would overflow — "
                         "use ops.query_mega_wide")
    r, n = index.r, index.n
    idx = index.idx.astype(np.int64)
    length = index.length.astype(np.int64)
    di = index.dest_interval.astype(np.int64)
    doff = index.dest_offset.astype(np.int64)
    thr = index.threshold.astype(np.int64)

    run_rows = np.zeros((r, 8), dtype=np.int32)
    run_rows[:, 0] = index.char
    run_rows[:, 1] = index.col_id
    run_rows[:, 2] = di
    run_rows[:, 3] = doff
    run_rows[:, 4] = idx[di] + doff
    run_rows[:, 5] = length
    run_rows[:, 6] = length[np.clip(di, 0, r - 1)]  # jnp.take mode="clip"

    def resolve(start_run: np.ndarray, start_off: np.ndarray, ok: np.ndarray):
        """LF + full fast-forward from (run, offset) -> (interval', off', pos')."""
        sr = np.where(ok, start_run, 0)
        d = di[sr]
        o = doff[sr] + start_off
        pos = idx[d] + o
        out_int = np.searchsorted(idx, pos, side="right") - 1
        out_off = pos - idx[out_int]
        return (np.where(ok, out_int, NO_STATE).astype(np.int32),
                np.where(ok, out_off, 0).astype(np.int32),
                np.where(ok, pos, 0).astype(np.int32))

    jump_rows = np.zeros(((index.sigma + 1) * r, 8), dtype=np.int32)
    for c in range(index.sigma + 1):
        si = index.succ_jump[c].astype(np.int64)
        pi = index.pred_jump[c].astype(np.int64)
        has_succ = si < r
        has_pred = pi >= 0
        block = jump_rows[c * r:(c + 1) * r]
        block[:, 0] = np.where(has_succ, thr[np.minimum(si, r - 1)], n)
        block[:, 1], block[:, 2], block[:, 3] = resolve(
            si, np.zeros(r, dtype=np.int64), has_succ)
        p_run = np.maximum(pi, 0)
        block[:, 4], block[:, 5], block[:, 6] = resolve(
            p_run, length[p_run] - 1, has_pred)
    return run_rows, jump_rows


def build_fused_tables(index: ColPmlIndex, device=None) -> dict:
    """The fused engine's tables on `device` (default cuda): run_rows and
    jump_rows through upload_chunked, the run lengths, n and r."""
    dev = resolve_device(device)
    run_rows, jump_rows = fused_rows(index)
    return {
        "run_rows": upload_chunked(run_rows, dev),
        "jump_rows": upload_chunked(jump_rows, dev),
        "length": to_device(index.length, dev),
        "n": int(index.n),
        "r": int(index.r),
    }


def _take(arr: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    return arr[i.long().clamp(0, arr.shape[0] - 1)]  # jnp.take mode="clip"


def query_batch_fused_ref(ft: dict, patterns: torch.Tensor,
                          lengths: torch.Tensor, ff_bound: int = 4
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch K7: the lax.scan body of query_fused.py:128-172, one
    batched step per column, right to left; the first fast-forward round
    takes its length from the run row's column 6."""
    patterns = patterns.to(torch.int32)
    B, M = patterns.shape
    r, n = ft["r"], ft["n"]
    run_rows, jump_rows, length_arr = (ft["run_rows"], ft["jump_rows"],
                                       ft["length"])
    dev = patterns.device
    interval = torch.full((B,), r - 1, dtype=torch.int32, device=dev)
    offset = (run_rows[r - 1, 5] - 1).expand(B).clone()
    pos = torch.full((B,), n - 1, dtype=torch.int32, device=dev)
    mlen = torch.zeros((B,), dtype=torch.int32, device=dev)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    pml = torch.empty((B, M), dtype=torch.int32, device=dev)
    cid = torch.empty((B, M), dtype=torch.int32, device=dev)
    for i in range(M):
        c = patterns[:, M - 1 - i]
        valid = i < lengths

        rows = _take(run_rows, interval)  # gather 1
        cid_out = rows[:, 1]
        match = rows[:, 0] == c

        jrows = _take(jump_rows, c * r + interval)  # gather 2
        thr = jrows[:, 0]
        use_pred = pos < thr
        has_pred = jrows[:, 4] >= 0
        has_succ = thr < n
        take_pred = ~match & use_pred & has_pred
        take_succ = ~match & ~take_pred & has_succ

        di = rows[:, 2]
        doff = rows[:, 3] + offset
        lf_pos = rows[:, 4] + offset
        for t in range(ff_bound - 1):  # gathers 3..K+1, the first folded
            ln = rows[:, 6] if t == 0 else _take(length_arr, di)
            over = doff >= ln
            di = di + over.to(torch.int32)
            doff = doff - torch.where(over, ln, zero)

        new_interval = torch.where(take_pred, jrows[:, 4],
                                   torch.where(take_succ, jrows[:, 1], di))
        new_offset = torch.where(take_pred, jrows[:, 5],
                                 torch.where(take_succ, jrows[:, 2], doff))
        new_pos = torch.where(take_pred, jrows[:, 6],
                              torch.where(take_succ, jrows[:, 3], lf_pos))
        new_len = torch.where(match, mlen + 1, zero)

        interval = torch.where(valid, new_interval, interval)
        offset = torch.where(valid, new_offset, offset)
        pos = torch.where(valid, new_pos, pos)
        mlen = torch.where(valid, new_len, mlen)
        pml[:, M - 1 - i] = torch.where(valid, new_len, zero)
        cid[:, M - 1 - i] = torch.where(valid, cid_out, zero)
    return pml, cid


def query_batch_fused(ft: dict, patterns: torch.Tensor, lengths: torch.Tensor,
                      ff_bound: int = 4) -> tuple[torch.Tensor, torch.Tensor]:
    """K7 (replaces colbwt_tpu/ops/query_fused.py:108 query_batch_fused):
    (B, M) right-aligned dense-id patterns -> (pml, cid), both (B, M) int32.
    The kernel reads uint8 ids (a dense id is at most sigma <= 255); other
    integer ids are cast on the device.  CPU tensors take the plain
    version; CUDA tensors launch the kernel."""
    if patterns.device.type == "cpu":
        return query_batch_fused_ref(ft, patterns, lengths, ff_bound)
    patterns = patterns.to(torch.uint8).contiguous()
    dev = patterns.device
    B, M = patterns.shape
    r = ft["r"]
    for name in ("run_rows", "jump_rows"):
        K.require(ft[name], name, torch.int32, dev)
        K.require_aligned(ft[name], name, 16)
        if ft[name].ndim != 2 or ft[name].shape[1] != 8:
            raise ValueError(f"{name} must have 8 columns")
    if ft["run_rows"].shape[0] != r or ft["jump_rows"].shape[0] % r:
        raise ValueError("run_rows must have r rows and jump_rows a "
                         "multiple of r")
    K.require(ft["length"], "length", torch.int32, dev)
    K.require(lengths, "lengths", torch.int32, dev)
    if lengths.shape != (B,):
        raise ValueError(f"lengths must have shape ({B},)")
    # column-major planes (coalesced stores), transposed here as the JAX
    # scan transposes its stacked steps
    pml = torch.empty((M, B), dtype=torch.int32, device=dev)
    cid = torch.empty((M, B), dtype=torch.int32, device=dev)
    if B and M:
        code = K.on(dev).colbwt_query_batch_fused(
            ft["run_rows"].data_ptr(), ft["jump_rows"].data_ptr(),
            ft["length"].data_ptr(), r, ft["jump_rows"].shape[0], ft["n"],
            patterns.data_ptr(), lengths.data_ptr(), B, M, int(ff_bound),
            pml.data_ptr(), cid.data_ptr(), K.stream_handle(dev))
        K.check("query_batch_fused", code)
        K.launches["query_batch_fused"] += 1
    return pml.t().contiguous(), cid.t().contiguous()


def query_batch(index: ColPmlIndex, patterns: list[bytes],
                max_len: int | None = None, ft: dict | None = None,
                device=None) -> tuple[list[np.ndarray], list[np.ndarray]]:
    """Host API mirroring query_fused.py:179-195: encode, run on `device`
    (default cuda), unpad."""
    if index.ff_bound < 1:
        raise ValueError("fused engine requires a run-split index "
                         "(ColPmlIndex.build with ff_bound >= 1)")
    dev = resolve_device(device)
    if ft is None:
        ft = build_fused_tables(index, dev)
    enc, lens = index.encode_patterns(patterns, max_len)
    pml, cid = query_batch_fused(ft, to_device(enc, dev, np.uint8),
                                 to_device(lens, dev), ff_bound=index.ff_bound)
    pml = pml.cpu().numpy()
    cid = cid.cpu().numpy()
    M = enc.shape[1]
    return ([pml[b, M - int(lens[b]):] for b in range(len(patterns))],
            [cid[b, M - int(lens[b]):] for b in range(len(patterns))])
