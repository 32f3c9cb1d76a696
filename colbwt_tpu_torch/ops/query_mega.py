"""Mega-row query engine — port of colbwt_tpu/ops/query_mega.py.

Every quantity a query step needs is a function of (pattern char c, current
run i) plus the lane's offset and position, so it is precomputed into one
((sigma+1)·r, 16) int32 table and fetched with one row read at c·r + i
(column layout: colbwt_tpu/ops/query_mega.py:8-17).  The engine needs a
run-split index (ff_bound >= 2): the first LF fast-forward round uses the
row's destination-run length, further rounds read the length array.  It
serves every narrow index the positional tables cannot hold (A^k·n >
2**31 - 1 at k = 1, or over the memory budget).

The table is built on the host with NumPy, as in the JAX package, and then
moved to the device.  One kernel carries the scan, K5 in csrc/query_mega.cu
(replaces query_mega.py:116 query_chunk_mega), with the plain PyTorch
version `query_chunk_mega_ref` beside it; the wide engine
(ops/query_mega_wide.py) shares the plain scan skeleton `scan_ref` and the
batch drivers.  A wrapper runs its plain version only for tensors on the
CPU; for a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import numpy as np
import torch

from colbwt_tpu_torch.models.index import ColPmlIndex
from colbwt_tpu_torch.models.tensors import to_device
from colbwt_tpu_torch.ops import _kernels as K
from colbwt_tpu_torch.ops.query_xla import _gather
from colbwt_tpu_torch.utils.device import resolve_device

NO_STATE = -1
_PML_PACK_LIMIT = 1 << 23


def build_mega_table(index: ColPmlIndex, device=None) -> dict:
    """The mega table of a run-split narrow index on `device` (default
    cuda), with the run lengths, n, r and the last run's length."""
    if index.ff_bound < 2:
        raise ValueError("mega engine requires a run-split index "
                         "(ColPmlIndex.build(tbl, ff_bound=2))")
    if index.wide:
        raise ValueError("n >= 2**31: int32 positions would overflow — "
                         "use ops.query_mega_wide")
    dev = resolve_device(device)
    r, n = index.r, index.n
    char = index.char.astype(np.int64)
    col_id = index.col_id.astype(np.int64)
    idx = index.idx.astype(np.int64)
    length = index.length.astype(np.int64)
    di = index.dest_interval.astype(np.int64)
    doff = index.dest_offset.astype(np.int64)
    thr = index.threshold.astype(np.int64)
    sigma = index.sigma

    lf_pos0 = idx[di] + doff
    dlen0 = length[di]

    def resolve(start_run, start_off, ok):
        sr = np.where(ok, start_run, 0)
        d = di[sr]
        o = doff[sr] + start_off
        pos = idx[d] + o
        out_int = np.searchsorted(idx, pos, side="right") - 1
        out_off = pos - idx[out_int]
        return (np.where(ok, out_int, NO_STATE),
                np.where(ok, out_off, 0),
                np.where(ok, pos, 0))

    mega = np.zeros(((sigma + 1) * r, 16), dtype=np.int32)
    for c in range(sigma + 1):
        blk = mega[c * r:(c + 1) * r]
        blk[:, 0] = (char == c)
        blk[:, 1] = col_id
        blk[:, 2] = di
        blk[:, 3] = doff
        blk[:, 4] = lf_pos0
        blk[:, 5] = dlen0
        si = index.succ_jump[c].astype(np.int64)
        pi = index.pred_jump[c].astype(np.int64)
        has_succ = si < r
        has_pred = pi >= 0
        blk[:, 6] = np.where(has_succ, thr[np.minimum(si, r - 1)], n)
        s_int, s_off, s_pos = resolve(si, np.zeros(r, dtype=np.int64),
                                      has_succ)
        blk[:, 7], blk[:, 8], blk[:, 9] = s_int, s_off, s_pos
        p_run = np.maximum(pi, 0)
        p_int, p_off, p_pos = resolve(p_run, length[p_run] - 1, has_pred)
        blk[:, 10], blk[:, 11], blk[:, 12] = p_int, p_off, p_pos

    return {
        "mega": to_device(mega, dev),
        "length": to_device(length, dev),
        "n": int(n),
        "r": int(r),
        "last_len": int(length[r - 1]),
    }


def initial_state(mt: dict, batch: int):
    """The reference's query start state: bottom of the BWT
    (include/col_bwt.hpp:503-507), as (interval, offset, pos, mlen)."""
    dev = mt["length"].device

    def full(v):
        return torch.full((batch,), v, dtype=torch.int32, device=dev)

    return (full(mt["r"] - 1), full(mt["last_len"] - 1), full(mt["n"] - 1),
            full(0))


def fast_forward(di, doff, dlen0, length, ff_bound: int):
    """LF fast-forward of the plain scans: one round against the row's
    destination-run length dlen0, then ff_bound - 2 rounds gathering
    `length`."""
    over = doff >= dlen0
    di = di + over.to(torch.int32)
    doff = doff - torch.where(over, dlen0, 0)
    for _ in range(ff_bound - 2):
        ln = _gather(length, di)
        over = doff >= ln
        di = di + over.to(torch.int32)
        doff = doff - torch.where(over, ln, 0)
    return di, doff


def scan_ref(step, patterns, lengths, state, step_offset: int, masked: bool,
             packed_out: bool, fresh_state: bool):
    """The plain chunk scan of the mega engines, one batched step per column
    from the right.  `step(state, c)` returns (new_state, cid_out); the last
    state entry is the match length.  Returns ((pml, cid), final_state), or
    ((packed, None), final_state) with packed_out (uint16 when fresh_state
    and M <= 255, as query_mega.py:204-208)."""
    B, M = patterns.shape
    out = torch.empty((B, M), dtype=torch.int32, device=patterns.device)
    cid = torch.empty((B, M), dtype=torch.int32, device=patterns.device)
    for s in range(M):
        col = M - 1 - s
        new, cid_out = step(state, patterns[:, col].to(torch.int32))
        if masked:
            valid = s + step_offset < lengths
            state = tuple(torch.where(valid, a, b) for a, b in zip(new, state))
            out[:, col] = torch.where(valid, new[-1], 0)
            cid[:, col] = torch.where(valid, cid_out, 0)
        else:
            state = new
            out[:, col] = new[-1]
            cid[:, col] = cid_out
    if packed_out:
        packed = (out << 8) | cid
        if fresh_state and M <= 255:
            packed = packed.to(torch.uint16)  # pml < 256 provable
        return (packed, None), state
    return (out, cid), state


def query_chunk_mega_ref(mt: dict, patterns, lengths, state,
                         step_offset: int, ff_bound: int = 2,
                         masked: bool = True, packed_out: bool = False,
                         fresh_state: bool = False):
    """Plain PyTorch K5; same contract as `query_chunk_mega`."""
    r, n = mt["r"], mt["n"]
    mega, length = mt["mega"], mt["length"]

    def step(st, c):
        interval, offset, pos, mlen = st
        rows = _gather(mega, c.long() * r + interval.long())  # one row read
        match = rows[:, 0] == 1
        lf_pos = rows[:, 4] + offset
        di, doff = fast_forward(rows[:, 2], rows[:, 3] + offset, rows[:, 5],
                                length, ff_bound)
        # threshold_step (include/col_bwt.hpp:531-574): pred if pos < thr
        # and one exists; else succ if one exists (thr == n means none)
        thr = rows[:, 6]
        take_pred = ~match & (pos < thr) & (rows[:, 10] >= 0)
        take_succ = ~match & ~take_pred & (thr < n)

        def pick(p, s_, lf):
            return torch.where(take_pred, p, torch.where(take_succ, s_, lf))

        return ((pick(rows[:, 10], rows[:, 7], di),
                 pick(rows[:, 11], rows[:, 8], doff),
                 pick(rows[:, 12], rows[:, 9], lf_pos),
                 torch.where(match, mlen + 1, 0)), rows[:, 1])

    return scan_ref(step, patterns, lengths, state, step_offset, masked,
                    packed_out, fresh_state)


def out_planes(B: int, M: int, packed_out: bool, fresh_state: bool,
               device: torch.device):
    """The scan kernels' output planes and mode (0 two int32 planes, 1 one
    packed int32 plane, 2 one packed uint16 plane), each 16-byte aligned
    for the kernels' vector stores."""
    if packed_out:
        u16 = fresh_state and M <= 255
        out = (torch.empty((B, M), dtype=torch.uint16 if u16 else torch.int32,
                           device=device), None, 2 if u16 else 1)
    else:
        out = (torch.empty((B, M), dtype=torch.int32, device=device),
               torch.empty((B, M), dtype=torch.int32, device=device), 0)
    for name, plane in zip(("out0", "out1"), out[:2]):
        if plane is not None:
            K.require_aligned(plane, name, 16)
    return out


def check_scan_args(patterns, lengths, state) -> None:
    dev = patterns.device
    B = patterns.shape[0]
    K.require(patterns, "patterns", torch.uint8, dev)
    named = [("lengths", lengths)] + [(f"state[{i}]", t)
                                      for i, t in enumerate(state)]
    for name, t in named:
        K.require(t, name, torch.int32, dev)
        if t.shape != (B,):
            raise ValueError(f"{name} must have shape ({B},)")


def query_chunk_mega(mt: dict, patterns, lengths, state, step_offset: int,
                     ff_bound: int = 2, masked: bool = True,
                     packed_out: bool = False, fresh_state: bool = False):
    """K5 (replaces colbwt_tpu/ops/query_mega.py:116 query_chunk_mega): one
    chunk of the backward scan with carried state over (B, M) uint8 dense
    ids.  `lengths` are the full read lengths; step i of the chunk counts
    as step_offset + i.  Returns ((pml, cid), final_state), or ((packed,
    None), final_state) with packed_out, where packed = pml << 8 | cid is
    uint16 when fresh_state (the caller's promise that mlen == 0) and M <=
    255, else int32.  masked=False lets state run on past a lane's end (pad
    columns then hold computed values); masked=True freezes it there and
    zeroes those outputs.  CPU tensors take the plain version; CUDA tensors
    launch the kernel."""
    if patterns.dtype != torch.uint8:
        raise ValueError(f"patterns must be uint8 dense ids, got "
                         f"{patterns.dtype}")
    if patterns.device.type == "cpu":
        return query_chunk_mega_ref(mt, patterns, lengths, state, step_offset,
                                    ff_bound, masked, packed_out, fresh_state)
    dev = patterns.device
    B, M = patterns.shape
    mega, length = mt["mega"], mt["length"]
    K.require(mega, "mega", torch.int32, dev)
    K.require_aligned(mega, "mega", 16)
    K.require(length, "length", torch.int32, dev)
    check_scan_args(patterns, lengths, state)
    out0, out1, mode = out_planes(B, M, packed_out, fresh_state, dev)
    final = tuple(torch.empty(B, dtype=torch.int32, device=dev)
                  for _ in range(4))
    if B:
        code = K.on(dev).colbwt_query_chunk_mega(
            mega.data_ptr(), mega.shape[0], length.data_ptr(), mt["r"],
            mt["n"], patterns.data_ptr(), lengths.data_ptr(),
            *(t.data_ptr() for t in state), int(step_offset), B, M,
            int(ff_bound), int(masked), mode, out0.data_ptr(),
            None if out1 is None else out1.data_ptr(),
            *(t.data_ptr() for t in final), K.stream_handle(dev))
        K.check("query_chunk_mega", code)
        K.launches["query_chunk_mega"] += 1
    return (out0, out1), final


def query_batch_mega(mt: dict, patterns, lengths, ff_bound: int = 2,
                     packed_out: bool = False):
    """Fresh-state scan of a whole right-aligned batch (query_mega.py:212).
    Masked, where JAX's is not: a lane walks only its read's columns, so
    the pad columns hold zeros where JAX's hold the values its walk past
    the read computes; every real column is the same, and the caller
    unpads."""
    (pml, cid), _ = query_chunk_mega(
        mt, patterns, lengths, initial_state(mt, patterns.shape[0]), 0,
        ff_bound=ff_bound, masked=True, packed_out=packed_out,
        fresh_state=True)
    return pml, cid


def run_long_reads(index: ColPmlIndex, patterns: list[bytes], chunk: int,
                   mt: dict, chunk_fn, state) -> tuple[list, list]:
    """Arbitrary-length reads through chunked scans with carried state
    (query_mega.py:225-265): reads are right-aligned to a chunk multiple and
    scanned right to left, chunk by chunk; equal to one scan of the whole
    read.  `chunk_fn` is the engine's chunk scan, `state` its start state."""
    dev = mt["length"].device
    B = len(patterns)
    max_m = max((len(p) for p in patterns), default=1)
    n_chunks = max(1, -(-max_m // chunk))
    M = n_chunks * chunk
    enc, lens = index.encode_patterns(patterns, max_len=M)
    enc_t = to_device(enc, dev, np.uint8)
    lens_t = to_device(lens, dev)
    pml_full = np.zeros((B, M), dtype=np.int32)
    cid_full = np.zeros((B, M), dtype=np.int32)
    # the packed int32 plane halves the download of two planes, but
    # pml << 8 overflows int32 once a match length reaches 2**23, and cids
    # must fit 8 bits
    packed = (M < _PML_PACK_LIMIT
              and int(index.col_id.max(initial=0)) <= 0xFF)
    for j in range(n_chunks):
        lo = M - (j + 1) * chunk
        out, state = chunk_fn(mt, enc_t[:, lo:lo + chunk].contiguous(),
                              lens_t, state, j * chunk,
                              ff_bound=index.ff_bound, packed_out=packed)
        if packed:
            pk = out[0].cpu().numpy()
            pml_full[:, lo:lo + chunk] = pk >> 8
            cid_full[:, lo:lo + chunk] = pk & 0xFF
        else:
            pml_full[:, lo:lo + chunk] = out[0].cpu().numpy()
            cid_full[:, lo:lo + chunk] = out[1].cpu().numpy()
    return ([pml_full[b, M - int(lens[b]):] for b in range(B)],
            [cid_full[b, M - int(lens[b]):] for b in range(B)])


def run_batch(index: ColPmlIndex, patterns: list[bytes],
              max_len: int | None, mt: dict, batch_fn) -> tuple[list, list]:
    """Encode, scan one batch with `batch_fn`, unpad (query_mega.py:268)."""
    dev = mt["length"].device
    enc, lens = index.encode_patterns(patterns, max_len)
    pml, cid = batch_fn(mt, to_device(enc, dev, np.uint8),
                        to_device(lens, dev), ff_bound=index.ff_bound)
    pml = pml.cpu().numpy()
    cid = cid.cpu().numpy()
    M = enc.shape[1]
    return ([pml[b, M - int(lens[b]):] for b in range(len(patterns))],
            [cid[b, M - int(lens[b]):] for b in range(len(patterns))])


def query_long_reads(index: ColPmlIndex, patterns: list[bytes],
                     chunk: int = 2048, mt: dict | None = None, device=None
                     ) -> tuple[list[np.ndarray], list[np.ndarray]]:
    """Chunked carried-state scans for arbitrary-length reads."""
    if mt is None:
        mt = build_mega_table(index, device)
    return run_long_reads(index, patterns, chunk, mt, query_chunk_mega,
                          initial_state(mt, len(patterns)))


def query_batch(index: ColPmlIndex, patterns: list[bytes],
                max_len: int | None = None, mt: dict | None = None,
                device=None) -> tuple[list[np.ndarray], list[np.ndarray]]:
    """Host API: encode, scan on the mega table's device, unpad."""
    if mt is None:
        mt = build_mega_table(index, device)
    return run_batch(index, patterns, max_len, mt, query_batch_mega)
