"""Interval-sharded WIDE mega engine: dp×ip mesh, one sum over "ip" per
step, limb positions — port of colbwt_tpu/parallel/query_sharded_mega_wide.py,
the n >= 2**31 counterpart of parallel/query_sharded_mega.py.

A wide index's full mega table is 64 B × (sigma+1) × r, so it is split in
contiguous row blocks over "ip" and each device holds table/ip.  Each shard
fills its own slice [lo, hi) of the table on its device from K6b char blocks
(ops/query_mega_wide.fill_block): a block inside the slice is written in
place, a block that straddles the slice's edge is filled into an r-row
temporary and only the overlap is copied in; rows past (sigma+1)·r (the ip
padding) stay zero.  Only the r-sized per-run arrays travel to each device,
and the full table never sits on one.  `mega_host=` places a prebuilt table
instead (the JAX package's `build_mega_rows_wide_host`, say).

The scan is parallel/query_sharded_mega.py's `scan_chunk` with the wide
recurrence (positions as two int32 limbs in base 2**30, ordering tests (hi,
lo) lexicographic): one K13c launch a chunk where the row's shards share a
card, else a step loop of the masked gather, one sum over "ip" and the
per-step kernel.  The scan carries explicit state, so reads of any length
stream through in fixed chunks from the right (the -l mode,
src/pml_query.cpp:126-128, distributed).
"""

from __future__ import annotations

import numpy as np
import torch

from colbwt_tpu_torch.models.index import ColPmlIndex
from colbwt_tpu_torch.models.tensors import to_device
from colbwt_tpu_torch.ops import query_mega_wide as QW
from colbwt_tpu_torch.parallel.mesh import (Mesh, pad_batch, resolve_mesh,
                                            shard_reads, unpad)
from colbwt_tpu_torch.parallel import query_sharded_mega as SM

LIMB = QW.LIMB


def _fill_slice(index: ColPmlIndex, lo: int, hi: int, dev: torch.device
                ) -> torch.Tensor:
    """Global rows [lo, hi) of the full wide table, filled on `dev` from the
    char blocks that intersect them (rows past the table stay zero)."""
    r = index.r
    rows = (index.sigma + 1) * r
    out = torch.zeros((hi - lo, QW._WIDTH), dtype=torch.int32, device=dev)
    a = QW.run_arrays(index, dev)
    meta = QW._meta(index)
    for c in range(index.sigma + 1):
        b_lo, b_hi = c * r, (c + 1) * r
        o_lo, o_hi = max(lo, b_lo), min(hi, b_hi, rows)
        if o_lo >= o_hi:
            continue
        args = (c, a, to_device(index.succ_jump[c], dev),
                to_device(index.pred_jump[c], dev), meta["n_lo"],
                meta["n_hi"], index.ff_bound, False)
        if o_lo == b_lo and o_hi == b_hi:
            QW.fill_block(out, *args, row0=b_lo - lo)
        else:  # the block straddles the slice's edge
            tmp = torch.empty((r, QW._WIDTH), dtype=torch.int32, device=dev)
            QW.fill_block(tmp, *args, row0=0)
            out[o_lo - lo:o_hi - lo] = tmp[o_lo - b_lo:o_hi - b_lo]
    return out


def shard_mega_wide(index: ColPmlIndex, mesh: Mesh,
                    mega_host: np.ndarray | None = None) -> dict:
    """Place the wide mega rows on the mesh, ip-sharded over rows: each
    shard's slice is built on its device (`_fill_slice`), or cut from
    `mega_host` when given."""
    QW._check_wide_buildable(index)
    ip = mesh.ip
    rows = (index.sigma + 1) * index.r
    if mega_host is not None:
        mega_host = np.asarray(mega_host)
        assert mega_host.shape[0] == rows
    rows_padded = rows + ((-rows) % ip)
    rl = rows_padded // ip

    def place(i, dev):
        lo, hi = i * rl, (i + 1) * rl
        if mega_host is None:
            return _fill_slice(index, lo, hi, dev)
        out = np.zeros((hi - lo, mega_host.shape[1]), mega_host.dtype)
        take = max(0, min(hi, rows) - lo)
        out[:take] = mega_host[lo:lo + take]
        return to_device(out, dev)

    meta = QW._meta(index)
    return {
        "mega": mesh.shard(place),
        # run lengths replicated (4 B/run) for the fast-forward rounds
        # beyond the precomputed first one
        "length": mesh.replicate(lambda dev: to_device(index.length, dev)),
        "rows_padded": rows_padded,
        **meta,
        "mesh": mesh,
    }


def initial_state_sharded(st: dict, batch: int, mesh: Mesh) -> dict:
    """{d: (interval, offset, pos_lo, pos_hi, mlen)}: each computed dp row's
    share of a `batch`-read start state, on the row's device."""
    bl = batch // mesh.dp

    def full(v, dev):
        return torch.full((bl,), v, dtype=torch.int32, device=dev)

    return {d: tuple(full(v, mesh.row_device(d))
                     for v in (st["r"] - 1, st["last_len"] - 1,
                               st["pos0_lo"], st["pos0_hi"], 0))
            for d in mesh.rows()}


def query_batch_sharded_mega_wide(index: ColPmlIndex, patterns: list[bytes],
                                  mesh: Mesh | None = None,
                                  dp: int | None = None, ip: int = 1,
                                  max_len: int | None = None,
                                  st: dict | None = None
                                  ) -> tuple[list[np.ndarray],
                                             list[np.ndarray]]:
    mesh = resolve_mesh(mesh, dp, ip)
    st = st or shard_mega_wide(index, mesh)
    enc, lens = pad_batch(index, patterns, mesh.dp, max_len)
    state = initial_state_sharded(st, enc.shape[0], mesh)
    pml, cid = mesh.collect({
        d: SM.scan_chunk(mesh, st, d, p, ln, state[d], 0, index.ff_bound,
                      wide=True)
        for d, (p, ln) in shard_reads(enc, lens, mesh).items()})
    return unpad(pml, cid, lens, len(patterns))


def query_long_reads_sharded_mega_wide(index: ColPmlIndex,
                                       patterns: list[bytes],
                                       mesh: Mesh | None = None,
                                       dp: int | None = None, ip: int = 1,
                                       chunk: int = 2048,
                                       st: dict | None = None
                                       ) -> tuple[list[np.ndarray],
                                                  list[np.ndarray]]:
    """Arbitrary-length reads in fixed chunks from the right, with each dp
    row's state carried from chunk to chunk."""
    mesh = resolve_mesh(mesh, dp, ip)
    st = st or shard_mega_wide(index, mesh)
    max_m = max((len(p) for p in patterns), default=1)
    n_chunks = max(1, -(-max_m // chunk))
    M = n_chunks * chunk
    enc, lens = pad_batch(index, patterns, mesh.dp, M)
    B = enc.shape[0]
    state = initial_state_sharded(st, B, mesh)
    pml_full = np.zeros((B, M), dtype=np.int32)
    cid_full = np.zeros((B, M), dtype=np.int32)
    for j in range(n_chunks):
        lo = M - (j + 1) * chunk
        rows = shard_reads(np.ascontiguousarray(enc[:, lo:lo + chunk]), lens,
                           mesh)
        pml, cid = mesh.collect({
            d: SM.scan_chunk(mesh, st, d, p, ln, state[d], j * chunk,
                          index.ff_bound, wide=True)
            for d, (p, ln) in rows.items()})
        pml_full[:, lo:lo + chunk] = pml
        cid_full[:, lo:lo + chunk] = cid
    return unpad(pml_full, cid_full, lens, len(patterns))
