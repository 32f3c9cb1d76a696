"""Wide mega-row query engine — port of colbwt_tpu/ops/query_mega_wide.py.

The mega engine for indexes with n >= 2**31 (the reference's 40-bit
positions, include/ds/LF_table.hpp:36-39).  Position-valued quantities
travel as two int32 limbs in base 2**30 (value = hi·2**30 + lo, lo in
[0, 2**30)) in the tables and in the state tuple (interval, offset, pos_lo,
pos_hi, mlen), exactly as in the JAX package, so either package's tables
and states feed the other's scans.  The scan kernel joins the limbs to
int64 as it reads a row and splits them only where the state leaves it.

Two layouts (column constants below, as query_mega_wide.py:57-78):

- full: one ((sigma+1)·r, 16) table, one 64 B row per step, the match flag
  in bit 8 of the cid column;
- compact: the char-independent columns once in a (r, 8) shared table and
  the 10 threshold_step columns per char ((sigma+1)·r, 10); chosen when the
  full table does not fit the memory budget.

The table is built on the device: only the r-sized per-run arrays (and one
pair of jump rows per char block) are uploaded, and each char block is
written into a table allocated once, so peak device memory is the table plus
O(r) temporaries.  Kernels (each with its plain PyTorch version here):

  K6a query_chunk_mega_wide <- query_mega_wide.py:369        (query_mega.cu)
  K6b fill_block_wide       <- query_mega_wide.py:160, :172 (via :97)
                                                         (query_mega_wide.cu)
  K6c shared_table_wide     <- query_mega_wide.py:183   (query_mega_wide.cu)

(sources in csrc/).

A wrapper runs its plain version only for tensors on the CPU; for a CUDA
tensor it launches the kernel or raises.
"""

from __future__ import annotations

import numpy as np
import torch

from colbwt_tpu_torch.models.index import MAX_WIDE_RUN_LEN, ColPmlIndex
from colbwt_tpu_torch.models.tensors import to_device
from colbwt_tpu_torch.ops import _kernels as K
from colbwt_tpu_torch.ops.query_mega import (check_scan_args, fast_forward,
                                             out_planes, run_batch,
                                             run_long_reads, scan_ref)
from colbwt_tpu_torch.ops.query_xla import _gather
from colbwt_tpu_torch.utils.device import resolve_device
from colbwt_tpu_torch.utils.hbm import resolve_pos_budget

NO_STATE = -1
LIMB = 2**30

# full layout: 16 columns = 64 B rows, match << 8 | cid in column 0
_MC, _DI0, _DOFF0, _LF_LO, _LF_HI, _DLEN0 = range(6)
_THR_LO, _THR_HI = 6, 7
_S_INT, _S_OFF, _S_LO, _S_HI = 8, 9, 10, 11
_P_INT, _P_OFF, _P_LO, _P_HI = 12, 13, 14, 15
_WIDTH = 16

# compact layout: shared (char-independent) columns, padded to 8
_SH_CHAR, _SH_CID, _SH_DI0, _SH_DOFF0, _SH_LF_LO, _SH_LF_HI, _SH_DLEN0 = range(7)
_SH_WIDTH = 8
# compact per-char columns (threshold_step operands only)
_PC_THR_LO, _PC_THR_HI = 0, 1
_PC_S_INT, _PC_S_OFF, _PC_S_LO, _PC_S_HI = 2, 3, 4, 5
_PC_P_INT, _PC_P_OFF, _PC_P_LO, _PC_P_HI = 6, 7, 8, 9
_PC_WIDTH = 10

# the r-sized per-run arrays the table build reads, in kernel order
RUN_FIELDS = ("char", "col_id", "di", "doff", "length", "idx_lo", "idx_hi",
              "thr_lo", "thr_hi")


def _limbs(v: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    v = np.asarray(v, dtype=np.int64)
    return ((v % LIMB).astype(np.int32), (v // LIMB).astype(np.int32))


def wide_table_bytes(index: ColPmlIndex, compact: bool = False) -> int:
    blocks = index.sigma + 1
    r = index.r
    if compact:
        return 4 * r * (_SH_WIDTH + blocks * _PC_WIDTH)
    return 4 * blocks * r * _WIDTH


def choose_compact(index: ColPmlIndex, hbm_budget_bytes: int | None = None,
                   device=None) -> bool:
    """The layout `build_mega_table_wide` picks when not told: compact when
    the full table exceeds the memory budget (default: the device's,
    utils/hbm.resolve_pos_budget)."""
    if hbm_budget_bytes is None:
        hbm_budget_bytes = resolve_pos_budget(0, device)
    return wide_table_bytes(index, compact=False) > hbm_budget_bytes


def _check_wide_buildable(index: ColPmlIndex) -> None:
    if index.ff_bound < 2:
        raise ValueError("mega engine requires a run-split index "
                         "(ColPmlIndex.build(tbl, ff_bound=2))")
    if int(index.length.max(initial=0)) > MAX_WIDE_RUN_LEN:
        raise ValueError("run lengths must be <= 2**29 for limb arithmetic; "
                         "build with ColPmlIndex.build")
    if int(index.col_id.max(initial=0)) > 0xFF:
        # the 64 B row folds match into the cid column's bit 8; ids beyond
        # the reference's 8-bit budget (ID_BITS, common.hpp:47) would
        # collide with the flag
        raise ValueError("wide mega rows require col ids < 256 "
                         "(id_bits > 8 is not supported by this engine)")


def run_arrays(index: ColPmlIndex, device: torch.device) -> dict:
    """The r-sized per-run arrays as int32 tensors (idx and threshold as
    limbs), keyed by RUN_FIELDS."""
    idx_lo, idx_hi = _limbs(index.idx)
    thr_lo, thr_hi = _limbs(index.threshold)
    vals = (index.char, index.col_id, index.dest_interval, index.dest_offset,
            index.length, idx_lo, idx_hi, thr_lo, thr_hi)
    return {f: to_device(v, device) for f, v in zip(RUN_FIELDS, vals)}


def _meta(index: ColPmlIndex) -> dict:
    n_lo, n_hi = _limbs(np.array([index.n]))
    last_lo, last_hi = _limbs(np.array([index.n - 1]))
    return {"n_lo": int(n_lo[0]), "n_hi": int(n_hi[0]),
            "pos0_lo": int(last_lo[0]), "pos0_hi": int(last_hi[0]),
            "r": int(index.r), "last_len": int(index.length[index.r - 1])}


# ---------------------------------------------------------------------------
# K6b: one char block of the table
# ---------------------------------------------------------------------------

def _lf_limbs(a: dict, run: torch.Tensor, off: torch.Tensor):
    """Limbs of idx[di[run]] + off, with the one carry."""
    lo = _gather(a["idx_lo"], run) + off
    carry = (lo >= LIMB).to(torch.int32)
    return lo - carry * LIMB, _gather(a["idx_hi"], run) + carry


def _block_cols_ref(c: int, a: dict, n_lo: int, n_hi: int, ff_bound: int):
    """The 17 column vectors of char block c (query_mega_wide.py:97
    _device_block_cols): jump rows recomputed by cummax and a flipped
    cummin, landing states by the bounded fast-forward."""
    char, di, doff, length = a["char"], a["di"], a["doff"], a["length"]
    r = char.shape[0]
    rows_i = torch.arange(r, dtype=torch.int32, device=char.device)
    is_c = char == c
    lf_lo0, lf_hi0 = _lf_limbs(a, di, doff)
    dlen0 = _gather(length, di)
    # succ = first c-run at or after, pred = last c-run at or before
    s_run = torch.flip(torch.cummin(torch.flip(
        torch.where(is_c, rows_i, r), [0]), 0).values, [0])
    p_run = torch.cummax(torch.where(is_c, rows_i, NO_STATE), 0).values
    has_succ = s_run < r
    has_pred = p_run >= 0
    sr = s_run.clamp(max=r - 1)
    t_lo = torch.where(has_succ, _gather(a["thr_lo"], sr), n_lo)
    t_hi = torch.where(has_succ, _gather(a["thr_hi"], sr), n_hi)

    def resolve(start_run, start_off, ok):
        """Landing state of LF(start_run, start_off); the position limbs
        are invariant under the fast-forward, so they come first."""
        run0 = torch.where(ok, start_run, 0)
        d = _gather(di, run0)
        o = _gather(doff, run0) + start_off
        lo, hi = _lf_limbs(a, d, o)
        d, o = fast_forward(d, o, _gather(length, d), length, ff_bound)
        return (torch.where(ok, d, NO_STATE), torch.where(ok, o, 0),
                torch.where(ok, lo, 0), torch.where(ok, hi, 0))

    pr = p_run.clamp(min=0)
    return ((is_c.to(torch.int32), a["col_id"], di, doff, lf_lo0, lf_hi0,
             dlen0, t_lo, t_hi)
            + resolve(sr, 0, has_succ)
            + resolve(pr, _gather(length, pr) - 1, has_pred))


def fill_block_ref(buf, c: int, a: dict, succ_row, pred_row, n_lo: int,
                   n_hi: int, ff_bound: int, compact: bool, row0: int):
    """Plain PyTorch K6b; same contract as `fill_block`.  succ_row and
    pred_row go unused: this version recomputes them, as JAX does."""
    del succ_row, pred_row
    cols = _block_cols_ref(c, a, n_lo, n_hi, ff_bound)
    if compact:
        block = torch.stack(cols[7:], dim=1)  # threshold_step columns only
    else:
        mc = (cols[0] << 8) | cols[1]  # match bit 8 | cid bits 0..7
        block = torch.stack((mc,) + cols[2:], dim=1)
    r = a["char"].shape[0]
    buf[row0:row0 + r] = block
    return buf


def fill_block(buf, c: int, a: dict, succ_row, pred_row, n_lo: int,
               n_hi: int, ff_bound: int, compact: bool, row0: int):
    """K6b (replaces colbwt_tpu/ops/query_mega_wide.py:160
    _fill_block_full and :172 _fill_block_compact): write char block c of
    the full (16 columns) or compact per-char (10 columns) table into rows
    [row0, row0 + r) of `buf` in place (c·r in the whole table, another
    offset in an ip shard's slice), from the per-run arrays `a` (run_arrays).
    succ_row and pred_row are the index's succ_jump[c] and pred_jump[c],
    which the kernel reads in place of JAX's cummin/cummax pass.  CPU
    tensors take the plain version; CUDA tensors launch the kernel."""
    if buf.device.type == "cpu":
        return fill_block_ref(buf, c, a, succ_row, pred_row, n_lo, n_hi,
                              ff_bound, compact, row0)
    dev = buf.device
    r = a["char"].shape[0]
    width = _PC_WIDTH if compact else _WIDTH
    K.require(buf, "buf", torch.int32, dev)
    K.require_aligned(buf, "buf", 16)
    if (buf.shape[1:] != (width,) or c < 0 or row0 < 0
            or row0 + r > buf.shape[0]):
        raise ValueError(f"block {c} of r={r} rows at row {row0} does not "
                         f"fit buf {tuple(buf.shape)} (width {width})")
    named = [(f, a[f]) for f in RUN_FIELDS] + [("succ_row", succ_row),
                                               ("pred_row", pred_row)]
    for name, t in named:
        K.require(t, name, torch.int32, dev)
        if t.shape != (r,):
            raise ValueError(f"{name} must have shape ({r},)")
    code = K.on(dev).colbwt_fill_block_wide(
        buf.data_ptr(), int(compact), int(c), int(row0),
        *(t.data_ptr() for _, t in named), r, int(n_lo), int(n_hi),
        int(ff_bound), K.stream_handle(dev))
    K.check("fill_block_wide", code)
    K.launches["fill_block_wide"] += 1
    return buf


# ---------------------------------------------------------------------------
# K6c: the compact layout's shared table
# ---------------------------------------------------------------------------

def shared_table_ref(a: dict) -> torch.Tensor:
    """Plain PyTorch K6c; same contract as `shared_table`."""
    lf_lo0, lf_hi0 = _lf_limbs(a, a["di"], a["doff"])
    return torch.stack([a["char"], a["col_id"], a["di"], a["doff"], lf_lo0,
                        lf_hi0, _gather(a["length"], a["di"]),
                        torch.zeros_like(a["char"])], dim=1)


def shared_table(a: dict) -> torch.Tensor:
    """K6c (replaces colbwt_tpu/ops/query_mega_wide.py:183 _shared_table):
    the compact layout's (r, 8) char-independent rows [char, cid, di0,
    doff0, lf_lo, lf_hi, dlen0, 0].  CPU tensors take the plain version;
    CUDA tensors launch the kernel."""
    dev = a["char"].device
    if dev.type == "cpu":
        return shared_table_ref(a)
    r = a["char"].shape[0]
    fields = RUN_FIELDS[:7]
    for f in fields:
        K.require(a[f], f, torch.int32, dev)
        if a[f].shape != (r,):
            raise ValueError(f"{f} must have shape ({r},)")
    out = torch.empty((r, _SH_WIDTH), dtype=torch.int32, device=dev)
    code = K.on(dev).colbwt_shared_table_wide(
        out.data_ptr(), *(a[f].data_ptr() for f in fields), r,
        K.stream_handle(dev))
    K.check("shared_table_wide", code)
    K.launches["shared_table_wide"] += 1
    return out


def build_mega_table_wide(index: ColPmlIndex, compact: bool | None = None,
                          hbm_budget_bytes: int | None = None,
                          device=None) -> dict:
    """Assemble the wide mega table on `device` (default cuda).
    compact=None picks the full layout when it fits the memory budget
    (utils/hbm.resolve_pos_budget), else the compact one."""
    _check_wide_buildable(index)
    dev = resolve_device(device)
    if compact is None:
        compact = choose_compact(index, hbm_budget_bytes, dev)
    r = index.r
    a = run_arrays(index, dev)
    meta = _meta(index)
    # allocated once and filled block by block: no concatenation, so peak
    # memory is the table plus O(r) temporaries
    buf = torch.empty(((index.sigma + 1) * r,
                       _PC_WIDTH if compact else _WIDTH),
                      dtype=torch.int32, device=dev)
    for c in range(index.sigma + 1):
        fill_block(buf, c, a, to_device(index.succ_jump[c], dev),
                   to_device(index.pred_jump[c], dev), meta["n_lo"],
                   meta["n_hi"], index.ff_bound, compact, c * r)
    out = ({"shared": shared_table(a), "percha": buf} if compact
           else {"mega": buf})
    out["length"] = a["length"]
    out.update(meta)
    return out


# ---------------------------------------------------------------------------
# K6a: the scan
# ---------------------------------------------------------------------------

def initial_state_wide(mt: dict, batch: int):
    """Query start state (include/col_bwt.hpp:503-507): bottom of the BWT,
    pos = n - 1 as limbs; (interval, offset, pos_lo, pos_hi, mlen)."""
    dev = mt["length"].device

    def full(v):
        return torch.full((batch,), v, dtype=torch.int32, device=dev)

    return (full(mt["r"] - 1), full(mt["last_len"] - 1), full(mt["pos0_lo"]),
            full(mt["pos0_hi"]), full(0))


def _lt(a_hi, a_lo, b_hi, b_lo):
    """(a_hi, a_lo) < (b_hi, b_lo) lexicographic: value order for limbs."""
    return (a_hi < b_hi) | ((a_hi == b_hi) & (a_lo < b_lo))


def _read_rows(mt: dict, c: torch.Tensor, interval: torch.Tensor):
    """The step's operands from either layout: (match, cid, di0, doff0,
    lf_lo, lf_hi, dlen0, thr_lo, thr_hi, s_int, s_off, s_lo, s_hi, p_int,
    p_off, p_lo, p_hi)."""
    flat = c.long() * mt["r"] + interval.long()
    if "shared" in mt:
        sh = _gather(mt["shared"], interval)
        pc = _gather(mt["percha"], flat)
        return ((sh[:, _SH_CHAR] == c,)
                + tuple(sh[:, j] for j in range(_SH_CID, _SH_DLEN0 + 1))
                + tuple(pc[:, j] for j in range(_PC_WIDTH)))
    rows = _gather(mt["mega"], flat)  # one 64 B row
    mc = rows[:, _MC]
    return (((mc >> 8) == 1, mc & 0xFF)
            + tuple(rows[:, j] for j in range(_DI0, _WIDTH)))


def query_chunk_mega_wide_ref(mt: dict, patterns, lengths, state,
                              step_offset: int, ff_bound: int = 2,
                              masked: bool = True, packed_out: bool = False,
                              fresh_state: bool = False):
    """Plain PyTorch K6a, in limb arithmetic as the JAX program; same
    contract as `query_chunk_mega_wide`."""
    n_lo, n_hi = mt["n_lo"], mt["n_hi"]

    def step(st, c):
        interval, offset, pos_lo, pos_hi, mlen = st
        (match, cid_out, di0, doff0, lf_lo_b, lf_hi_b, dlen0, thr_lo, thr_hi,
         s_int, s_off, s_lo, s_hi, p_int, p_off, p_lo, p_hi) = _read_rows(
             mt, c, interval)
        # match / no-reposition path: LF + fast-forward, one carry
        lf_lo = lf_lo_b + offset
        carry = (lf_lo >= LIMB).to(torch.int32)
        lf_lo = lf_lo - carry * LIMB
        lf_hi = lf_hi_b + carry
        di, doff = fast_forward(di0, doff0 + offset, dlen0, mt["length"],
                                ff_bound)
        # threshold_step (include/col_bwt.hpp:531-574)
        take_pred = (~match & _lt(pos_hi, pos_lo, thr_hi, thr_lo)
                     & (p_int >= 0))
        take_succ = ~match & ~take_pred & _lt(thr_hi, thr_lo, n_hi, n_lo)

        def pick(p, s_, lf):
            return torch.where(take_pred, p, torch.where(take_succ, s_, lf))

        return ((pick(p_int, s_int, di), pick(p_off, s_off, doff),
                 pick(p_lo, s_lo, lf_lo), pick(p_hi, s_hi, lf_hi),
                 torch.where(match, mlen + 1, 0)), cid_out)

    return scan_ref(step, patterns, lengths, state, step_offset, masked,
                    packed_out, fresh_state)


def query_chunk_mega_wide(mt: dict, patterns, lengths, state,
                          step_offset: int, ff_bound: int = 2,
                          masked: bool = True, packed_out: bool = False,
                          fresh_state: bool = False):
    """K6a (replaces colbwt_tpu/ops/query_mega_wide.py:369
    query_chunk_mega_wide): one chunk of the backward scan over (B, M)
    uint8 dense ids with the carried state (interval, offset, pos_lo,
    pos_hi, mlen), on either table layout.  Outputs and the meaning of
    masked, packed_out and fresh_state are those of
    ops/query_mega.query_chunk_mega.  CPU tensors take the plain version;
    CUDA tensors launch the kernel."""
    if patterns.dtype != torch.uint8:
        raise ValueError(f"patterns must be uint8 dense ids, got "
                         f"{patterns.dtype}")
    if patterns.device.type == "cpu":
        return query_chunk_mega_wide_ref(mt, patterns, lengths, state,
                                         step_offset, ff_bound, masked,
                                         packed_out, fresh_state)
    dev = patterns.device
    B, M = patterns.shape
    compact = "shared" in mt
    table = mt["percha"] if compact else mt["mega"]
    K.require(table, "table", torch.int32, dev)
    K.require_aligned(table, "table", 8 if compact else 16)
    if compact:
        K.require(mt["shared"], "shared", torch.int32, dev)
        K.require_aligned(mt["shared"], "shared", 16)
    K.require(mt["length"], "length", torch.int32, dev)
    check_scan_args(patterns, lengths, state)
    out0, out1, mode = out_planes(B, M, packed_out, fresh_state, dev)
    final = tuple(torch.empty(B, dtype=torch.int32, device=dev)
                  for _ in range(5))
    if B:
        code = K.on(dev).colbwt_query_chunk_mega_wide(
            int(compact), table.data_ptr(), table.shape[0],
            mt["shared"].data_ptr() if compact else None,
            mt["length"].data_ptr(), mt["r"], mt["n_hi"] * LIMB + mt["n_lo"],
            patterns.data_ptr(), lengths.data_ptr(),
            *(t.data_ptr() for t in state), int(step_offset), B, M,
            int(ff_bound), int(masked), mode, out0.data_ptr(),
            None if out1 is None else out1.data_ptr(),
            *(t.data_ptr() for t in final), K.stream_handle(dev))
        K.check("query_chunk_mega_wide", code)
        K.launches["query_chunk_mega_wide"] += 1
    return (out0, out1), final


def query_batch_mega_wide(mt: dict, patterns, lengths, ff_bound: int = 2,
                          packed_out: bool = False):
    """Fresh-state scan of a whole right-aligned batch
    (query_mega_wide.py:486), masked as ops/query_mega.query_batch_mega's:
    pad columns zeros, every real column JAX's."""
    (pml, cid), _ = query_chunk_mega_wide(
        mt, patterns, lengths, initial_state_wide(mt, patterns.shape[0]), 0,
        ff_bound=ff_bound, masked=True, packed_out=packed_out,
        fresh_state=True)
    return pml, cid


def query_long_reads(index: ColPmlIndex, patterns: list[bytes],
                     chunk: int = 2048, mt: dict | None = None, device=None
                     ) -> tuple[list[np.ndarray], list[np.ndarray]]:
    """Chunked carried-state scans for arbitrary-length reads (wide)."""
    if mt is None:
        mt = build_mega_table_wide(index, device=device)
    return run_long_reads(index, patterns, chunk, mt, query_chunk_mega_wide,
                          initial_state_wide(mt, len(patterns)))


def query_batch(index: ColPmlIndex, patterns: list[bytes],
                max_len: int | None = None, mt: dict | None = None,
                device=None) -> tuple[list[np.ndarray], list[np.ndarray]]:
    """Host API: encode, scan on the wide table's device, unpad."""
    if mt is None:
        mt = build_mega_table_wide(index, device=device)
    return run_batch(index, patterns, max_len, mt, query_batch_mega_wide)
