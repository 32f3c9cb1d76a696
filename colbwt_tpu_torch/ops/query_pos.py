"""Positional-automaton query engine — port of colbwt_tpu/ops/query_pos.py.

The query step is a pure function of (pattern char c, rank position pos),
so the engine tabulates it once per char (T1) and composes k-step tables
(T_k, k <= 4) by repeated squaring; one table row then advances a read k
characters with one gather.  The row layout is the JAX package's
(query_pos.py:24-31): word0 holds the landed position in its low 32-k bits
and the k match flags above it, word1 holds the k col ids, one per byte, in
processing order.

Three kernels carry it, each a CUDA C++ kernel in csrc/query_pos.cu with a
plain PyTorch version here that mirrors the JAX code:

  K1 build_t1_chunk   <- _build_t1_chunk  (query_pos.py:93)
  K2 compose_tables   <- _compose_tables  (query_pos.py:153)
  K3 query_chunk_pos  <- query_chunk_pos  (query_pos.py:309)

A wrapper runs its plain version only for tensors on the CPU; for a CUDA
tensor it launches the kernel or raises.  Buffers are updated in place
where the JAX code donated them.
"""

from __future__ import annotations

import numpy as np
import torch

from colbwt_tpu_torch.models.index import ColPmlIndex
from colbwt_tpu_torch.models.tensors import to_device
from colbwt_tpu_torch.ops import _kernels as K
from colbwt_tpu_torch.utils.device import resolve_device

INT32_MAX = 2**31 - 1
_PML_PACK_LIMIT = 1 << 23
MAX_K = 4  # 4 cid bytes fill word1
# T1 uses the k=1 layout (match flag at bit 31); composition repacks at the
# target k's layout
T1_POS_BITS = 31
# T1 positions filled per K1 launch (the JAX package's chunk)
_T1_CHUNK = 1 << 25


def pos_bits(k: int) -> int:
    return 32 - k


def pos_mask(k: int) -> int:
    return (1 << pos_bits(k)) - 1


def fits(index: ColPmlIndex, k: int, A_key: int) -> bool:
    """int32 gather indices AND the position fits word0's low 32-k bits."""
    return ((A_key ** k) * index.n <= INT32_MAX
            and index.n <= (1 << pos_bits(k)))


def choose_k(index: ColPmlIndex, hbm_budget_bytes: int = 10 << 30,
             alphabet: bytes | None = None) -> int:
    """Largest k <= 4 whose table fits the memory budget, whose gather
    indices fit int32 and whose positions fit 32-k bits."""
    if index.wide:
        return 0
    A = len(alphabet) if alphabet is not None else index.sigma + 1
    best = 0
    for k in range(1, MAX_K + 1):
        if not fits(index, k, A):
            break
        if (A ** k) * index.n * 8 > hbm_budget_bytes:
            break
        best = k
    return best


def keeps_general_t1(index: ColPmlIndex, k: int, alphabet: bytes | None,
                     hbm_budget_bytes: int) -> bool:
    """Whether `build_pos_tables` keeps the general k=1 T1 beside a
    restricted-alphabet table: it fits int32 and, with the k-step table,
    the budget.  A table over every char (`alphabet` None) needs none."""
    A_full = index.sigma + 1
    return (alphabet is not None and fits(index, 1, A_full)
            and (len(alphabet) ** k + A_full) * index.n * 8
            <= hbm_budget_bytes)


# ---------------------------------------------------------------------------
# K1: the one-step table T1
# ---------------------------------------------------------------------------

def build_t1_chunk_ref(buf, char, idx_pad, length, lf_pos0, threshold,
                       pred_row, succ_row, col_id, c: int, row0: int, s: int,
                       n: int, C: int) -> torch.Tensor:
    """Plain PyTorch K1: fill T1 rows [row0, row0+C) — positions [s, s+C)
    for key char c — of `buf` in place with [new_pos | match<<31, col_id].
    Run ids come from a scatter-max + running max over the run starts that
    fall inside the chunk, as in the JAX code."""
    dev = buf.device
    r = char.shape[0]
    steps = torch.arange(C, dtype=torch.int32, device=dev)
    pos = steps + s
    lo = torch.searchsorted(idx_pad, pos[:1], right=True) - 1  # (1,) int64
    win = idx_pad[lo + 1 + steps.long()]
    off = win - s
    inside = (off >= 0) & (off < C)
    marks = torch.zeros(C, dtype=torch.int32, device=dev).scatter_reduce(
        0, off.clamp(0, C - 1).long(),
        torch.where(inside, steps + 1, 0), reduce="amax")
    run = lo + torch.cummax(marks, 0).values.long()
    offset = pos - idx_pad[run]
    lf_match = lf_pos0[run] + offset  # LF needs no fast-forward in pos space

    match = char[run] == c
    si = succ_row[run]
    pi = pred_row[run]
    has_succ = si < r
    has_pred = pi >= 0
    sic = si.clamp(max=r - 1).long()
    thr = torch.where(has_succ, threshold[sic], n)
    succ_pos = lf_pos0[sic]
    pic = pi.clamp(min=0).long()
    pred_pos = lf_pos0[pic] + length[pic] - 1
    # threshold_step priority (include/col_bwt.hpp:531-574): pred iff
    # pos < thr and a pred exists; else succ; else LF from the same state
    take_pred = (pos < thr) & has_pred
    take_succ = ~take_pred & has_succ
    repos = torch.where(take_pred, pred_pos,
                        torch.where(take_succ, succ_pos, lf_match))
    new_pos = torch.where(match, lf_match, repos)
    buf[row0:row0 + C, 0] = new_pos | (match.to(torch.int32) << T1_POS_BITS)
    buf[row0:row0 + C, 1] = col_id[run]
    return buf


def build_t1_chunk(buf, char, idx_pad, length, lf_pos0, threshold, pred_row,
                   succ_row, col_id, c: int, row0: int, s: int, n: int,
                   C: int) -> torch.Tensor:
    """K1 (replaces colbwt_tpu/ops/query_pos.py:93 _build_t1_chunk): fill
    T1 rows [row0, row0+C) of `buf` in place.  CPU tensors take the plain
    version; CUDA tensors launch the kernel."""
    if buf.device.type == "cpu":
        return build_t1_chunk_ref(buf, char, idx_pad, length, lf_pos0,
                                  threshold, pred_row, succ_row, col_id, c,
                                  row0, s, n, C)
    dev = buf.device
    args = {"buf": buf, "char": char, "idx_pad": idx_pad, "length": length,
            "lf_pos0": lf_pos0, "threshold": threshold,
            "pred_row": pred_row, "succ_row": succ_row, "col_id": col_id}
    for name, t in args.items():
        K.require(t, name, torch.int32, dev)
    K.require_aligned(buf, "buf", 8)  # one 8-byte store a row
    r = char.shape[0]
    if not (0 <= s and s + C <= n and 0 <= row0
            and row0 + C <= buf.shape[0] and idx_pad.shape[0] >= r):
        raise ValueError(f"T1 chunk out of range: s={s} C={C} n={n} "
                         f"row0={row0} rows={buf.shape[0]}")
    code = K.on(dev).colbwt_build_t1_chunk(
        *(t.data_ptr() for t in args.values()), r, int(c), int(row0),
        int(s), int(n), int(C), K.stream_handle(dev))
    K.check("build_t1_chunk", code)
    K.launches["build_t1_chunk"] += 1
    return buf


def t1_inputs(index: ColPmlIndex, C: int, device: torch.device) -> dict:
    """The r-sized arrays K1 reads, on `device`; idx is padded with C+1
    trailing n values (the chunk window of the plain version)."""
    n = index.n
    di = index.dest_interval.astype(np.int64)
    lf_pos0 = (index.idx.astype(np.int64)[di]
               + index.dest_offset.astype(np.int64))
    return {
        "char": to_device(index.char, device),
        "idx_pad": to_device(np.concatenate([
            index.idx.astype(np.int32), np.full(C + 1, n, np.int32)]),
            device),
        "length": to_device(index.length, device),
        "lf_pos0": to_device(lf_pos0, device),
        "threshold": to_device(index.threshold, device),
        "col_id": to_device(index.col_id, device),
    }


def build_t1(index: ColPmlIndex, chars, arrays: dict, C: int
             ) -> torch.Tensor:
    """T1 for the key chars `chars` (dense ids): (len(chars)·n, 2) int32,
    filled C positions per K1 launch.  The tail chunk overlaps the one
    before it (s = n - C); its writes are idempotent."""
    n = index.n
    dev = arrays["char"].device
    buf = torch.empty((len(chars) * n, 2), dtype=torch.int32, device=dev)
    for q, c in enumerate(chars):
        pred_row = to_device(index.pred_jump[int(c)], dev)
        succ_row = to_device(index.succ_jump[int(c)], dev)
        for s in range(0, n, C):
            s = min(s, n - C)
            build_t1_chunk(buf, arrays["char"], arrays["idx_pad"],
                           arrays["length"], arrays["lf_pos0"],
                           arrays["threshold"], pred_row, succ_row,
                           arrays["col_id"], int(c), q * n + s, s, n, C)
    return buf


# ---------------------------------------------------------------------------
# K2: table composition
# ---------------------------------------------------------------------------

def compose_tables_ref(ta: torch.Tensor, tb: torch.Tensor, n: int, A: int,
                       ka: int, kb: int) -> torch.Tensor:
    """Plain PyTorch K2: T_{ka+kb}[key][pos] — T_ka's high-digit block,
    then T_kb's low-digit block from the landed position; one chained
    gather per element.  T_ka's match bits and col ids stay in the low
    slots (the first processed chars are the key's high digits)."""
    k = ka + kb
    pb, pba, pbb = pos_bits(k), pos_bits(ka), pos_bits(kb)
    maska, maskb = pos_mask(ka), pos_mask(kb)
    mbits_a, mbits_b = (1 << ka) - 1, (1 << kb) - 1
    out = torch.empty((A ** k * n, 2), dtype=torch.int32, device=ta.device)
    for key in range(A ** k):
        key_hi, key_lo = divmod(key, A ** kb)
        blk_a = ta[key_hi * n:(key_hi + 1) * n]
        pos_a = blk_a[:, 0] & maska
        rows_b = tb[(key_lo * n + pos_a.long()).clamp(0, tb.shape[0] - 1)]
        ma = (blk_a[:, 0] >> pba) & mbits_a
        mb = (rows_b[:, 0] >> pbb) & mbits_b
        out[key * n:(key + 1) * n, 0] = ((rows_b[:, 0] & maskb)
                                         | (((mb << ka) | ma) << pb))
        out[key * n:(key + 1) * n, 1] = (
            (blk_a[:, 1] & ((1 << (8 * ka)) - 1)) | (rows_b[:, 1] << (8 * ka)))
    return out


def compose_tables(ta: torch.Tensor, tb: torch.Tensor, n: int, A: int,
                   ka: int, kb: int) -> torch.Tensor:
    """K2 (replaces colbwt_tpu/ops/query_pos.py:153 _compose_tables):
    returns the (A**(ka+kb)·n, 2) int32 table.  CPU tensors take the plain
    version; CUDA tensors launch the kernel."""
    if ta.device.type == "cpu":
        return compose_tables_ref(ta, tb, n, A, ka, kb)
    dev = ta.device
    for name, t in (("ta", ta), ("tb", tb)):
        K.require(t, name, torch.int32, dev)
        K.require_aligned(t, name, 8)  # read as 8-byte rows
    if ta.shape[0] < A ** ka * n or tb.shape[0] < A ** kb * n:
        raise ValueError(f"ta/tb have {ta.shape[0]}/{tb.shape[0]} rows, "
                         f"need {A ** ka * n}/{A ** kb * n}")
    out = torch.empty((A ** (ka + kb) * n, 2), dtype=torch.int32, device=dev)
    code = K.on(dev).colbwt_compose_tables(
        out.data_ptr(), ta.data_ptr(), tb.data_ptr(), tb.shape[0], int(n),
        int(A), ka, kb, K.stream_handle(dev))
    K.check("compose_tables", code)
    K.launches["compose_tables"] += 1
    return out


def build_pos_tables(index: ColPmlIndex, k: int | None = None,
                     hbm_budget_bytes: int = 10 << 30,
                     alphabet: bytes | None = None, device=None,
                     t1_chunk: int = _T1_CHUNK) -> dict:
    """Build the k-step tables on `device` (default cuda).  With
    `alphabet`, keys range over those bytes only and the general T1 is kept
    for reads containing other bytes when it fits the budget."""
    dev = resolve_device(device)
    if k is None:
        k = choose_k(index, hbm_budget_bytes, alphabet)
        if k == 0:
            raise ValueError("no k fits the memory budget; use "
                             "ops.query_mega")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k must be in [1, {MAX_K}]")
    A_full = index.sigma + 1
    n = index.n

    if alphabet is not None:
        digit_dense = index.char_map[np.frombuffer(alphabet, dtype=np.uint8)]
        if np.unique(digit_dense).size != digit_dense.size:
            raise ValueError("alphabet bytes collide in the dense char map")
        A_key = len(alphabet)
    else:
        digit_dense = np.arange(A_full, dtype=np.int32)
        A_key = A_full
    if index.wide or not fits(index, k, A_key):
        raise ValueError(
            f"positional tables need A_key**k * n <= 2**31 and n <= "
            f"2**(32-k) (A_key={A_key}, k={k}, n={n})")

    C = min(n, t1_chunk)
    arrays = t1_inputs(index, C, dev)
    # repeated squaring: T2 = T1.T1, then T3 = T2.T1 / T4 = T2.T2
    t1 = build_t1(index, digit_dense, arrays, C)
    if k == 1:
        table = t1
    elif k == 2:
        table = compose_tables(t1, t1, n, A_key, 1, 1)
    elif k == 3:
        table = compose_tables(compose_tables(t1, t1, n, A_key, 1, 1), t1,
                               n, A_key, 2, 1)
    else:
        t2 = compose_tables(t1, t1, n, A_key, 1, 1)
        t1 = None  # T4 composes T2 with itself: free T1 first
        table = compose_tables(t2, t2, n, A_key, 2, 2)  # peak = T4 + T2
        del t2
    del t1

    # byte -> key digit (or -1: the read takes the fallback — the general
    # k=1 T1 when it fits, else the compact engine)
    if alphabet is not None:
        digit_of_dense = np.full(A_full + 1, -1, dtype=np.int32)
        digit_of_dense[digit_dense] = np.arange(A_key, dtype=np.int32)
        t1_general = (build_t1(index, np.arange(A_full), arrays, C)
                      if keeps_general_t1(index, k, alphabet,
                                          hbm_budget_bytes)
                      else None)
    else:
        digit_of_dense = np.arange(A_full + 1, dtype=np.int32)
        digit_of_dense[A_full] = A_full  # never produced by encode_patterns
        t1_general = None  # the main table already covers every char

    return {
        "table": table,
        "t1": t1_general,
        "n": n,
        "k": k,
        "A": A_key,
        "A_full": A_full,
        "digit_of_dense": digit_of_dense,
        "alphabet": alphabet,
    }


# ---------------------------------------------------------------------------
# K3: the scan
# ---------------------------------------------------------------------------

def _fold_keys(cols: torch.Tensor, k: int, A: int) -> torch.Tensor:
    """(M, B) reversed char columns -> (M/k, B) composed keys; the first
    processed char is the key's high digit."""
    M, B = cols.shape
    grp = cols.reshape(M // k, k, B)
    key = grp[:, 0]
    for j in range(1, k):
        key = key * A + grp[:, j]
    return key


def _unpack_digits(packed: torch.Tensor, pack: int) -> torch.Tensor:
    """(B, M·pack/8) packed bytes -> (B, M) digits; digit j of a byte sits
    at bits j·pack (pack_digits)."""
    per = 8 // pack
    shifts = torch.arange(per, dtype=torch.uint8, device=packed.device) * pack
    dig = (packed[:, :, None] >> shifts) & ((1 << pack) - 1)
    return dig.reshape(packed.shape[0], -1)


def query_chunk_pos_ref(table, n: int, patterns, lengths, pos0, mlen0,
                        step_offset: int, k: int, A: int,
                        masked: bool = False, packed_out: bool = False,
                        fresh_state: bool = False, pack: int = 0):
    """Plain PyTorch K3; same contract as `query_chunk_pos`."""
    if pack:
        patterns = _unpack_digits(patterns, pack)
    B, M = patterns.shape
    keys = _fold_keys(torch.flip(patterns, dims=[1]).T.long(), k, A)
    pb = pos_bits(k)
    mask = pos_mask(k)
    rows_total = table.shape[0]
    ys = torch.empty((M // k, k, B), dtype=torch.int32, device=table.device)
    pos, mlen = pos0, mlen0
    for s in range(M // k):
        i = s * k + step_offset
        rows = table[(keys[s] * n + pos.long()).clamp(0, rows_total - 1)]
        w0 = rows[:, 0]
        w1 = rows[:, 1]
        ln = mlen
        for j in range(k):
            m = (w0 >> (pb + j)) & 1
            ln = (ln + 1) * m  # match ? len+1 : 0
            packed = (ln << 8) | ((w1 >> (8 * j)) & 0xFF)
            if masked:
                packed = torch.where(i + j < lengths, packed, 0)
            ys[s, j] = packed
        pos, mlen = w0 & mask, ln
    packed = torch.flip(ys.reshape(M, B).T, dims=[1])
    if packed_out:
        out = (packed.to(torch.uint16) if (fresh_state and M <= 255)
               else packed.contiguous())
        return (out, None), (pos, mlen)
    return (packed >> 8, packed & 0xFF), (pos, mlen)


def query_chunk_pos(table, n: int, patterns, lengths, pos0, mlen0,
                    step_offset: int, k: int, A: int, masked: bool = False,
                    packed_out: bool = False, fresh_state: bool = False,
                    pack: int = 0):
    """K3 (replaces colbwt_tpu/ops/query_pos.py:309 query_chunk_pos, with
    the digit unpacking of query_batch_pos): one scan over a (B, M) chunk
    of key digits (uint8; M a multiple of k), or of pack-bit packed digits
    (B, M·pack/8) when `pack` is 2 or 4.

    Returns ((pml, cid), (pos, mlen)) — or ((packed, None), (pos, mlen))
    with packed_out, where packed = pml << 8 | cid is uint16 when it
    provably fits (fresh_state, the caller's promise that mlen0 == 0, and
    M <= 255) and int32 otherwise.

    State past a lane's end is deliberately not masked: reads are right-
    aligned, so later steps only consume left padding.  masked=True zeroes
    the outputs of steps at or past `lengths` (steps count from
    step_offset) for the chunked long-read path."""
    if patterns.dtype != torch.uint8:
        raise ValueError(
            f"patterns must be uint8 digits, got {patterns.dtype}")
    if patterns.device.type == "cpu":
        return query_chunk_pos_ref(table, n, patterns, lengths, pos0, mlen0,
                                   step_offset, k, A, masked, packed_out,
                                   fresh_state, pack)
    dev = patterns.device
    B, W = patterns.shape
    M = W * (8 // pack) if pack else W
    if M % k or pack not in (0, 2, 4) or A > (1 << pack if pack else 256):
        raise ValueError(f"bad scan shape: M={M} k={k} pack={pack} A={A}")
    K.require(table, "table", torch.int32, dev)
    K.require_aligned(table, "table", 8)
    K.require(patterns, "patterns", torch.uint8, dev)
    for name, t in (("lengths", lengths), ("pos0", pos0), ("mlen0", mlen0)):
        K.require(t, name, torch.int32, dev)
        if t.shape != (B,):
            raise ValueError(f"{name} must have shape ({B},)")
    if packed_out:
        u16 = fresh_state and M <= 255
        out0 = torch.empty((B, M), dtype=torch.uint16 if u16 else torch.int32,
                           device=dev)
        out1 = None
        mode = 2 if u16 else 1
    else:
        out0 = torch.empty((B, M), dtype=torch.int32, device=dev)
        out1 = torch.empty((B, M), dtype=torch.int32, device=dev)
        mode = 0
    pos_out = torch.empty(B, dtype=torch.int32, device=dev)
    mlen_out = torch.empty(B, dtype=torch.int32, device=dev)
    if B:
        code = K.on(dev).colbwt_query_chunk_pos(
            table.data_ptr(), table.shape[0], int(n), patterns.data_ptr(), W,
            lengths.data_ptr(), pos0.data_ptr(), mlen0.data_ptr(),
            int(step_offset), B, M, int(k), int(A), pack, int(masked), mode,
            out0.data_ptr(), None if out1 is None else out1.data_ptr(),
            pos_out.data_ptr(), mlen_out.data_ptr(), K.stream_handle(dev))
        K.check("query_chunk_pos", code)
        K.launches["query_chunk_pos"] += 1
    return (out0, out1), (pos_out, mlen_out)


def query_batch_pos(table, n: int, patterns, lengths, k: int, A: int,
                    packed_out: bool = False, pack: int = 0):
    """Fresh-state scan of a whole right-aligned batch."""
    B = patterns.shape[0]
    dev = patterns.device
    pos0 = torch.full((B,), n - 1, dtype=torch.int32, device=dev)
    mlen0 = torch.zeros((B,), dtype=torch.int32, device=dev)
    (pml, cid), _ = query_chunk_pos(table, n, patterns, lengths, pos0, mlen0,
                                    0, k=k, A=A, packed_out=packed_out,
                                    fresh_state=True, pack=pack)
    return pml, cid


# ---------------------------------------------------------------------------
# host helpers and batch entry points
# ---------------------------------------------------------------------------

def pack_digits(dig: np.ndarray, A: int) -> tuple[np.ndarray, int]:
    """Pack a (B, M) digit matrix to (B, M*bits/8) uint8 — 2 bits/digit for
    A <= 4, 4 bits for A <= 16; returns (packed, bits), or (dig, 0) when A
    is too large to pack.  M must be a multiple of 8/bits."""
    if A > 16:
        return dig, 0
    bits = 2 if A <= 4 else 4
    per = 8 // bits
    B, M = dig.shape
    if M % per:
        raise ValueError(f"M={M} is not a multiple of {per}")
    grp = dig.reshape(B, M // per, per).astype(np.uint16)
    shifts = (np.arange(per, dtype=np.uint16) * bits)[None, None, :]
    return (grp << shifts).sum(axis=2).astype(np.uint8), bits


def unpack_pml_cid(packed: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Host-side split of a packed_out plane back into (pml, cid) int32."""
    pk = np.asarray(packed).astype(np.int32)
    return pk >> 8, pk & 0xFF


def _encode_digits(index: ColPmlIndex, pt: dict, patterns: list[bytes],
                   M: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Encode patterns to key digits; returns (digits uint8, lens,
    fallback_mask) where fallback_mask marks reads with non-key bytes."""
    enc, lens = index.encode_patterns(patterns, max_len=M)
    dig = pt["digit_of_dense"][enc]
    cols = np.arange(M) >= (M - lens[:, None])
    bad = ((dig < 0) & cols).any(axis=1)
    dig = np.where(dig < 0, 0, dig)  # pad digit; bad lanes rerouted anyway
    return dig.astype(np.uint8), lens, bad


def _unpad(arr: np.ndarray, lens: np.ndarray) -> list[np.ndarray]:
    M = arr.shape[1]
    return [arr[b, M - int(lens[b]):] for b in range(arr.shape[0])]


def query_batch(index: ColPmlIndex, patterns: list[bytes],
                max_len: int | None = None, pt: dict | None = None,
                k: int | None = None, alphabet: bytes | None = None,
                device=None) -> tuple[list[np.ndarray], list[np.ndarray]]:
    """Batched PML+CID queries through the positional tables.  With a
    restricted-alphabet table, reads containing other bytes go through the
    general k=1 table, or the compact engine when that was not kept."""
    if pt is None:
        pt = build_pos_tables(index, k, alphabet=alphabet, device=device)
    dev = pt["table"].device
    k = pt["k"]
    m_raw = max_len if max_len is not None else max(
        (len(p) for p in patterns), default=1)
    M = -(-m_raw // k) * k  # pad to a multiple of k (pads process last)
    if M >= _PML_PACK_LIMIT:
        raise ValueError(f"read length {M} overflows the pml<<8 packing")
    dig, lens, bad = _encode_digits(index, pt, patterns, M)
    pml, cid = query_batch_pos(pt["table"], pt["n"],
                               to_device(dig, dev, np.uint8),
                               to_device(lens, dev), k=k, A=pt["A"])
    out_p = _unpad(pml.cpu().numpy(), lens)
    out_c = _unpad(cid.cpu().numpy(), lens)
    if bad.any():
        idxs = np.flatnonzero(bad)
        sub = [patterns[i] for i in idxs]
        if pt["t1"] is not None:
            enc, blens = index.encode_patterns(sub, M)
            p2, c2 = query_batch_pos(pt["t1"], pt["n"],
                                     to_device(enc, dev, np.uint8),
                                     to_device(blens, dev), k=1,
                                     A=pt["A_full"])
            pc2 = (_unpad(p2.cpu().numpy(), blens),
                   _unpad(c2.cpu().numpy(), blens))
        else:  # general T1 does not fit: compact engine serves the stragglers
            from colbwt_tpu_torch.ops import query_xla

            pc2 = query_xla.query_batch(index, sub, max_len=M, device=dev)
        for j, i in enumerate(idxs):
            out_p[i] = pc2[0][j]
            out_c[i] = pc2[1][j]
    return out_p, out_c


def query_long_reads(index: ColPmlIndex, patterns: list[bytes],
                     chunk: int = 2048, pt: dict | None = None,
                     k: int | None = None, alphabet: bytes | None = None,
                     device=None) -> tuple[list[np.ndarray], list[np.ndarray]]:
    """Arbitrary-length reads via chunked scans with carried (pos, mlen)
    state (the -l mode, src/pml_query.cpp:126-128); equal to one scan of
    the whole read."""
    if pt is None:
        pt = build_pos_tables(index, k, alphabet=alphabet, device=device)
    dev = pt["table"].device
    k = pt["k"]
    A = pt["A"]
    chunk = -(-chunk // k) * k
    B = len(patterns)
    max_m = max((len(p) for p in patterns), default=1)
    n_chunks = max(1, -(-max_m // chunk))
    M = n_chunks * chunk
    if M >= _PML_PACK_LIMIT:
        raise ValueError(f"padded length {M} overflows the pml<<8 packing")
    dig, lens, bad = _encode_digits(index, pt, patterns, M)
    if bad.any():
        # reroute whole reads: through the general k=1 table when kept,
        # else the compact engine
        idxs = np.flatnonzero(bad)
        sub = [patterns[i] for i in idxs]
        if pt["t1"] is not None:
            general = dict(pt, table=pt["t1"], k=1, A=pt["A_full"], t1=None,
                           alphabet=None,
                           digit_of_dense=np.arange(pt["A_full"] + 1))
            gp, gc = query_long_reads(index, sub, chunk=chunk, pt=general)
        else:
            from colbwt_tpu_torch.ops import query_xla

            gp, gc = query_xla.query_batch(index, sub, device=dev)
    dig_t = to_device(dig, dev, np.uint8)
    lens_t = to_device(lens, dev)

    pml_full = np.zeros((B, M), dtype=np.int32)
    cid_full = np.zeros((B, M), dtype=np.int32)
    pos = torch.full((B,), pt["n"] - 1, dtype=torch.int32, device=dev)
    mlen = torch.zeros((B,), dtype=torch.int32, device=dev)
    for j in range(n_chunks):
        lo = M - (j + 1) * chunk
        (pml, cid), (pos, mlen) = query_chunk_pos(
            pt["table"], pt["n"], dig_t[:, lo:lo + chunk].contiguous(),
            lens_t, pos, mlen, j * chunk, k=k, A=A, masked=True)
        pml_full[:, lo:lo + chunk] = pml.cpu().numpy()
        cid_full[:, lo:lo + chunk] = cid.cpu().numpy()
    out_p = _unpad(pml_full, lens)
    out_c = _unpad(cid_full, lens)
    if bad.any():
        for j, i in enumerate(np.flatnonzero(bad)):
            out_p[i] = gp[j]
            out_c[i] = gc[j]
    return out_p, out_c
