"""The port's multi-MUM scan (colbwt_tpu_torch/ops/construct.py and
ops/mum_scan_stream.py) against the JAX package's (ops/construct_jax.py)
and the host oracle, on the CPU, where the plain PyTorch versions of K8
and K9 run.  Every value is an integer or a bit, so every comparison is
exact.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colbwt_tpu.ops import construct_chunked as CC
from colbwt_tpu.ops import construct_jax as CJ
from colbwt_tpu.ops import mum_scan_stream as JMS
from colbwt_tpu.ops import oracle as O
from colbwt_tpu_torch.ops import construct as TC
from colbwt_tpu_torch.ops import mum_scan_stream as TMS
from tests.conftest import random_docs
from tests.test_torch_kernels import (MUM_SHAPES, MUM_TILE, SPAN_SHAPES,
                                      mum_synthetic, span_shape)

CPU = "cpu"
_CONSTRUCT_CU = Path(TC.__file__).resolve().parents[1] / "csrc" / "construct.cu"


def _t(a, dtype=np.int32):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, dtype=dtype)))


def _arrays(docs):
    text, ranks, doc_ids = O.concat_collection(docs)
    sa = O.suffix_array(ranks)
    lcp = O.lcp_kasai(ranks, sa)
    return text, ranks, doc_ids, sa, lcp


def _scan_inputs(rng, ndocs, doclen, muts=20):
    """Noisy copies of one random base, as tests/test_mum_stream.py."""
    base = rng.choice(np.frombuffer(b"ACGT", np.uint8), doclen)
    docs = []
    for _ in range(ndocs):
        a = base.copy()
        a[rng.integers(0, doclen, muts)] = rng.choice(
            np.frombuffer(b"ACGT", np.uint8), muts)
        docs.append(a.tobytes())
    text, ranks, doc_ids, sa, lcp = _arrays(docs)
    heads, lens = O.rle(O.bwt_from_sa(text, sa))
    return (heads, lens, lcp.astype(np.int32), doc_ids[sa].astype(np.uint16),
            CC.run_change_from_runs(heads, lens))


def _planted_cores(rng, N):
    """N documents sharing two conserved cores (40 and 25 bp) between
    random arms (tests/test_construct_jax.py:198)."""
    acgt = np.frombuffer(b"ACGT", np.uint8)
    core1, core2 = rng.choice(acgt, 40), rng.choice(acgt, 25)
    return [np.concatenate([rng.choice(acgt, 30), core1, rng.choice(acgt, 20),
                            core2, rng.choice(acgt, 10)]).tobytes()
            for _ in range(N)]


@pytest.mark.parametrize("w", [1, 2, 3, 7, 8, 127, 128, 129, 300])
def test_sliding_min_matches_jax(rng, w):
    for n in (1, 5, 64, 257, 1000):
        x = rng.integers(-50, 50, n).astype(np.int32)
        want = np.asarray(CJ._sliding_min(jnp.asarray(x), w))
        got = TC.sliding_min_ref(_t(x), w).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"n={n} w={w}")


@pytest.mark.parametrize("n_docs", [2, 3, 5, 8])
def test_multi_mum_scan_matches_jax(rng, n_docs):
    base = bytes(rng.choice(list(b"ACGT"), 150).astype("uint8"))
    _, ranks, doc_ids, sa, lcp = _arrays(random_docs(rng, n_docs,
                                                     mutate_from=base))
    prev_rank = ranks[sa - 1]
    sa_docs = doc_ids[sa]
    for min_mum in (4, 10):
        want = CJ.multi_mum_scan(jnp.asarray(lcp, jnp.int32),
                                 jnp.asarray(sa_docs.astype(np.int32)),
                                 jnp.asarray(prev_rank.astype(np.int32)),
                                 n_docs, min_mum)
        for fn in (TC.multi_mum_scan_ref, TC.multi_mum_scan):
            got = fn(_t(lcp), _t(sa_docs), _t(prev_rank), n_docs, min_mum)
            np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
            np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        assert bool(got[0].any())


@pytest.mark.parametrize("n_docs", [2, 3, 8])
def test_k9_padded_chunk_matches_jax(rng, n_docs):
    """K9's route on the card, on the CPU: the whole array padded as one
    chunk (pad_whole_array), scanned by the chunk's plain version and
    unpacked, equals JAX's multi_mum_scan."""
    base = bytes(rng.choice(list(b"ACGT"), 150).astype("uint8"))
    _, ranks, doc_ids, sa, lcp = _arrays(random_docs(rng, n_docs,
                                                     mutate_from=base))
    prev_rank = ranks[sa - 1]
    n = sa.size
    want = CJ.multi_mum_scan(jnp.asarray(lcp, jnp.int32),
                             jnp.asarray(doc_ids[sa].astype(np.int32)),
                             jnp.asarray(prev_rank.astype(np.int32)),
                             n_docs, 4)
    padded = TC.pad_whole_array(_t(lcp), _t(doc_ids[sa]), _t(prev_rank),
                                n_docs)
    assert padded[0].shape == (n + 2 * n_docs + 2,)
    packed, ell = TC.mum_scan_chunk_ref(*padded, n - n_docs, 4, n_docs)
    np.testing.assert_array_equal(TC.unpackbits_little(packed, n).numpy(),
                                  np.asarray(want[0]))
    np.testing.assert_array_equal(ell.numpy(), np.asarray(want[1]))
    assert bool(np.asarray(want[0]).any())


@pytest.mark.parametrize("u16", [True, False], ids=["uint16", "int32"])
def test_mum_scan_chunk_matches_jax(rng, u16):
    """Chunk by chunk at C = 2**13 with the 2N+2 halo, uint16 documents
    (fill 65535) or int32 (fill -1), as find_multi_mums_chunked feeds them;
    the plain version widens uint16 to int32."""
    _, _, lcp, sa_docs, rc = _scan_inputs(rng, 5, 3500)
    n, N, C = lcp.size, 5, 1 << 13
    halo = 2 * N + 2
    dt, fill = (np.uint16, 65535) if u16 else (np.int32, -1)
    hits = 0
    for s in range(0, n, C):
        def sl(a, f, dtype):
            x = np.asarray(a[s:s + C + halo]).astype(dtype)
            return np.concatenate([x, np.full(C + halo - x.size, f, dtype)])
        args = (sl(lcp, 0, np.int32), sl(sa_docs, fill, dt),
                sl(rc, 1, np.uint8))
        limit = min(n - N - s, C)
        wp, we = CJ._mum_scan_chunk(*(jnp.asarray(a) for a in args),
                                    jnp.int32(limit), jnp.int32(12),
                                    num_docs=N)
        for fn in (TC.mum_scan_chunk_ref, TC.mum_scan_chunk):
            gp, ge = fn(*(torch.from_numpy(a) for a in args), limit, 12, N)
            assert gp.dtype == torch.uint8 and ge.dtype == torch.int32
            np.testing.assert_array_equal(gp.numpy(), np.asarray(wp))
            np.testing.assert_array_equal(ge.numpy(), np.asarray(we))
        hits += int(np.unpackbits(np.asarray(wp)).sum())
    assert hits > 0


# mum_window's tile kernel (csrc/construct.cu mum_tile_kernel) in NumPy,
# tile by tile: the inputs staged past the chunk's end as fills (lcp 0,
# document 0, no run change), ell by the doubling passes, left-maximality by
# prefix counts of the run-change marks, coverage tested only where the
# other conditions hold, by the 64-bit mask or the capped probe.  The
# kernel runs on the card only; this model holds its arithmetic to JAX's
# _mum_scan_chunk and to the plain version.
def _cu_int(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);",
                         _CONSTRUCT_CU.read_text()).group(1))


def distinct_model(d, N: int, stats: dict) -> bool:
    """The kernel's coverage test of one window's N documents."""
    v = np.asarray(d, np.int64) & 0xFFFFFFFF  # as the kernel's uint32
    if N <= 64:
        mask = 0
        for x in v:
            mask |= 1 << int(x & 63)
        if bin(mask).count("1") == N:
            stats["mask"] += 1
            return True
        if (v < 64).all():
            stats["mask"] += 1
            return False
    stats["probe"] += 1
    for j in range(N - 1):
        if (v[j + 1:] == v[j]).any():
            return False
    return True


def mum_tile_model(lcp_s, docs_s, chg_s, limit: int, min_mum: int, N: int,
                   T: int, stats: dict):
    """(packed hits, ell) as the tile kernel writes them for tiles of T."""
    L = lcp_s.size
    C = L - (2 * N + 2)
    w = N - 1
    bits = np.zeros(C, bool)
    ell_out = np.empty(C, np.int32)

    def stage(a, count):
        x = np.zeros(count, np.int64)
        avail = max(0, min(count, L - t0))
        x[:avail] = np.asarray(a[t0:t0 + avail], np.int64)
        return x

    for t0 in range(0, C, T):
        s_lcp = stage(lcp_s, T + N + 1)
        s_docs = stage(docs_s, T + N)
        words = ((T + N) >> 5) + 1
        below = np.r_[0, np.cumsum(stage(chg_s, 32 * words) != 0)]
        f = s_lcp[1:]
        s = 1
        while 2 * s <= w:
            ln = T + w - 2 * s
            f = np.minimum(f[:ln], f[s:s + ln])
            s *= 2
        k = np.arange(min(T, C - t0))
        ell = np.minimum(f[k], f[k + w - s])
        uniq = (s_lcp[k] < ell) & (s_lcp[k + N] < ell)
        left = below[k + N] > below[k + 1]
        edge = left & (below[k + N] - below[k + N - 1] == below[k + N]
                       - below[k + 1])
        cand = (ell >= min_mum) & uniq & left & (t0 + k <= limit)
        stats["edge"] += int((cand & edge).sum())
        for j in np.flatnonzero(cand):
            bits[t0 + j] = distinct_model(s_docs[j:j + N], N, stats)
        ell_out[t0:t0 + k.size] = ell
    stats["hits"] += int(bits.sum())
    return np.packbits(bits, bitorder="little"), ell_out


@pytest.mark.parametrize("wide_ids", [False, True], ids=["ids", "wide ids"])
@pytest.mark.parametrize("u16", [True, False], ids=["uint16", "int32"])
@pytest.mark.parametrize("num_docs", [2, 4, 16, 65, 130])
@pytest.mark.parametrize("shape", sorted(MUM_SHAPES))
def test_mum_tile_model_matches_jax(shape, num_docs, u16, wide_ids):
    """The tile kernel's split and arithmetic at tiles of 64 and the
    shipped tile, on the synthetic chunks of the `cuda` tests (every branch:
    the mask, the probe, a run change only at a window's last position),
    against JAX's _mum_scan_chunk and the plain version."""
    C, limit = MUM_SHAPES[shape]
    a = mum_synthetic(num_docs, C, limit, u16, num_docs, wide_ids)
    wp, we = CJ._mum_scan_chunk(*(jnp.asarray(x) for x in a),
                                jnp.int32(limit), jnp.int32(12),
                                num_docs=num_docs)
    gp, ge = TC.mum_scan_chunk_ref(*(torch.from_numpy(x) for x in a), limit,
                                   12, num_docs)
    np.testing.assert_array_equal(gp.numpy(), np.asarray(wp))
    np.testing.assert_array_equal(ge.numpy(), np.asarray(we))
    for T in (64, MUM_TILE):
        stats = dict.fromkeys(("mask", "probe", "edge", "hits"), 0)
        mp, me = mum_tile_model(*a, limit, 12, num_docs, T, stats)
        np.testing.assert_array_equal(mp, np.asarray(wp))
        np.testing.assert_array_equal(me, np.asarray(we))
    if limit >= 0:
        assert stats["hits"] > 0 and stats["edge"] > 0
        # the probe decides past 64 documents and for ids past 63
        assert (stats["probe"] > 0) == (num_docs > 64 or wide_ids)


# The large-N route (csrc/construct.cu mum_summary_kernel + mum_span_kernel)
# in NumPy: tiles of span_tile(N) positions summarised (least lcp, any run
# change), then a block a span of window starts, each window's head (a
# suffix scan of the span within tiles), tail (a prefix scan of the two
# spans from q0) and the tiles between (the block's core, at most one more
# tile on each side); coverage only where the other conditions hold, by
# bitmap passes of ID_BITS over the ids' [min, max].  The kernel runs on
# the card only; this model holds its arithmetic to JAX's _mum_scan_chunk
# and to the plain version, at the shipped span and at a span of 64 (where
# N = 1,025 has a core of many tiles).
ID_BITS = 65536
NONE = (np.iinfo(np.int32).max, 0)


def tile_scan_model(x, c, T: int, suffix: bool):
    """csrc/construct.cu tile_scan as the threads run it: 8 consecutive
    positions a thread in registers, a tile's threads by the guarded warp
    shuffles, its warps through a warp's total.  x, c: one span of
    values (int64) and run-change flags; returns both scanned."""
    threads = x.size // 8
    v = [[(int(x[8 * t + j]), int(c[8 * t + j])) for j in range(8)]
         for t in range(threads)]

    def comb(a, b):
        return (min(a[0], b[0]), a[1] | b[1])

    for t in range(threads):
        p0 = 8 * t
        if suffix:
            for j in range(6, -1, -1):
                if (p0 + j + 1) & (T - 1):
                    v[t][j] = comb(v[t][j], v[t][j + 1])
        else:
            for j in range(1, 8):
                if (p0 + j) & (T - 1):
                    v[t][j] = comb(v[t][j - 1], v[t][j])
    if T > 8:
        lanes = T // 8
        seg = min(lanes, 32)
        agg = [v[t][0] if suffix else v[t][7] for t in range(threads)]
        d = 1
        while d < seg:  # one shuffle step, every lane at once
            new = list(agg)
            for t in range(threads):
                lane, in_seg = t & 31, t & (seg - 1)
                src = lane + d if suffix else lane - d
                o = agg[t - lane + src] if 0 <= src < 32 else agg[t]
                if suffix and in_seg + d < seg:
                    new[t] = comb(agg[t], o)
                elif not suffix and in_seg >= d:
                    new[t] = comb(o, agg[t])
            agg = new
            d *= 2
        carry = []
        for t in range(threads):
            lane, in_seg = t & 31, t & (seg - 1)
            src = lane + 1 if suffix else lane - 1
            o = agg[t - lane + src] if 0 <= src < 32 else agg[t]
            carry.append(NONE if in_seg == (seg - 1 if suffix else 0) else o)
        if lanes > 32:
            per = lanes >> 5
            s_warp = [agg[32 * w + (0 if suffix else 31)]
                      for w in range(threads // 32)]
            for t in range(threads):
                warp = t >> 5
                first = warp & ~(per - 1)
                for w in range(first, first + per):
                    if (w > warp) if suffix else (w < warp):
                        carry[t] = comb(carry[t], s_warp[w])
        for t in range(threads):
            v[t] = [comb(e, carry[t]) for e in v[t]]
    flat = [e for row in v for e in row]
    return (np.array([e[0] for e in flat], np.int64),
            np.array([e[1] for e in flat], np.int64))


def seg_scan(x, T: int, suffix: bool, op):
    """The same scan as tile_scan_model, whole tiles at a time."""
    t = x.reshape(-1, T)
    if suffix:
        return op.accumulate(t[:, ::-1], axis=1)[:, ::-1].reshape(-1)
    return op.accumulate(t, axis=1).reshape(-1)


def distinct_bitmap_model(ids, N: int, u16: bool, stats: dict) -> bool:
    """mum_span_kernel's coverage test of one window's N ids."""
    v = np.asarray(ids, np.int64)
    lo, hi = 0, 65535
    if not u16:
        lo, hi = int(v.min()), int(v.max())
        if hi - lo + 1 < N:
            stats["pigeonhole"] += 1
            return False
    for base in range(lo, hi + 1, ID_BITS):
        stats["passes"] += 1
        sel = v[(v >= base) & (v < base + ID_BITS)]
        if np.unique(sel).size < sel.size:
            return False
    return True


def span_route_model(lcp_s, docs_s, chg_s, limit: int, min_mum: int,
                     N: int, span: int, stats: dict):
    """(packed hits, ell) as the large-N route writes them, for blocks of
    `span` starts (the kernel's kSpan = TC._SPAN) and its tiles."""
    L = lcp_s.size
    C = L - (2 * N + 2)
    u16 = docs_s.dtype == np.uint16
    T = 1
    while 2 * T <= min(N - 2, span):
        T *= 2
    big = np.iinfo(np.int32).max
    ext = -(-L // span) * span + 3 * span
    x = np.full(ext, big, np.int64)
    x[:L] = lcp_s
    c = np.zeros(ext, np.int64)
    c[:L] = chg_s != 0
    # pass 1: a tile's least lcp and any run change, tiles below L
    tiles = -(-L // T)
    s_min = x[:tiles * T].reshape(tiles, T).min(axis=1)
    s_chg = c[:tiles * T].reshape(tiles, T).max(axis=1)
    bits = np.zeros(C, bool)
    ell_out = np.empty(C, np.int32)
    for t0 in range(0, C, span):
        q0 = (t0 + N - 1) // span * span
        h_min = seg_scan(x[t0:t0 + span], T, True, np.minimum)
        h_chg = seg_scan(c[t0:t0 + span], T, True, np.maximum)
        t_min = seg_scan(x[q0:q0 + 2 * span], T, False, np.minimum)
        t_chg = seg_scan(c[q0:q0 + 2 * span], T, False, np.maximum)
        c_lo, c_hi = (t0 + span) // T + 1, (t0 + N - 1) // T - 1
        core = (s_min[c_lo:c_hi + 1].min(initial=big),
                s_chg[c_lo:c_hi + 1].max(initial=0))
        stats["core"] += int(c_hi >= c_lo)
        k = np.arange(min(span, C - t0))
        i = t0 + k
        ta, te = (i + 1) // T, (i + N - 1) // T
        assert (te > ta).all() or N == 2  # a window spans two tiles
        last = k + 1 == span
        stats["head from pass 1"] += int(last.sum())
        kk = np.minimum(k + 1, span - 1)
        m = np.where(last, s_min[np.minimum(ta, tiles - 1)], h_min[kk])
        a = np.where(last, s_chg[np.minimum(ta, tiles - 1)], h_chg[kk])
        pe = i + N - 1 - q0
        m = np.minimum(np.minimum(m, t_min[pe]), core[0])
        a = a | t_chg[pe] | core[1]
        # the tiles between outside the core: at most one on each side
        hi1 = np.minimum(c_lo - 1, te - 1)
        lo2 = np.maximum(c_hi + 1, ta + 1)
        assert (ta + 2 > hi1).all() and (lo2 + 1 > te - 1).all()
        for j, ok in ((ta + 1, ta + 1 <= hi1), (lo2, lo2 <= te - 1)):
            stats["extra tiles"] += int(ok.sum())
            jj = np.minimum(j, tiles - 1)
            m = np.where(ok, np.minimum(m, s_min[jj]), m)
            a = np.where(ok, a | s_chg[jj], a)
        uniq = (x[i] < m) & (x[q0 + pe + 1] < m)
        cand = (m >= min_mum) & uniq & (a != 0) & (i <= limit)
        for j in np.flatnonzero(cand):
            stats["candidates"] += 1
            bits[t0 + j] = distinct_bitmap_model(
                docs_s[t0 + j:t0 + j + N], N, u16, stats)
        ell_out[t0:t0 + k.size] = m
    stats["hits"] += int(bits.sum())
    return np.packbits(bits, bitorder="little"), ell_out


def _stats():
    return dict.fromkeys(("core", "head from pass 1", "extra tiles",
                          "candidates", "pigeonhole", "passes", "hits"), 0)


@pytest.mark.parametrize("suffix", [False, True], ids=["prefix", "suffix"])
@pytest.mark.parametrize("T", [1, 2, 4, 8, 16, 64, 256, 512, 2048])
def test_tile_scan_model_is_a_segmented_scan(T, suffix):
    """tile_scan's thread, shuffle and warp steps give the segmented scan
    within tiles, at every tile width the route takes (the in-thread
    resets below 8, one warp's segments up to 256, warps past it)."""
    rng = np.random.default_rng(T)
    x = rng.integers(0, 1000, TC._SPAN)
    c = (rng.random(TC._SPAN) < 0.002).astype(np.int64)
    gx, gc = tile_scan_model(x, c, T, suffix)
    np.testing.assert_array_equal(gx, seg_scan(x, T, suffix, np.minimum))
    np.testing.assert_array_equal(gc, seg_scan(c, T, suffix, np.maximum))


def _span_case(shape, num_docs, u16, spans):
    """The model at `spans` against JAX and the plain version on one
    synthetic chunk; returns each span's stats."""
    C, limit = span_shape(shape, num_docs)
    a = mum_synthetic(num_docs, C, limit, u16, num_docs)
    wp, we = CJ._mum_scan_chunk(*(jnp.asarray(x) for x in a),
                                jnp.int32(limit), jnp.int32(12),
                                num_docs=num_docs)
    gp, ge = TC.mum_scan_chunk_ref(*(torch.from_numpy(x) for x in a), limit,
                                   12, num_docs)
    np.testing.assert_array_equal(gp.numpy(), np.asarray(wp))
    np.testing.assert_array_equal(ge.numpy(), np.asarray(we))
    out = {}
    for span in spans:
        stats = out[span] = _stats()
        mp, me = span_route_model(*a, limit, 12, num_docs, span, stats)
        np.testing.assert_array_equal(mp, np.asarray(wp))
        np.testing.assert_array_equal(me, np.asarray(we))
        if not u16:
            assert stats["pigeonhole"] + stats["passes"] == \
                stats["candidates"]
    return out


@pytest.mark.parametrize("u16", [True, False], ids=["uint16", "int32"])
@pytest.mark.parametrize("num_docs", [1025, 2049, 4099])
@pytest.mark.parametrize("shape", SPAN_SHAPES)
def test_span_route_model_matches_jax(shape, num_docs, u16):
    """The large-N route's split at N past the tile route's limit, on the
    synthetic chunks of the `cuda` tests (C < N for the short chunk, C not
    a multiple of the span with limit inside its last span, limit -1, four
    windows of N; windows that cover every document and windows that
    repeat one), at the shipped span and at spans of 64 (a core of many
    tiles), against JAX's _mum_scan_chunk and the plain version."""
    stats = _span_case(shape, num_docs, u16, (64, TC._SPAN))
    C, limit = span_shape(shape, num_docs)
    if shape == "four windows of N":
        for st in stats.values():
            assert st["candidates"] > st["hits"] > 0  # covers both ways
    assert stats[64]["core"] > 0 and stats[64]["extra tiles"] > 0
    assert stats[TC._SPAN]["head from pass 1"] > 0 or C < TC._SPAN


def test_span_route_model_core_at_the_shipped_span():
    """N = 6,200 > 3 spans: tiles of the whole span, a core of tiles every
    block reduces once, as config #3's N = 10,000 has it."""
    for u16 in (True, False):
        st = _span_case("four windows of N", 6200, u16, (TC._SPAN,))
        st = st[TC._SPAN]
        assert st["core"] > 0 and st["extra tiles"] > 0
        assert st["candidates"] > st["hits"] > 0


@pytest.mark.parametrize("num_docs", [2, 3, 4, 5, 16, 65])
def test_span_route_model_small_n(num_docs):
    """The large-N route at any N >= 2, as phase 3 of chip_smoke.py and
    the `cuda` test run it with the switch lowered: tiles of 1 (N = 2, 3,
    a window's ends one position or adjacent), 2, 2 and 8, 64, one tile
    at most between a window's ends."""
    for u16, wide in ((True, False), (False, True)):
        C, limit = MUM_SHAPES["C not a multiple of the tile, limit in the "
                              "last tile"]
        a = mum_synthetic(num_docs, C, limit, u16, num_docs, wide)
        wp, we = CJ._mum_scan_chunk(*(jnp.asarray(x) for x in a),
                                    jnp.int32(limit), jnp.int32(12),
                                    num_docs=num_docs)
        stats = _stats()
        mp, me = span_route_model(*a, limit, 12, num_docs, TC._SPAN, stats)
        np.testing.assert_array_equal(mp, np.asarray(wp))
        np.testing.assert_array_equal(me, np.asarray(we))
        assert stats["hits"] > 0 and stats["candidates"] > stats["hits"]
        assert stats["core"] == 0


def test_span_route_model_int32_id_passes():
    """int32 ids spread past one bitmap pass (ids times 40,000: N = 1,025
    ids over 41M values, 626 passes a covering window) and ids whose range
    is narrower than N (no pass: a repeat is certain)."""
    N = 1025
    C, limit = MUM_SHAPES["C not a multiple of the tile, limit in the last "
                          "tile"]
    lcp, docs, chg = mum_synthetic(N, C, limit, False, 5)
    for scale in (40_000, 1):
        d = docs.astype(np.int64) * scale
        if scale == 1:
            d = d % (N - 1)
        d = np.where(docs < 0, -1, d).astype(np.int32)
        a = (lcp, d, chg)
        wp, we = CJ._mum_scan_chunk(*(jnp.asarray(x) for x in a),
                                    jnp.int32(limit), jnp.int32(12),
                                    num_docs=N)
        stats = _stats()
        mp, me = span_route_model(*a, limit, 12, N, TC._SPAN, stats)
        np.testing.assert_array_equal(mp, np.asarray(wp))
        np.testing.assert_array_equal(me, np.asarray(we))
        if scale == 1:
            assert stats["pigeonhole"] == stats["candidates"] > 0
            assert stats["hits"] == 0
        else:
            assert stats["hits"] > 0 and stats["passes"] > 626


def test_span_route_model_near_identical_collection(rng):
    """Config #3's shape at a small size: 1,030 copies of one 60 bp base
    with a substitution each at one of 12 hotspot sites, so many windows of
    N = 1,030 cover every document; document 0 carries bases 10-29 again
    over 35-54 and document 1 a substitution at 20, so the 1,030 suffixes
    that begin with those 20 bases repeat document 0.  Every chunk of
    2**14 (uint16 ids, as find_multi_mums_chunked cuts them) equals JAX's
    and the plain version; the hits are the oracle's multi-MUMs."""
    N, length = 1030, 60
    acgt = np.frombuffer(b"ACGT", np.uint8)
    base = rng.choice(acgt, length)
    sites = rng.choice(np.r_[0:8, 56:60], 12, replace=False)
    docs = []
    for d in range(N):
        a = base.copy()
        a[rng.choice(sites)] = rng.choice(acgt)
        if d == 0:
            a[35:55] = base[10:30]
        elif d == 1:
            a[20] = acgt[(np.flatnonzero(acgt == a[20])[0] + 1) % 4]
        docs.append(a.tobytes())
    _, ranks, doc_ids, sa, lcp = _arrays(docs)
    prev_rank = ranks[sa - 1]
    rc = np.ones(sa.size, np.uint8)
    rc[1:] = prev_rank[1:] != prev_rank[:-1]
    sa_docs = doc_ids[sa]
    n, C, halo = sa.size, 1 << 14, 2 * N + 2
    want = O.find_multi_mums(ranks, sa, lcp, doc_ids, N, 12)
    assert want[0].size > 0
    stats = _stats()
    pos = []
    for s in range(0, n, C):
        def sl(a, f, dtype):
            x = np.asarray(a[s:s + C + halo]).astype(dtype)
            return np.concatenate([x, np.full(C + halo - x.size, f, dtype)])
        a = (sl(lcp, 0, np.int32), sl(sa_docs, 65535, np.uint16),
             sl(rc, 1, np.uint8))
        limit = min(n - N - s, C)
        wp, we = CJ._mum_scan_chunk(*(jnp.asarray(x) for x in a),
                                    jnp.int32(limit), jnp.int32(12),
                                    num_docs=N)
        gp, ge = TC.mum_scan_chunk_ref(*(torch.from_numpy(x) for x in a),
                                       limit, 12, N)
        mp, me = span_route_model(*a, limit, 12, N, TC._SPAN, stats)
        for got in ((mp, me), (gp.numpy(), ge.numpy())):
            np.testing.assert_array_equal(got[0], np.asarray(wp))
            np.testing.assert_array_equal(got[1], np.asarray(we))
        pos.append(s + np.flatnonzero(
            np.unpackbits(mp, bitorder="little")[:C]))
    np.testing.assert_array_equal(np.concatenate(pos), want[1])
    assert stats["candidates"] > stats["hits"] == want[0].size


def test_span_constants():
    """The large-N route's span, tile rule and shared memory, as
    csrc/construct.cu has them."""
    assert TC._SPAN == _cu_int("kSpan") == 2048
    assert _cu_int("kIdBits") == ID_BITS
    assert [TC.span_tile(n) for n in (2, 3, 4, 5, 6, 1025, 2049, 2050,
                                      4099, 10_000)] == \
        [1, 1, 2, 2, 4, 512, 1024, 2048, 2048, 2048]
    span, warps = TC._SPAN, 256 // 32
    smem = 2 * 3 * span * 4 + 3 * span + 3 * warps * 8 + span // 32 * 4 \
        + 8 + 17 * 4
    assert smem <= 232_448 and ID_BITS // 8 <= 3 * span * 4


def test_mum_window_route_and_tile():
    """The wrapper's route by shape, the kernel's tile and its shared
    memory at the route's largest N."""
    assert MUM_TILE == _cu_int("kMumTile")
    assert TC._TILE_MAX_N == _cu_int("kMumTileMaxN")
    assert TC.mum_window_route(2) == "tile"
    assert TC.mum_window_route(TC._TILE_MAX_N) == "tile"
    assert TC.mum_window_route(TC._TILE_MAX_N + 1) == "two-pass"
    assert TC.mum_window_route(10_000) == "two-pass"
    for doc_bytes in (2, 4):  # csrc/construct.cu tile_smem_bytes
        N = TC._TILE_MAX_N
        lcp_slots = -(-(MUM_TILE + N + 1) // 4) * 4
        doc_slots = -(-(MUM_TILE + N) // (16 // doc_bytes)) * (16 // doc_bytes)
        words = ((MUM_TILE + N) >> 5) + 1
        smem = 12 * lcp_slots + doc_bytes * doc_slots + 40 * words
        assert smem <= 232_448  # the H100's shared memory a block


def test_mum_window_route_lowered(monkeypatch):
    """A test lowers the switch, as the `cuda` test of the large-N route
    does; the plain version on the CPU is the same either way."""
    monkeypatch.setattr(TC, "_TILE_MAX_N", 3)
    assert TC.mum_window_route(3) == "tile"
    assert TC.mum_window_route(4) == "two-pass"


def test_find_multi_mums_chunked_route_matches_jax(rng, monkeypatch):
    """_CHUNKED_SCAN_MIN_N lowered in both packages: several chunks of
    C = 2**13 run, and both equal the oracle."""
    monkeypatch.setattr(CJ, "_CHUNKED_SCAN_MIN_N", 1 << 10)
    monkeypatch.setattr(TC, "_CHUNKED_SCAN_MIN_N", 1 << 10)
    base = bytes(rng.choice(list(b"ACGT"), 4000).astype("uint8"))
    docs = random_docs(rng, 6, mutate_from=base)
    _, ranks, doc_ids, sa, lcp = _arrays(docs)
    assert sa.size > 2 * (1 << 13)
    for min_mum in (5, 12):
        want = O.find_multi_mums(ranks, sa, lcp, doc_ids, 6, min_mum)
        jax_got = CJ.find_multi_mums_jax(ranks, sa, lcp, doc_ids, 6, min_mum)
        got = TC.find_multi_mums(ranks, sa, lcp, doc_ids, 6, min_mum,
                                 device=CPU)
        for g, j, w in zip(got, jax_got, want):
            np.testing.assert_array_equal(g, w)
            np.testing.assert_array_equal(j, w)
        assert want[0].size > 0


@pytest.mark.parametrize("n_docs", [2, 3, 8])
def test_find_multi_mums_one_shot_route_matches_oracle(rng, n_docs):
    base = bytes(rng.choice(list(b"ACGT"), 200).astype("uint8"))
    _, ranks, doc_ids, sa, lcp = _arrays(random_docs(rng, n_docs,
                                                     mutate_from=base))
    want = O.find_multi_mums(ranks, sa, lcp, doc_ids, n_docs, 6)
    got = TC.find_multi_mums(ranks, sa, lcp, doc_ids, n_docs, 6, device=CPU)
    for g, w, j in zip(got, want, CJ.find_multi_mums_jax(
            ranks, sa, lcp, doc_ids, n_docs, 6)):
        assert g.dtype == np.int64
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(j, w)


def test_planted_cores_high_n(rng, monkeypatch):
    """N = 400 (the van Herk regime of the window minima): exactly the two
    planted cores, on the one-shot route and on the chunked one."""
    N = 400
    _, ranks, doc_ids, sa, lcp = _arrays(_planted_cores(rng, N))
    want = O.find_multi_mums(ranks, sa, lcp, doc_ids, N, 8)
    assert sorted(want[0].tolist()) == [25, 40]
    for chunked in (False, True):
        if chunked:
            monkeypatch.setattr(TC, "_CHUNKED_SCAN_MIN_N", 1 << 10)
        got = TC.find_multi_mums(ranks, sa, lcp, doc_ids, N, 8, device=CPU)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    for g, w in zip(CJ.find_multi_mums_jax(ranks, sa, lcp, doc_ids, N, 8),
                    want):
        np.testing.assert_array_equal(g, w)


def test_packed_memmap_chunks_resume(rng, tmp_path):
    """Memmapped inputs with packed run-change bits, scanned one chunk per
    call through start_chunk/max_chunks, compose to the one-shot scan
    (tests/test_mum_stream.py:49); a chunk size that is not a multiple of
    8 reads the packed bits at a bit offset."""
    heads, lens, lcp, sa_docs, rc = _scan_inputs(rng, 5, 3500)
    N = 5
    want = CJ.find_multi_mums_chunked(lcp, sa_docs, rc, N, 12, chunk=1 << 13)
    np.save(tmp_path / "lcp.npy", lcp)
    np.save(tmp_path / "doc.npy", sa_docs)
    JMS.write_run_change_bits(heads, lens, tmp_path / "rc.npy")
    lcp_m, doc_m, rc_m = (np.load(tmp_path / f, mmap_mode="r")
                          for f in ("lcp.npy", "doc.npy", "rc.npy"))
    for chunk in (1 << 13, 777):
        n_chunks = -(-lcp.size // chunk)
        parts = []
        k = 0
        while k < n_chunks:
            info = {}
            parts.append(TC.find_multi_mums_chunked(
                lcp_m, doc_m, rc_m, N, 12, chunk=chunk,
                run_change_packed=True, start_chunk=k, max_chunks=1,
                info=info, device=CPU))
            assert info["next_chunk"] == k + 1
            k = info["next_chunk"]
        for j in (0, 1):
            np.testing.assert_array_equal(
                np.concatenate([p[j] for p in parts]), want[j])
    assert want[0].size > 0


def _stream_files(rng, tmp_path):
    heads, lens, lcp, sa_docs, rc = _scan_inputs(rng, 4, 5000)
    np.save(tmp_path / "lcp.npy", lcp)
    np.save(tmp_path / "doc.npy", sa_docs)
    JMS.write_run_change_bits(heads, lens, tmp_path / "rc.npy")
    want = CJ.find_multi_mums_chunked(lcp, sa_docs, rc, 4, 15, chunk=1 << 13)
    files = [tmp_path / f for f in ("lcp.npy", "doc.npy", "rc.npy")]
    return files, want, -(-lcp.size // (1 << 13))


def test_streamed_driver_resumes_after_interruption(rng, tmp_path,
                                                   monkeypatch):
    """A scan killed after two chunks keeps its progress; the rerun starts
    at chunk 2, equals the one-shot scan and removes the progress file."""
    files, want, n_chunks = _stream_files(rng, tmp_path)
    assert n_chunks >= 3
    real = TC.find_multi_mums_chunked
    starts = []

    def dies_at_2(*a, start_chunk=0, **kw):
        if start_chunk == 2:
            raise KeyboardInterrupt("killed")
        starts.append(start_chunk)
        return real(*a, start_chunk=start_chunk, **kw)

    monkeypatch.setattr(TC, "find_multi_mums_chunked", dies_at_2)
    with pytest.raises(KeyboardInterrupt):
        TMS.find_multi_mums_streamed(*files, 4, 15, chunk=1 << 13,
                                     device=CPU)
    progress = tmp_path / "mumscan_progress.npz"
    assert progress.exists() and starts == [0, 1]

    def counts(*a, start_chunk=0, **kw):
        starts.append(start_chunk)
        return real(*a, start_chunk=start_chunk, **kw)

    monkeypatch.setattr(TC, "find_multi_mums_chunked", counts)
    logs = []
    got = TMS.find_multi_mums_streamed(*files, 4, 15, chunk=1 << 13,
                                       log=logs.append, device=CPU)
    assert starts == list(range(n_chunks))
    assert any("resumes at chunk 2" in m for m in logs)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert not progress.exists()


@pytest.mark.parametrize("other", ["num_docs", "min_mum", "chunk"])
def test_streamed_driver_ignores_progress_of_another_scan(rng, tmp_path,
                                                          other):
    """A progress file keyed for another (N, min_mum, C) is not resumed
    from: the scan starts at chunk 0 and gives the one-shot result."""
    files, want, n_chunks = _stream_files(rng, tmp_path)
    key = {"num_docs": [3, 15, 1 << 13], "min_mum": [4, 20, 1 << 13],
           "chunk": [4, 15, 1 << 14]}[other]
    n = int(np.load(files[0], mmap_mode="r").shape[0])
    progress = tmp_path / "p.npz"
    bogus = np.array([123], dtype=np.int64)
    np.savez(progress, key=np.array([n, *key], dtype=np.int64),
             next_chunk=n_chunks - 1, ml=bogus, mp=bogus)
    logs = []
    got = TMS.find_multi_mums_streamed(*files, 4, 15, progress_path=progress,
                                       chunk=1 << 13, log=logs.append,
                                       device=CPU)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert any("another scan" in m for m in logs)
    assert not progress.exists()
