"""Randomized differential fuzz of the port's pos scan (K3), col-split
walk (K10a), compact engine's scan (K4), mega and mega-wide scans (K5,
K6a) and fused scan (K7), the port's counterpart of
tests/test_fuzz_differential.py::test_fuzz_device_engines_vs_cpp for
these kernels.

Cases are made from numpy seeds as that file's `_random_case` makes them
(its alphabets, SNP-style and independent documents, real or synthetic col
ids with the 8-bit edges 0 and 255, empty, 1-character, huge reads and
reads with bytes absent from the index), here through the port's oracle.
On the CPU, the plain versions run: the pos scan is held to the JAX
package's `query_chunk_pos` on the same tables and digits and, through the
port's batch and long-read drivers, to the port's oracle; the walk is held
to JAX's `_tunneled_walk` and to the NumPy model of the kernel
(tests/test_torch_colsplit.py::walk_model) on random FL tables; the
compact scan, on the unsplit index and on run-split ones at ff_bound 1-4,
to JAX's `query_batch_device` and to the port's oracle; the mega scans to
JAX's chunk scans and the oracle (below); the fused scan, on run-split
indexes at ff_bound 1-4 and the port's own tables, to JAX's
`query_batch_fused` on JAX's tables and to the port's oracle.  The
`cuda` cases hold the kernels to their plain versions on the same cases on
the card.  Every value is an integer: tolerance 0.

JAX is imported inside the CPU tests only, so that the `cuda` cases run
where JAX is not installed (`pytest --noconftest -m cuda`).
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from colbwt_tpu_torch.models import tensors as TT
from colbwt_tpu_torch.models.index import ColPmlIndex
from colbwt_tpu_torch.models.tensors import to_device
from colbwt_tpu_torch.ops import colsplit as TCS
from colbwt_tpu_torch.ops import oracle as O
from colbwt_tpu_torch.ops import query_pos as TQ
from colbwt_tpu_torch.ops import query_xla as TX

ALPHABETS = [b"ACGT", b"AC", b"ACGTN", bytes(range(60, 80)), b"Z"]


def random_case(rng):
    """A random (table, reads, docs) triple through the port's oracle,
    drawn as tests/test_fuzz_differential.py::_random_case draws it."""
    alph = ALPHABETS[int(rng.integers(0, len(ALPHABETS)))]
    nd = int(rng.integers(1, 5))
    if rng.random() < 0.5 and nd >= 2:  # SNP-style near-identical docs
        L = int(rng.integers(30, 900))
        base = rng.choice(np.frombuffer(alph, np.uint8), L)
        docs = []
        for _ in range(nd):
            a = base.copy()
            k = int(rng.integers(0, max(1, L // 20)))
            a[rng.integers(0, L, k)] = rng.choice(
                np.frombuffer(alph, np.uint8), k)
            docs.append(a.tobytes())
    else:  # independent random docs, varied lengths
        docs = [rng.choice(np.frombuffer(alph, np.uint8),
                           int(rng.integers(2, 600))).tobytes()
                for _ in range(nd)]

    text, ranks, doc_ids = O.concat_collection(docs)
    sa = O.suffix_array(ranks)
    lcp = O.lcp_kasai(ranks, sa)
    heads, lens = O.rle(O.bwt_from_sa(text, sa))
    thr = O.compute_thresholds(heads, lens, lcp)
    n = int(lens.sum())
    if rng.random() < 0.5 and len(docs) >= 2:
        fl = O.build_fl_table(heads, lens)
        ml, mp = O.find_multi_mums(ranks, sa, lcp, doc_ids, nd,
                                   int(rng.integers(5, 20)))
        mpos, mids, mhts = O.col_split_oracle(
            fl, ml, mp, nd, int(rng.integers(1, 8)),
            "tunnels" if rng.random() < 0.5 else "all")
        bits, ids = O.find_col_runs_oracle(mpos, mids, mhts, fl.l_heads,
                                           fl.n)
    else:  # synthetic ids on the 8-bit edges (0, 1, 255)
        k = int(rng.integers(0, 6))
        bits = (np.unique(rng.integers(0, n, k)) if k
                else np.empty(0, np.int64))
        ids = rng.choice(np.array([0, 1, 2, 254, 255], np.int64), bits.size)
    tbl = O.build_col_pml(heads, lens, np.asarray(bits, np.int64),
                          np.asarray(ids, np.int64), thr)

    reads = []
    for _ in range(int(rng.integers(1, 9))):
        style = rng.random()
        if style < 0.12:
            reads.append(b"")
        elif style < 0.24:
            reads.append(bytes([int(rng.choice(list(alph)))]))
        elif style < 0.36:  # bytes absent from the index mixed in
            m = int(rng.integers(1, 80))
            reads.append(rng.choice(np.frombuffer(alph + b"XY#~", np.uint8),
                                    m).tobytes())
        elif style < 0.48:  # huge read
            m = int(rng.integers(1000, 4000))
            reads.append(rng.choice(np.frombuffer(alph, np.uint8),
                                    m).tobytes())
        else:  # substring of a document with a few errors
            d = docs[int(rng.integers(0, nd))]
            m = min(len(d), int(rng.integers(1, 150)))
            s = int(rng.integers(0, len(d) - m + 1))
            a = bytearray(d[s:s + m])
            for _ in range(int(rng.integers(0, 3))):
                a[int(rng.integers(0, m))] = int(rng.choice(list(alph)))
            reads.append(bytes(a))
    return tbl, reads, docs


# ---------------------------------------------------------------------------
# K3, the pos scan
# ---------------------------------------------------------------------------

# (k, pack, output mode, carried state): every k with every packing, each
# output mode fresh, and masked chunks with carried state in both int32
# modes; a seed a case
POS_SETTINGS = [(k, pack, mode, carried)
                for k in (1, 2, 3, 4) for pack in (0, 2, 4)
                for mode, carried in (("u16", False), ("planes", False),
                                      ("i32", True), ("planes", True))
                if not (pack == 4 and k > 2)]
POS_CASES = [(0xF5 + 7 * i, *s) for i, s in enumerate(POS_SETTINGS)]
# the bytes a byte can hold of each packing, and the key alphabet's cap
PER = {0: 1, 2: 4, 4: 2}
KEY_CAP = {0: 4, 2: 4, 4: 16}


def pos_case(seed, k, pack):
    """The case's generator (for the scan's state), table, port index,
    reads and the scan's key alphabet: every byte of the index at k <= 2
    without packing, else at most KEY_CAP of the text's bytes."""
    rng = np.random.default_rng(seed)
    tbl, reads, docs = random_case(rng)
    index = ColPmlIndex.from_table(tbl)
    present = bytes(sorted(set(b"".join(docs))))
    alphabet = (None if pack == 0 and k <= 2
                else present[:KEY_CAP[pack]])
    return rng, tbl, index, alphabet, reads


def scan_inputs(rng, index, pt, reads, k, pack, mode, carried):
    """The scan's digits (unpacked for JAX, packed for the port), lengths,
    state and keyword arguments for one setting."""
    grp = math.lcm(k, PER[pack])
    m_raw = max([len(r) for r in reads] + [1])
    M = min(-(-m_raw // grp), (255 if mode == "u16" else 300) // grp) * grp
    dig, lens, _ = TQ._encode_digits(index, pt, [r[:M] for r in reads], M)
    B = dig.shape[0]
    n = pt["n"]
    if carried:
        pos0 = rng.integers(0, n, B)
        pos0[:2] = (n - 1, 0)[:B]
        mlen0 = rng.integers(0, 300, B)
        mlen0[::3] = rng.choice([0, (1 << 23) - 1, 1 << 23, 1 << 30],
                                mlen0[::3].size)
        step_offset = k * int(rng.integers(0, 40))
    else:
        pos0 = np.full(B, n - 1)
        mlen0 = np.zeros(B)
        step_offset = 0
    pat = (TQ.pack_digits(dig, 4 if pack == 2 else 16)[0] if pack
           else dig)
    kw = dict(masked=carried, packed_out=mode != "planes",
              fresh_state=mode == "u16")
    return (dig, pat, lens, pos0.astype(np.int32), mlen0.astype(np.int32),
            step_offset, kw)


@pytest.mark.parametrize("seed,k,pack,mode,carried", POS_CASES)
def test_pos_scan_fuzz(seed, k, pack, mode, carried):
    """The port's scan (plain version) equals JAX's query_chunk_pos on the
    same table and digits; its batch and long-read drivers equal the
    port's oracle on every read."""
    import jax.numpy as jnp

    from colbwt_tpu.ops import query_pos as JQ

    rng, tbl, index, alphabet, reads = pos_case(seed, k, pack)
    pt = TQ.build_pos_tables(index, k, alphabet=alphabet, device="cpu")
    dig, pat, lens, pos0, mlen0, off, kw = scan_inputs(
        rng, index, pt, reads, k, pack, mode, carried)
    t = torch.from_numpy
    (gp, gc), (gpos, gml) = TQ.query_chunk_pos(
        pt["table"], pt["n"], t(pat), t(lens), t(pos0), t(mlen0), off, k,
        pt["A"], pack=pack, **kw)
    (wp, wc), (wpos, wml) = JQ.query_chunk_pos(
        jnp.asarray(pt["table"].numpy()), pt["n"], jnp.asarray(dig),
        jnp.asarray(lens), jnp.asarray(pos0), jnp.asarray(mlen0),
        jnp.int32(off), k=k, A=pt["A"], **kw)
    assert gp.numpy().dtype == np.asarray(wp).dtype
    np.testing.assert_array_equal(gp.numpy(), np.asarray(wp))
    if mode == "planes":
        np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))
    else:
        assert gc is None and wc is None
    np.testing.assert_array_equal(gpos.numpy(), np.asarray(wpos))
    np.testing.assert_array_equal(gml.numpy(), np.asarray(wml))

    short = [r[:252] for r in reads]
    for got, rds in ((TQ.query_batch(index, short, pt=pt), short),
                     (TQ.query_long_reads(index, reads, chunk=48 * k,
                                          pt=pt), reads)):
        for j, read in enumerate(rds):
            ep, ec = O.query_pml_oracle(tbl, read)
            np.testing.assert_array_equal(got[0][j], ep, err_msg=f"{j}")
            np.testing.assert_array_equal(got[1][j], ec, err_msg=f"{j}")


@pytest.mark.cuda
@pytest.mark.parametrize("seed,k,pack,mode,carried", POS_CASES)
def test_pos_scan_fuzz_cuda(dev, seed, k, pack, mode, carried):
    """K3 equals its plain version on the same cases, on the card."""
    rng, _, index, alphabet, reads = pos_case(seed, k, pack)
    pt = TQ.build_pos_tables(index, k, alphabet=alphabet, device=dev)
    _, pat, lens, pos0, mlen0, off, kw = scan_inputs(
        rng, index, pt, reads, k, pack, mode, carried)
    args = (pt["table"], pt["n"], to_device(pat, dev, np.uint8),
            to_device(lens, dev), to_device(pos0, dev),
            to_device(mlen0, dev), off, k, pt["A"])
    got = TQ.query_chunk_pos(*args, pack=pack, **kw)
    want = TQ.query_chunk_pos_ref(*args, pack=pack, **kw)
    for g, w in zip((*got[0], *got[1]), (*want[0], *want[1])):
        if w is None:
            assert g is None
            continue
        assert g.dtype == w.dtype and g.shape == w.shape
        if w.dtype == torch.uint16:
            g, w = g.view(torch.int16), w.view(torch.int16)
        assert torch.equal(g, w)


# ---------------------------------------------------------------------------
# K10a, the tunneled walk
# ---------------------------------------------------------------------------

# (seed, N, rate): N 1-8, rates 1-10
WALK_CASES = [(0xA1 + 13 * i, N, rate) for i, (N, rate) in enumerate(
    [(1, 1), (2, 10), (3, 2), (4, 10), (5, 3), (6, 7), (7, 1), (8, 10),
     (2, 5), (4, 1), (8, 4), (3, 9)])]


def walk_case(seed, N):
    """A random FL table (runs of 1-5 characters and 1-12 positions, some of
    them 40-200 long so that the fast-forward runs past its rows) and MUM
    starts: random ones, the last run's, within N - 1 of n and past it."""
    rng = np.random.default_rng(seed)
    r = int(rng.integers(1, 400))
    heads = rng.integers(2, 2 + int(rng.integers(1, 6)), r).astype(np.uint8)
    lens = rng.integers(1, 13, r)
    lens[rng.random(r) < 0.05] = rng.integers(40, 200)
    fl = O.build_fl_table(heads, lens.astype(np.int64))
    n, last = int(fl.n), int(fl.idx[-1])
    p0 = np.r_[rng.integers(0, n, 60), rng.integers(last, n, 4),
               np.arange(max(n - N + 1, 0), n), n, n + 3]
    mlens = rng.integers(1, 40, p0.size)
    return fl, p0.astype(np.int32), mlens.astype(np.int32), int(
        mlens.max()) + 2


@pytest.mark.parametrize("seed,N,rate", WALK_CASES)
def test_walk_fuzz(seed, N, rate):
    """The plain K10a equals JAX's _tunneled_walk and the kernel's NumPy
    model on random FL tables."""
    import jax.numpy as jnp

    from colbwt_tpu.ops import colsplit_jax as CS
    from tests.test_torch_colsplit import walk_model

    fl, p0, lens, T = walk_case(seed, N)
    fd = TCS.fl_tensors(fl, "cpu")
    got = TCS.tunneled_walk_ref(fd, torch.from_numpy(p0),
                                torch.from_numpy(lens), T, rate, N)
    want = CS._tunneled_walk(CS.fl_device_arrays(fl), jnp.asarray(p0),
                             jnp.asarray(lens), T, rate, N)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    pos, alive, _ = walk_model(fd["rows"].numpy(), p0, T, N)
    t = np.arange(T)[:, None]
    np.testing.assert_array_equal(pos, got[0].numpy())
    np.testing.assert_array_equal(
        alive & (t % rate == 0) & (t < lens[None, :]), got[1].numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("seed,N,rate", WALK_CASES)
def test_walk_fuzz_cuda(dev, seed, N, rate):
    """K10a equals its plain version on the same cases, on the card."""
    fl, p0, lens, T = walk_case(seed, N)
    fd = TCS.fl_tensors(fl, dev)
    args = (fd, to_device(p0, dev), to_device(lens, dev), T, rate, N)
    for g, w in zip(TCS.tunneled_walk(*args), TCS.tunneled_walk_ref(*args)):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# ---------------------------------------------------------------------------
# K4, the compact engine's scan
# ---------------------------------------------------------------------------

# (seed, ff_bound): the unsplit index (0) and indexes split to ff_bound 1-4
# (the split may achieve a larger bound; the scan takes the achieved one)
XLA_CASES = [(0x3C1 + 11 * i, ff) for i, ff in enumerate(
    [0, 0, 0, 1, 1, 2, 2, 2, 3, 3, 4, 4])]


def xla_case(seed, ff):
    """The case's table, its index (unsplit at ff 0, else
    ColPmlIndex.build(tbl, ff_bound=ff)), reads, their dense ids and
    lengths (as wide as the longest read, at least 1)."""
    tbl, reads, _ = random_case(np.random.default_rng(seed))
    index = (ColPmlIndex.from_table(tbl) if ff == 0
             else ColPmlIndex.build(tbl, ff_bound=ff))
    enc, lens = index.encode_patterns(
        reads, max(1, max(len(x) for x in reads)))
    return tbl, index, reads, enc, lens


@pytest.mark.parametrize("seed,ff", XLA_CASES)
def test_xla_scan_fuzz(seed, ff):
    """The plain K4 equals JAX's query_batch_device on the same index and
    ids, and every read's unpadded outputs equal the port's oracle."""
    import jax.numpy as jnp

    from colbwt_tpu.ops import query_xla as JX

    tbl, index, reads, enc, lens = xla_case(seed, ff)
    k = index.ff_bound  # the bound the split achieved, >= the one asked
    assert k >= ff and (k == 0) == (ff == 0)
    gp, gc = TX.query_batch_device(TT.index_tensors(index, "cpu"),
                                   torch.from_numpy(enc),
                                   torch.from_numpy(lens), ff_bound=k)
    wp, wc = JX.query_batch_device(JX.index_device_arrays(index),
                                   jnp.asarray(enc), jnp.asarray(lens),
                                   ff_bound=k)
    np.testing.assert_array_equal(gp.numpy(), np.asarray(wp))
    np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))
    M = enc.shape[1]
    for j, read in enumerate(reads):
        ep, ec = O.query_pml_oracle(tbl, read)
        np.testing.assert_array_equal(gp[j, M - len(read):].numpy(), ep)
        np.testing.assert_array_equal(gc[j, M - len(read):].numpy(), ec)


@pytest.mark.cuda
@pytest.mark.parametrize("seed,ff", XLA_CASES)
def test_xla_scan_fuzz_cuda(dev, seed, ff):
    """K4 equals its plain version on the same cases, on the card."""
    _, index, _, enc, lens = xla_case(seed, ff)
    tb = TT.index_tensors(index, dev)
    args = (tb, to_device(enc, dev), to_device(lens, dev))
    k = index.ff_bound
    for g, w in zip(TX.query_batch_device(*args, ff_bound=k),
                    TX.query_batch_device_ref(*args, ff_bound=k)):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)


# ---------------------------------------------------------------------------
# K5 and K6a, the mega and mega-wide scans (and the K13b/K13c chunk scan)
# ---------------------------------------------------------------------------

# (seed, layout, ff_bound, masked, carried, output mode): the narrow table
# and the wide full and compact layouts on a scaled table, ff_bound 2-4,
# masked and unmasked, fresh and carried state, every output mode
MEGA_CASES = [(0x5E1 + 17 * i, *s) for i, s in enumerate([
    ("narrow", 2, False, False, "u16"), ("narrow", 3, True, False, "planes"),
    ("narrow", 4, True, True, "i32"), ("narrow", 2, True, True, "planes"),
    ("full", 2, False, False, "planes"), ("full", 3, True, True, "i32"),
    ("full", 4, True, False, "u16"), ("full", 2, True, True, "planes"),
    ("compact", 2, True, False, "u16"), ("compact", 3, False, True, "i32"),
    ("compact", 4, True, True, "planes"), ("compact", 3, True, False,
                                            "i32")])]
MEGA_M = 64  # the chunk's columns; reads of 0, 1, M and more than M
MEGA_FIRST = 32  # the carried state's first chunk: step_offset 32


def mega_fuzz_case(seed, layout, ff):
    """The case's table as the engine sees it (the wide layouts: run
    lengths scaled as far as 2**29 allows, col ids taken mod 256 as the
    wide tables require), its index, and reads: the generator's, one of
    exactly MEGA_M characters and one of 3 * MEGA_M."""
    from chip_smoke import scale_table

    tbl, reads, docs = random_case(np.random.default_rng(seed))
    if layout != "narrow":
        tbl = scale_table(tbl, max(1, (1 << 29) // int(np.max(tbl.length))))
        ids = np.asarray(tbl.col_id)
        tbl.col_id = (ids.astype(np.int64) % 256).astype(ids.dtype)
    index = ColPmlIndex.build(tbl, ff_bound=ff, wide=layout != "narrow")
    text = b"".join(docs) * 4
    reads = reads + [text[:MEGA_M], text[:3 * MEGA_M]]
    return tbl, index, reads


def mega_inputs(index, reads, carried, mode):
    """The chunk's dense ids (each read's rightmost columns, right-aligned),
    the reads' full lengths and the keyword arguments of one setting."""
    first = MEGA_FIRST if carried else 0
    W = MEGA_M + first
    enc, _ = index.encode_patterns([r[-W:] for r in reads], W)
    lens = np.array([len(r) for r in reads], dtype=np.int32)
    kw = dict(packed_out=mode != "planes", fresh_state=mode == "u16")
    return enc.astype(np.uint8), lens, first, kw


def _mega_port(layout):
    from colbwt_tpu_torch.ops import query_mega as TM
    from colbwt_tpu_torch.ops import query_mega_wide as TW

    if layout == "narrow":
        return (lambda idx, dev: TM.build_mega_table(idx, device=dev),
                TM.query_chunk_mega, TM.query_chunk_mega_ref,
                TM.initial_state, TM)
    return (lambda idx, dev: TW.build_mega_table_wide(
        idx, compact=layout == "compact", device=dev),
        TW.query_chunk_mega_wide, TW.query_chunk_mega_wide_ref,
        TW.initial_state_wide, TW)


@pytest.mark.parametrize("seed,layout,ff,masked,carried,mode", MEGA_CASES)
def test_mega_scan_fuzz(seed, layout, ff, masked, carried, mode):
    """The plain K5 / K6a equals JAX's query_chunk_mega /
    query_chunk_mega_wide on the same index, ids and state (the carried
    state JAX's masked scan of the chunk right of it, so lanes of 32
    characters or fewer have ended), pad columns included; the port's
    query_batch and query_long_reads equal the port's oracle on every
    read."""
    import jax.numpy as jnp

    from colbwt_tpu.ops import query_mega as JM
    from colbwt_tpu.ops import query_mega_wide as JW

    tbl, index, reads = mega_fuzz_case(seed, layout, ff)
    build, kern, _, _, mod = _mega_port(layout)
    if layout == "narrow":
        jmt, jscan, jinit = JM.build_mega_table(index), \
            JM.query_chunk_mega, JM.initial_state
    else:
        jmt, jscan, jinit = JW.build_mega_table_wide(
            index, compact=layout == "compact"), JW.query_chunk_mega_wide, \
            JW.initial_state_wide
    mt = build(index, "cpu")
    enc, lens, first, kw = mega_inputs(index, reads, carried, mode)
    state = jinit(jmt, len(reads))
    if first:
        _, state = jscan(jmt, jnp.asarray(enc[:, MEGA_M:]), jnp.asarray(lens),
                         state, jnp.int32(0), ff_bound=index.ff_bound)
    cols = enc[:, :MEGA_M]
    (wp, wc), wst = jscan(jmt, jnp.asarray(cols), jnp.asarray(lens), state,
                          jnp.int32(first), ff_bound=index.ff_bound,
                          masked=masked, **kw)
    t = torch.from_numpy
    (gp, gc), gst = kern(mt, t(np.ascontiguousarray(cols)), t(lens),
                         tuple(t(np.array(s)) for s in state), first,
                         ff_bound=index.ff_bound, masked=masked, **kw)
    assert gp.numpy().dtype == np.asarray(wp).dtype
    np.testing.assert_array_equal(gp.numpy(), np.asarray(wp))
    if mode == "planes":
        np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))
    else:
        assert gc is None and wc is None
    for g, w in zip(gst, wst):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))

    short = [r[:255] for r in reads]
    for got, rds in ((mod.query_batch(index, short, mt=mt), short),
                     (mod.query_long_reads(index, reads, chunk=48, mt=mt),
                      reads)):
        for j, read in enumerate(rds):
            ep, ec = O.query_pml_oracle(tbl, read)
            np.testing.assert_array_equal(got[0][j], ep, err_msg=f"{j}")
            np.testing.assert_array_equal(got[1][j], ec, err_msg=f"{j}")


@pytest.mark.cuda
@pytest.mark.parametrize("seed,layout,ff,masked,carried,mode", MEGA_CASES)
def test_mega_scan_fuzz_cuda(dev, seed, layout, ff, masked, carried, mode):
    """K5 / K6a equal their plain versions on the same cases, on the card;
    on the narrow and full tables split over ip = 2 shards, the K13b/K13c
    chunk scan (always masked) equals its plain version too."""
    from colbwt_tpu_torch.parallel import query_sharded_mega as TSM

    _, index, reads = mega_fuzz_case(seed, layout, ff)
    build, kern, ref, init, _ = _mega_port(layout)
    mt = build(index, dev)
    enc, lens, first, kw = mega_inputs(index, reads, carried, mode)
    pats = to_device(enc, dev, np.uint8)
    lens_t = to_device(lens, dev)
    state = init(mt, len(reads))
    if first:
        _, state = ref(mt, pats[:, MEGA_M:].contiguous(), lens_t, state, 0,
                       ff_bound=index.ff_bound)
    args = (mt, pats[:, :MEGA_M].contiguous(), lens_t, state, first)
    got = kern(*args, ff_bound=index.ff_bound, masked=masked, **kw)
    want = ref(*args, ff_bound=index.ff_bound, masked=masked, **kw)
    for g, w in zip((*got[0], *got[1]), (*want[0], *want[1])):
        if w is None:
            assert g is None
            continue
        assert g.dtype == w.dtype and g.shape == w.shape
        if w.dtype == torch.uint16:
            g, w = g.view(torch.int16), w.view(torch.int16)
        assert torch.equal(g, w)
    if layout == "compact":
        return
    table = mt["mega"]
    L = -(-table.shape[0] // 2)
    shards = [table[:L].contiguous(), table[L:].contiguous()]
    if shards[1].shape[0] == 0:  # a table of one row: its own padding row
        shards[1] = torch.zeros((1, 16), dtype=torch.int32, device=dev)
    wide = layout != "narrow"
    n_lo, n_hi = (mt["n_lo"], mt["n_hi"]) if wide else (mt["n"], 0)
    outs = []
    for fn in (TSM.sharded_scan_mega, TSM.sharded_scan_mega_ref):
        st = tuple(t.clone() for t in state)
        outs.append(fn(shards, L, mt["length"], mt["r"], n_lo, n_hi, st,
                       args[1], lens_t, first, index.ff_bound, wide) + st)
    for g, w in zip(*outs):
        assert torch.equal(g, w)


# ---------------------------------------------------------------------------
# K7, the fused scan
# ---------------------------------------------------------------------------

# (seed, ff_bound): indexes split to ff_bound 1-4 (the split may achieve a
# larger bound; the scan takes the achieved one), three cases a bound
FUSED_CASES = [(0x7F1 + 13 * i, ff) for i, ff in enumerate(
    [1, 1, 1, 2, 2, 2, 3, 3, 3, 4, 4, 4])]


def fused_case(seed, ff):
    """The case's table, its index split to ff_bound `ff`, reads, their
    dense ids and lengths (as wide as the longest read, at least 1)."""
    tbl, reads, _ = random_case(np.random.default_rng(seed))
    index = ColPmlIndex.build(tbl, ff_bound=ff)
    enc, lens = index.encode_patterns(
        reads, max(1, max(len(x) for x in reads)))
    return tbl, index, reads, enc, lens


@pytest.mark.parametrize("seed,ff", FUSED_CASES)
def test_fused_scan_fuzz(seed, ff):
    """The plain K7 on the port's own tables (fused_rows, whose column 6
    holds length[clip(di)]) equals JAX's query_batch_fused on JAX's tables
    for the same index and ids, and every read's unpadded outputs equal
    the port's oracle."""
    import jax.numpy as jnp

    from colbwt_tpu.ops import query_fused as JF
    from colbwt_tpu_torch.ops import query_fused as TF

    tbl, index, reads, enc, lens = fused_case(seed, ff)
    k = index.ff_bound  # the bound the split achieved, >= the one asked
    assert k >= ff
    gp, gc = TF.query_batch_fused_ref(TF.build_fused_tables(index, "cpu"),
                                      torch.from_numpy(enc),
                                      torch.from_numpy(lens), ff_bound=k)
    wp, wc = JF.query_batch_fused(JF.build_fused_tables(index),
                                  jnp.asarray(enc), jnp.asarray(lens),
                                  ff_bound=k)
    np.testing.assert_array_equal(gp.numpy(), np.asarray(wp))
    np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))
    M = enc.shape[1]
    for j, read in enumerate(reads):
        ep, ec = O.query_pml_oracle(tbl, read)
        np.testing.assert_array_equal(gp[j, M - len(read):].numpy(), ep)
        np.testing.assert_array_equal(gc[j, M - len(read):].numpy(), ec)


@pytest.mark.cuda
@pytest.mark.parametrize("seed,ff", FUSED_CASES)
def test_fused_scan_fuzz_cuda(dev, seed, ff):
    """K7 equals its plain version on the same cases, on the card."""
    from colbwt_tpu_torch.ops import query_fused as TF

    _, index, _, enc, lens = fused_case(seed, ff)
    ft = TF.build_fused_tables(index, dev)
    args = (ft, to_device(enc, dev, np.uint8), to_device(lens, dev))
    k = index.ff_bound
    for g, w in zip(TF.query_batch_fused(*args, ff_bound=k),
                    TF.query_batch_fused_ref(*args, ff_bound=k)):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)
