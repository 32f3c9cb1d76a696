"""CUDA kernels K1-K14 (K13a-K13e and the K13b/K13c chunk scan among them)
against their plain PyTorch versions, on the card.

Marked `cuda`: skipped where CUDA is unavailable.  The file imports no JAX
(the machine with the card has none), so it runs there without the JAX
conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py -q

Every value is an integer, so every comparison is exact.
"""

import numpy as np
import pytest
import torch

from chip_smoke import scale_table
from colbwt_tpu_torch.models.index import ColPmlIndex
from colbwt_tpu_torch.ops import oracle as O
from colbwt_tpu_torch.models.tensors import index_tensors, to_device
from colbwt_tpu_torch.ops import _kernels as K
from colbwt_tpu_torch.ops import colsplit as TCS
from colbwt_tpu_torch.ops import construct as TC
from colbwt_tpu_torch.ops import query_fused as TF
from colbwt_tpu_torch.ops import query_mega as TM
from colbwt_tpu_torch.ops import query_mega_wide as TW
from colbwt_tpu_torch.ops import query_pos as TQ
from colbwt_tpu_torch.ops import query_xla as TX
from colbwt_tpu_torch.utils import xfer as TXF

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(0xC0DA)
    base = rng.choice(np.frombuffer(b"ACGT", np.uint8), 3000)
    docs = []
    for _ in range(3):
        a = base.copy()
        a[rng.integers(0, a.size, 60)] = rng.choice(
            np.frombuffer(b"ACGT", np.uint8), 60)
        docs.append(a.tobytes())
    text, ranks, doc_ids = O.concat_collection(docs)
    sa = O.suffix_array(ranks)
    lcp = O.lcp_kasai(ranks, sa)
    heads, lens = O.rle(O.bwt_from_sa(text, sa))
    fl = O.build_fl_table(heads, lens)
    ml, mp = O.find_multi_mums(ranks, sa, lcp, doc_ids, 3, 12)
    mpos, mids, mhts = O.col_split_oracle(fl, ml, mp, 3, 4, "tunnels")
    bits, ids = O.find_col_runs_oracle(mpos, mids, mhts, fl.l_heads, fl.n)
    tbl = O.build_col_pml(heads, lens, bits, ids,
                          O.compute_thresholds(heads, lens, lcp))
    reads = []
    for i in range(300):
        d = docs[i % 3]
        s = int(rng.integers(0, len(d) - 200))
        m = int(rng.integers(20, 200))
        r = bytearray(d[s:s + m])
        if i % 7 == 0:
            r[int(rng.integers(0, m))] = ord("N")
        reads.append(bytes(r))
    return tbl, ColPmlIndex.from_table(tbl), reads


def _equal(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert torch.equal(a, b)


def test_t1_chunks(dev, case):
    _, index, _ = case
    n, C = index.n, 1000
    a = TQ.t1_inputs(index, C, dev)
    for c in range(index.sigma + 1):
        pred = to_device(index.pred_jump[c], dev)
        succ = to_device(index.succ_jump[c], dev)
        for s in (0, 3000, n - C):
            args = (a["char"], a["idx_pad"], a["length"], a["lf_pos0"],
                    a["threshold"], pred, succ, a["col_id"], c, s, s, n, C)
            before = K.launches["build_t1_chunk"]
            got = TQ.build_t1_chunk(torch.zeros((n, 2), dtype=torch.int32,
                                                device=dev), *args)
            assert K.launches["build_t1_chunk"] == before + 1
            want = TQ.build_t1_chunk_ref(
                torch.zeros((n, 2), dtype=torch.int32, device=dev), *args)
            _equal(got, want)


def t1_case_docs(name: str) -> list[bytes]:
    """The collections of K1's edge cases (here and in
    tests/test_torch_query_pos.py), made from a seed: noisy copies of one
    base sequence, or a collection whose BWT has a run longer than 4,096."""
    rng = np.random.default_rng(sum(map(ord, name)))

    def acgt(m):
        return rng.choice(np.frombuffer(b"ACGT", np.uint8), m)

    if name == "long run":
        return [b"A" * 5000 + acgt(300).tobytes(), acgt(400).tobytes(),
                b"A" * 200 + acgt(100).tobytes()]
    base = acgt(60 if name == "n below the tile" else 2000)
    docs = []
    for _ in range(3):
        a = base.copy()
        a[rng.integers(0, a.size, a.size // 20)] = acgt(a.size // 20)
        docs.append(a.tobytes())
    return docs


# K1's edge cases: case -> (collection, ff_bound (None: no run split), the
# chunk sizes C (None: n)), each chunk at s = 0 and at the tail s = n - C
T1_CASES = {
    "runs of length 1": ("runs of length 1", 1, (1000, 4097)),
    "long run": ("long run", None, (None, 4097)),
    "n below the tile": ("n below the tile", None, (None, 50)),
    "C not a multiple of the tile": ("C", None, (5000, 3000)),
}


@pytest.mark.parametrize("name", sorted(T1_CASES))
def test_t1_edge_cases(dev, name):
    """K1 against its plain version for every char at the first and the
    tail chunk: every run of length 1 (ff_bound 1), a run longer than
    4,096 positions, n below 1,024, C not a multiple of 1,024 (the
    collections of tests/test_torch_query_pos.py's cases, built with the
    port's oracle)."""
    docs, ff, sizes = T1_CASES[name]
    text, ranks, _ = O.concat_collection(t1_case_docs(docs))
    sa = O.suffix_array(ranks)
    heads, lens = O.rle(O.bwt_from_sa(text, sa))
    tbl = O.build_col_pml(
        heads, lens, np.zeros(0, np.int64), np.zeros(0, np.int64),
        O.compute_thresholds(heads, lens, O.lcp_kasai(ranks, sa)))
    index = (ColPmlIndex.from_table(tbl) if ff is None
             else ColPmlIndex.build(tbl, ff_bound=ff))
    n = index.n
    assert name != "long run" or int(index.length.max()) > 4096
    assert name != "runs of length 1" or index.r == n
    for C in sizes:
        C = n if C is None else C
        a = TQ.t1_inputs(index, C, dev)
        for c in range(index.sigma + 1):
            pred = to_device(index.pred_jump[c], dev)
            succ = to_device(index.succ_jump[c], dev)
            for s in sorted({0, n - C}):
                args = (a["char"], a["idx_pad"], a["length"], a["lf_pos0"],
                        a["threshold"], pred, succ, a["col_id"], c, s, s, n,
                        C)
                got = TQ.build_t1_chunk(torch.zeros(
                    (n, 2), dtype=torch.int32, device=dev), *args)
                _equal(got, TQ.build_t1_chunk_ref(torch.zeros(
                    (n, 2), dtype=torch.int32, device=dev), *args))


@pytest.mark.parametrize("ka,kb", [(1, 1), (2, 1), (2, 2)])
def test_compose(dev, case, ka, kb):
    _, index, _ = case
    pt = {k: TQ.build_pos_tables(index, k, alphabet=b"ACGT", device=dev)
          for k in (1, 2)}
    ta, tb = pt[ka]["table"], pt[kb]["table"]
    _equal(TQ.compose_tables(ta, tb, index.n, 4, ka, kb),
           TQ.compose_tables_ref(ta, tb, index.n, 4, ka, kb))


@pytest.mark.parametrize("ka,kb", [(1, 1), (2, 1), (2, 2)])
@pytest.mark.parametrize("A", [4, 6])
@pytest.mark.parametrize("n", [1, 1001, 4100, 5001])
def test_compose_shapes(dev, ka, kb, A, n):
    """K2 on random words at every composition the port launches, A = 4
    (ACGT keys) and 6 (no alphabet), odd and even n over one or several
    tiles: a T_kb with rows past A**kb * n, and positions that run past
    their block or clamp at the table's end; one launch, the plain
    version's table."""
    rng = np.random.default_rng(n * 100 + A * 10 + ka * 2 + kb)

    def table(k, extra):
        rows = A ** k * n + extra
        pos = rng.integers(0, n, rows)
        wild = rng.random(rows) < 0.2  # past the block, most past the table
        pos[wild] = rng.integers(0, 1 << TQ.pos_bits(k), int(wild.sum()))
        w0 = (rng.integers(0, 1 << k, rows) << TQ.pos_bits(k)) | pos
        w1 = rng.integers(0, 1 << 32, rows)
        t = np.stack([w0, w1], axis=1).astype(np.uint32).view(np.int32)
        return torch.from_numpy(t).to(dev)

    ta, tb = table(ka, 0), table(kb, 37)
    want = TQ.compose_tables_ref(ta, tb, n, A, ka, kb)
    before = K.launches["compose_tables"]
    got = TQ.compose_tables(ta, tb, n, A, ka, kb)
    assert K.launches["compose_tables"] == before + 1
    _equal(got, want)


@pytest.mark.parametrize("k", [1, 2, 3, 4])
@pytest.mark.parametrize("pack", [0, 2])
@pytest.mark.parametrize("fresh", [True, False])
def test_scan(dev, case, k, pack, fresh):
    _, index, reads = case
    pt = TQ.build_pos_tables(index, k, alphabet=b"ACGT", device=dev)
    M = 204 if k == 3 else 200
    dig, lens, _ = TQ._encode_digits(index, pt, reads, M)
    B = dig.shape[0]
    rng = np.random.default_rng(k)
    pos0 = (np.full(B, index.n - 1) if fresh
            else rng.integers(0, index.n, B)).astype(np.int32)
    mlen0 = (np.zeros(B) if fresh else rng.integers(0, 999, B)).astype(
        np.int32)
    pat = TQ.pack_digits(dig, 4)[0] if pack else dig
    for packed_out in (False, True):
        args = (pt["table"], pt["n"], to_device(pat, dev, np.uint8),
                to_device(lens, dev), to_device(pos0, dev),
                to_device(mlen0, dev), 0 if fresh else 8, k, 4)
        kw = dict(masked=not fresh, packed_out=packed_out, fresh_state=fresh,
                  pack=pack)
        (gp, gc), (gpos, gml) = TQ.query_chunk_pos(*args, **kw)
        (wp, wc), (wpos, wml) = TQ.query_chunk_pos_ref(*args, **kw)
        _equal(gp, wp)
        if packed_out:
            assert gc is None and wc is None
        else:
            _equal(gc, wc)
        _equal(gpos, wpos)
        _equal(gml, wml)


def test_scan_dispatch_shape(dev, case):
    """The pos engine's batch as dispatch sends it: k = 4, reads padded to
    252 columns, 2-bit digits, fresh state, one packed uint16 plane."""
    _, index, reads = case
    pt = TQ.build_pos_tables(index, 4, alphabet=b"ACGT", device=dev)
    dig, lens, _ = TQ._encode_digits(index, pt, reads, 252)
    pat, pack = TQ.pack_digits(dig, 4)
    assert pack == 2
    B = dig.shape[0]
    args = (pt["table"], pt["n"], to_device(pat, dev, np.uint8),
            to_device(lens, dev),
            torch.full((B,), index.n - 1, dtype=torch.int32, device=dev),
            torch.zeros((B,), dtype=torch.int32, device=dev), 0, 4, 4)
    kw = dict(packed_out=True, fresh_state=True, pack=2)
    (gp, _), (gpos, gml) = TQ.query_chunk_pos(*args, **kw)
    (wp, _), (wpos, wml) = TQ.query_chunk_pos_ref(*args, **kw)
    assert gp.dtype == torch.uint16
    _equal(gp.view(torch.int16), wp.view(torch.int16))
    _equal(gpos, wpos)
    _equal(gml, wml)


def test_scan_general_t1(dev, case):
    """The fallback every read with a non-ACGT byte takes: the general T1
    over all sigma+1 chars, k = 1, dense ids unpacked, pml and cid planes."""
    tbl, index, reads = case
    pt = TQ.build_pos_tables(index, 4, alphabet=b"ACGT", device=dev)
    assert pt["t1"] is not None
    n_reads = [r for r in reads if b"N" in r]
    enc, lens = index.encode_patterns(n_reads, 252)
    B = enc.shape[0]
    args = (pt["t1"], pt["n"], to_device(enc, dev, np.uint8),
            to_device(lens, dev),
            torch.full((B,), index.n - 1, dtype=torch.int32, device=dev),
            torch.zeros((B,), dtype=torch.int32, device=dev), 0, 1,
            pt["A_full"])
    kw = dict(packed_out=False, fresh_state=True, pack=0)
    (gp, gc), (gpos, gml) = TQ.query_chunk_pos(*args, **kw)
    (wp, wc), (wpos, wml) = TQ.query_chunk_pos_ref(*args, **kw)
    for g, w in ((gp, wp), (gc, wc), (gpos, wpos), (gml, wml)):
        _equal(g, w)
    pml = gp.cpu().numpy()
    for b in range(0, B, 5):
        ep, _ = O.query_pml_oracle(tbl, n_reads[b])
        np.testing.assert_array_equal(pml[b, 252 - len(n_reads[b]):], ep)


# (ff_bound, M, B, patterns at a 4-byte offset): 8-, 4- and 1-column
# groups (M = 256, 252, 255; 128 reads past every 8-column group's
# columns), batches of no whole warp, and patterns that the vector loads
# cannot take (one column a group then)
COMPACT_SHAPES = [(0, 256, 300, False), (2, 256, 300, False),
                  (0, 252, 300, False), (3, 255, 300, False),
                  (2, 128, 77, False), (0, 256, 300, True),
                  (1, 7, 33, False)]


@pytest.mark.parametrize("ff,M,B,offset", COMPACT_SHAPES)
def test_compact_scan(dev, case, ff, M, B, offset):
    """K4 against its plain version on the unsplit index (ff_bound 0) and
    on indexes split to ff_bound 1-3, at each column grouping; reads with
    an N (a mismatch with neither succ nor pred), every read cut to M."""
    tbl, unsplit, reads = case
    index = ColPmlIndex.build(tbl, ff_bound=ff) if ff else unsplit
    k = index.ff_bound
    tb = index_tensors(index, dev)
    batch = [x[-M:] for x in reads[:B]]
    enc, lens = index.encode_patterns(batch, M)
    pats = to_device(enc, dev)
    if offset:  # a contiguous (B, M) view 4 bytes past 16-byte alignment
        pats = torch.empty(B * M + 1, dtype=torch.int32,
                           device=dev)[1:].view(B, M).copy_(pats)
    args = (tb, pats, to_device(lens, dev))
    before = K.launches["query_batch_xla"]
    got = TX.query_batch_device(*args, ff_bound=k)
    assert K.launches["query_batch_xla"] == before + 1
    want = TX.query_batch_device_ref(*args, ff_bound=k)
    for g, w in zip(got, want):
        _equal(g, w)
    pml = got[0].cpu().numpy()
    for b in range(0, B, 37):
        ep, _ = O.query_pml_oracle(tbl, batch[b])
        np.testing.assert_array_equal(pml[b, M - len(batch[b]):], ep)


# ---------------------------------------------------------------------------
# K5-K6c: the mega engines, on the run-split index and on the same table
# with run lengths scaled by 2**20 (n about 9.4e9, a wide index)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mega_case(dev, case):
    tbl, _, reads = case
    narrow = ColPmlIndex.build(tbl, ff_bound=2)
    big = scale_table(tbl, 1 << 20)
    wide = ColPmlIndex.build(big, ff_bound=2)
    assert not narrow.wide and wide.wide
    return tbl, big, narrow, wide, reads


def _mega_tables(index, dev, layout):
    if layout == "narrow":
        return TM.build_mega_table(index, device=dev)
    return TW.build_mega_table_wide(index, compact=layout == "compact",
                                    device=dev)


# (masked, packed_out, fresh_state, M, first): the smoke's shapes at a small
# batch — the dispatch batch (255 columns, u16 plane) unmasked and masked
# (as the engines scan it), one long-read chunk with carried state after a
# first chunk of `first` columns (int32 packed plane), and two planes
SETTINGS = {"dispatch": (False, True, True, 255, 0),
            "dispatch-masked": (True, True, True, 255, 0),
            "long-chunk": (True, True, False, 256, 256),
            "two-planes": (False, False, True, 255, 0)}


@pytest.mark.parametrize("layout,setting", [
    ("narrow", "dispatch"), ("narrow", "long-chunk"),
    ("narrow", "two-planes"), ("full", "dispatch"), ("full", "long-chunk"),
    ("compact", "dispatch"), ("compact", "long-chunk"),
    ("narrow", "dispatch-masked"), ("full", "dispatch-masked"),
    ("compact", "dispatch-masked")])
def test_mega_scan(dev, mega_case, layout, setting):
    """K5 (narrow) and K6a (full and compact wide layouts) against their
    plain versions: outputs, pad columns included, and the final state."""
    _, _, narrow, wide, reads = mega_case
    index = narrow if layout == "narrow" else wide
    mt = _mega_tables(index, dev, layout)
    mod = TM if layout == "narrow" else TW
    kern = mod.query_chunk_mega if layout == "narrow" \
        else mod.query_chunk_mega_wide
    ref = mod.query_chunk_mega_ref if layout == "narrow" \
        else mod.query_chunk_mega_wide_ref
    init = TM.initial_state if layout == "narrow" else TW.initial_state_wide
    masked, packed_out, fresh, M, first = SETTINGS[setting]
    rs = ([r * 3 for r in reads] if first else reads)
    enc, lens = index.encode_patterns([r[:M + first] for r in rs], M + first)
    pat = to_device(enc, dev, np.uint8)
    lens_t = to_device(lens, dev)
    state = init(mt, pat.shape[0])
    if first:
        _, state = ref(mt, pat[:, M:].contiguous(), lens_t, state, 0,
                       ff_bound=index.ff_bound)
    args = (mt, pat[:, :M].contiguous(), lens_t, state, first)
    kw = dict(ff_bound=index.ff_bound, masked=masked, packed_out=packed_out,
              fresh_state=fresh)
    name = "query_chunk_mega" if layout == "narrow" else \
        "query_chunk_mega_wide"
    before = K.launches[name]
    (gp, gc), gstate = kern(*args, **kw)
    assert K.launches[name] == before + 1
    (wp, wc), wstate = ref(*args, **kw)
    if gp.dtype == torch.uint16:
        gp, wp = gp.view(torch.int16), wp.view(torch.int16)
    _equal(gp, wp)
    if packed_out:
        assert gc is None and wc is None
    else:
        _equal(gc, wc)
    for g, w in zip(gstate, wstate):
        _equal(g, w)


def _lanes(reads, B):
    """B reads: `reads` repeated and cut to B."""
    return (reads * (B // len(reads) + 1))[:B]


def _mixed_lanes(reads, M, first):
    """300 lanes whose reads walk 0, 1, 150 (at most M) and M steps of a
    chunk at step_offset `first`, and more than fit it; some end at or
    before step_offset (lengths 0, first // 2 and first).  Returns the
    reads (each cut to the M + first columns the two chunks hold, the
    read's rightmost) and their full lengths."""
    text = b"".join(reads) * 4
    full = [0, 1, first // 2, first, first + 1, first + 150, first + M,
            first + M + 1000]
    lens = [full[i % len(full)] for i in range(300)]
    rs = [text[7 * i:7 * i + n][-(M + first):] for i, n in enumerate(lens)]
    return rs, np.array(lens, dtype=np.int32)


# output mode -> (packed_out, fresh_state, M)
MODES = {"two-planes": (False, False, 129), "packed-i32": (True, False, 129),
         "packed-u16": (True, True, 255)}


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("B", [1, 8193, "mixed"])
@pytest.mark.parametrize("layout", ["narrow", "full", "compact"])
def test_mega_scan_modes(dev, mega_case, layout, B, mode, masked):
    """K5 and K6a in every output mode, against their plain versions, at
    one lane, at 8,193 (no multiple of the block size) and on a batch of
    mixed lengths (lanes of 0, 1, 150 and M steps, some ended at or before
    step_offset; `_mixed_lanes`), masked and not.  The u16 plane scans
    from the fresh state; the others carry the state of a first chunk of
    96 columns (step_offset 96)."""
    _, _, narrow, wide, reads = mega_case
    index = narrow if layout == "narrow" else wide
    mt = _mega_tables(index, dev, layout)
    kern, ref, init, name = (
        (TM.query_chunk_mega, TM.query_chunk_mega_ref, TM.initial_state,
         "query_chunk_mega") if layout == "narrow" else
        (TW.query_chunk_mega_wide, TW.query_chunk_mega_wide_ref,
         TW.initial_state_wide, "query_chunk_mega_wide"))
    packed_out, fresh, M = MODES[mode]
    first = 0 if fresh else 96
    if B == "mixed":
        rs, lens = _mixed_lanes(reads, M, first)
        enc, _ = index.encode_patterns(rs, M + first)
        B = len(rs)
    else:
        rs = [r * 2 for r in _lanes(reads, B)]
        enc, lens = index.encode_patterns([r[:M + first] for r in rs],
                                          M + first)
    pat = to_device(enc, dev, np.uint8)
    lens_t = to_device(lens, dev)
    state = init(mt, B)
    if first:
        _, state = ref(mt, pat[:, M:].contiguous(), lens_t, state, 0,
                       ff_bound=index.ff_bound)
    args = (mt, pat[:, :M].contiguous(), lens_t, state, first)
    kw = dict(ff_bound=index.ff_bound, masked=masked, packed_out=packed_out,
              fresh_state=fresh)
    before = K.launches[name]
    (gp, gc), gstate = kern(*args, **kw)
    assert K.launches[name] == before + 1
    (wp, wc), wstate = ref(*args, **kw)
    assert gp.shape == (B, M) and gp.is_contiguous()
    assert gp.dtype == (torch.uint16 if mode == "packed-u16" else torch.int32)
    if gp.dtype == torch.uint16:
        gp, wp = gp.view(torch.int16), wp.view(torch.int16)
    _equal(gp, wp)
    assert (gc is None) == (wc is None) == packed_out
    if gc is not None:
        _equal(gc, wc)
    for g, w in zip(gstate, wstate):
        _equal(g, w)


@pytest.mark.parametrize("compact", [False, True])
def test_fill_block(dev, mega_case, compact):
    """K6b for every char block, the all-sentinel block c = sigma
    included, against the plain version (which recomputes the jump rows)."""
    _, _, _, index, _ = mega_case
    a = TW.run_arrays(index, dev)
    meta = TW._meta(index)
    width = 10 if compact else 16
    r = index.r
    for c in range(index.sigma + 1):
        args = (c, a, to_device(index.succ_jump[c], dev),
                to_device(index.pred_jump[c], dev), meta["n_lo"],
                meta["n_hi"], index.ff_bound, compact, c * r)
        got = TW.fill_block(torch.zeros(((index.sigma + 1) * r, width),
                                        dtype=torch.int32, device=dev), *args)
        want = TW.fill_block_ref(torch.zeros_like(got), *args)
        _equal(got, want)


def test_shared_table(dev, mega_case):
    _, _, _, index, _ = mega_case
    a = TW.run_arrays(index, dev)
    _equal(TW.shared_table(a), TW.shared_table_ref(a))


@pytest.mark.parametrize("compact", [False, True])
def test_wide_table_on_card_equals_cpu(dev, mega_case, compact):
    _, _, _, index, _ = mega_case
    got = TW.build_mega_table_wide(index, compact=compact, device=dev)
    want = TW.build_mega_table_wide(index, compact=compact, device="cpu")
    for key in ("mega", "shared", "percha", "length"):
        if key in want:
            _equal(got[key].cpu(), want[key])


@pytest.mark.parametrize("layout", ["narrow", "full", "compact"])
def test_mega_query_batch_matches_oracle(dev, mega_case, layout):
    tbl, big, narrow, wide, reads = mega_case
    index = narrow if layout == "narrow" else wide
    mt = _mega_tables(index, dev, layout)
    mod = TM if layout == "narrow" else TW
    pmls, cids = mod.query_batch(index, reads, mt=mt)
    oracle_tbl = tbl if layout == "narrow" else big
    for b in range(0, len(reads), 23):
        ep, ec = O.query_pml_oracle(oracle_tbl, reads[b])
        np.testing.assert_array_equal(pmls[b], ep)
        np.testing.assert_array_equal(cids[b], ec)


# ---------------------------------------------------------------------------
# K8-K10b: the build's multi-MUM window test and col-split walks
# ---------------------------------------------------------------------------

def _build_arrays(num_docs, base_len, seed):
    """Noisy copies of one random base (one substitution per 20 bases, one
    a copy beyond 8 copies, so that multi-MUMs survive):
    (ranks, sa, lcp, doc_ids, FL table)."""
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    base = rng.choice(acgt, base_len)
    docs = []
    for _ in range(num_docs):
        a = base.copy()
        k = 1 if num_docs > 8 else base_len // 20
        a[rng.integers(0, base_len, k)] = rng.choice(acgt, k)
        docs.append(a.tobytes())
    text, ranks, doc_ids = O.concat_collection(docs)
    sa = O.suffix_array(ranks)
    lcp = O.lcp_kasai(ranks, sa)
    heads, lens = O.rle(O.bwt_from_sa(text, sa))
    return ranks, sa, lcp, doc_ids, O.build_fl_table(heads, lens)


# mum_window's tile shapes (csrc/construct.cu kMumTile starts a block): a
# case's C and limit against the tile
MUM_TILE = 2048
MUM_SHAPES = {
    "C not a multiple of the tile, limit in the last tile":
        (3 * MUM_TILE + 100, 3 * MUM_TILE + 37),
    "shorter than a tile": (MUM_TILE // 2 - 3, MUM_TILE // 2 - 3),
    "limit -1": (MUM_TILE + 50, -1),
}


def span_shape(shape: str, N: int) -> tuple[int, int]:
    """(C, limit) of a large-N route case: the tile shapes, and four
    windows of N with limit in the last span."""
    if shape == "four windows of N":
        return 4 * N + 37, 4 * N + 32
    return MUM_SHAPES[shape]


SPAN_SHAPES = sorted(MUM_SHAPES) + ["four windows of N"]


def mum_synthetic(num_docs: int, C: int, limit: int, u16: bool, seed: int,
                  wide_ids: bool = False):
    """One chunk of C window starts and its 2N+2 halo made to reach every
    branch of the window test, padded past limit + N as
    find_multi_mums_chunked pads a chunk past n (lcp 0, documents 65535 or
    -1, run changes 1): lcp plateaus between drops N apart (uniq holds at
    each drop; a few lower values break ell >= 12), documents cycling
    through N ids, about one in 2N redrawn (windows that cover and windows
    that repeat), sparse run changes, and
    at some drops a window whose one run change is its last position or
    lies just outside it.  `wide_ids` adds 1,000 to every id (mask bits
    past 63: the probe decides).  (lcp_s, docs_s, chg_s) as numpy."""
    rng = np.random.default_rng(seed)
    N = num_docs
    L = C + 2 * N + 2
    lcp = rng.integers(12, 40, L)
    drops = np.arange(0, L, N)
    lcp[drops] = rng.integers(0, 10, drops.size)
    extra = rng.integers(0, L, L // (8 * N) + 1)
    lcp[extra] = rng.integers(0, 12, extra.size)
    docs = np.arange(L) % N
    redraw = rng.random(L) < 0.5 / N
    docs[redraw] = rng.integers(0, N, int(redraw.sum()))
    if wide_ids:
        docs += 1000
    chg = (rng.random(L) < 0.08).astype(np.uint8)
    for j, i in enumerate(drops[:-2][::3]):
        chg[i + 1:i + N] = 0
        if j % 2:
            chg[i + N - 1] = 1  # the window's last position
        else:
            chg[i] = chg[i + N] = 1  # just outside the window
    n_local = max(limit + N, 0)
    dt, fill = (np.uint16, 65535) if u16 else (np.int32, -1)
    lcp[n_local:] = 0
    docs[n_local:] = fill
    chg[n_local:] = 1
    return lcp.astype(np.int32), docs.astype(dt), chg


def argmin_case(name: str, P: int):
    """K12's cases for a tile of P positions (tiles start at lo[0] rounded
    down to a multiple of 32): (lcp int32, [(lo, hi) int64, ...]), each
    (lo, hi) one call's disjoint ascending segments."""
    rng = np.random.default_rng(0xA76)
    if name == "long segment, ties at tile edges":
        n = 10 * P + 71
        lcp = rng.integers(5, 50, n)
        lo0 = 64
        for k in (1, 2, 5):  # the minimum on both sides of three edges
            lcp[lo0 + k * P - 1] = lcp[lo0 + k * P] = 1
        return lcp.astype(np.int32), [(np.array([lo0]),
                                       np.array([n - 2]))]
    if name == "segments of length 1":
        n = 3 * P + 5
        pos = np.arange(1, n, 2)
        return (rng.integers(0, 4, n).astype(np.int32), [(pos, pos.copy())])
    if name == "one segment, the whole array":
        n = 4 * P + 1
        return (rng.integers(0, 3, n).astype(np.int32),
                [(np.array([0]), np.array([n - 1]))])
    if name == "m = 1 inside a tile":
        return (rng.integers(0, 9, 2 * P).astype(np.int32),
                [(np.array([P // 2]), np.array([P // 2 + 5]))])
    if name == "one lcp value":
        n = 5 * P + 11
        cuts = np.sort(rng.choice(np.arange(1, n), 40, replace=False))
        lo, hi = cuts[0:-1:2], cuts[1::2] - 1
        return np.full(n, 7, np.int32), [(lo, hi)]
    if name == "ends on tile edges":
        n = 6 * P + 64
        lo0 = 64
        starts = lo0 + np.array([0, P, 2 * P, 3 * P, 4 * P, 4 * P + 1])
        ends = np.r_[starts[1:] - 1, lo0 + 5 * P - 1]
        return rng.integers(0, 6, n).astype(np.int32), [(starts, ends)]
    if name == "negative lcp":
        n = 7 * P + 3
        cuts = np.sort(rng.choice(np.arange(n), min(300, n // 4 * 2),
                                  replace=False))
        lo, hi = cuts[0::2], cuts[1::2]
        return rng.integers(-50, 50, n).astype(np.int32), [(lo, hi)]
    raise KeyError(name)


ARGMIN_CASES = ("long segment, ties at tile edges", "segments of length 1",
                "one segment, the whole array", "m = 1 inside a tile",
                "one lcp value", "ends on tile edges", "negative lcp")


@pytest.mark.parametrize("u16", [True, False], ids=["uint16", "int32"])
@pytest.mark.parametrize("num_docs,base_len", [(2, 3000), (4, 2000),
                                                (16, 600), (65, 600),
                                                (130, 600)])
def test_mum_window(dev, num_docs, base_len, u16):
    """K8 chunk by chunk (C = 2**13 with the 2N+2 halo) and K9 (the whole
    array as one chunk) against their plain versions, and the device
    find_multi_mums against the oracle."""
    ranks, sa, lcp, doc_ids, _ = _build_arrays(num_docs, base_len, num_docs)
    N, C = num_docs, 1 << 13
    halo = 2 * N + 2
    n = sa.size
    prev_rank = ranks[sa - 1]
    sa_docs = doc_ids[sa]
    rc = np.ones(n, dtype=np.uint8)
    rc[1:] = prev_rank[1:] != prev_rank[:-1]
    dt, fill = (np.uint16, 65535) if u16 else (np.int32, -1)
    for s in range(0, n, C):
        def sl(a, f, dtype):
            x = np.asarray(a[s:s + C + halo]).astype(dtype)
            return torch.from_numpy(np.concatenate(
                [x, np.full(C + halo - x.size, f, dtype)])).to(dev)
        args = (sl(lcp, 0, np.int32), sl(sa_docs, fill, dt),
                sl(rc, 1, np.uint8), min(n - N - s, C), 8, N)
        before = K.launches["mum_window"]
        got = TC.mum_scan_chunk(*args)
        assert K.launches["mum_window"] == before + 1
        want = TC.mum_scan_chunk_ref(*args)
        for g, w in zip(got, want):
            _equal(g, w)
    t = [to_device(a, dev) for a in (lcp, sa_docs, prev_rank)]
    got = TC.multi_mum_scan(*t, N, 8)
    want = TC.multi_mum_scan_ref(*t, N, 8)
    for g, w in zip(got, want):
        _equal(g, w)
    ml, mp = O.find_multi_mums(ranks, sa, lcp, doc_ids, N, 8)
    assert ml.size > 0
    for g, w in zip(TC.find_multi_mums(ranks, sa, lcp, doc_ids, N, 8,
                                       device=dev), (ml, mp)):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("wide_ids", [False, True], ids=["ids", "wide ids"])
@pytest.mark.parametrize("u16", [True, False], ids=["uint16", "int32"])
@pytest.mark.parametrize("num_docs", [2, 4, 16, 65, 130])
@pytest.mark.parametrize("shape", sorted(MUM_SHAPES))
def test_mum_window_tiles(dev, shape, num_docs, u16, wide_ids):
    """The window test at the tile's edges, one launch each: C not a
    multiple of the tile with limit in the last tile, a chunk shorter than
    a tile, limit -1; synthetic chunks that reach every branch of the
    window test (ids past 63 included), against the plain version.  Up to
    _TILE_MAX_N (64) documents the tile route runs, past it (65, 130) the
    large-N route."""
    C, limit = MUM_SHAPES[shape]
    a = mum_synthetic(num_docs, C, limit, u16, num_docs, wide_ids)
    args = (*(to_device(x, dev, x.dtype) for x in a), limit, 12, num_docs)
    before = K.launches["mum_window"]
    got = TC.mum_scan_chunk(*args)
    assert K.launches["mum_window"] == before + 1
    want = TC.mum_scan_chunk_ref(*args)
    for g, w in zip(got, want):
        _equal(g, w)
    if limit >= 0:
        bits = np.unpackbits(want[0].cpu().numpy(), bitorder="little")
        assert bits.sum() > 0


@pytest.mark.parametrize("u16", [True, False], ids=["uint16", "int32"])
def test_mum_window_large_n_route(dev, monkeypatch, u16):
    """The two-pass kernels (the route above _TILE_MAX_N), with the
    constant lowered: chunks and the K9 route against their plain versions,
    and find_multi_mums against the oracle."""
    monkeypatch.setattr(TC, "_TILE_MAX_N", 3)
    for num_docs in (4, 16):
        assert TC.mum_window_route(num_docs) == "two-pass"
        C, limit = MUM_SHAPES["C not a multiple of the tile, limit in the "
                              "last tile"]
        a = mum_synthetic(num_docs, C, limit, u16, 7)
        args = (*(to_device(x, dev, x.dtype) for x in a), limit, 12,
                num_docs)
        for g, w in zip(TC.mum_scan_chunk(*args),
                        TC.mum_scan_chunk_ref(*args)):
            _equal(g, w)
        ranks, sa, lcp, doc_ids, _ = _build_arrays(num_docs, 1500, num_docs)
        prev_rank = ranks[sa - 1]
        t = [to_device(x, dev) for x in (lcp, doc_ids[sa], prev_rank)]
        for g, w in zip(TC.multi_mum_scan(*t, num_docs, 8),
                        TC.multi_mum_scan_ref(*t, num_docs, 8)):
            _equal(g, w)
        ml, mp = O.find_multi_mums(ranks, sa, lcp, doc_ids, num_docs, 8)
        assert ml.size > 0
        for g, w in zip(TC.find_multi_mums(ranks, sa, lcp, doc_ids, num_docs,
                                           8, device=dev), (ml, mp)):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("u16", [True, False], ids=["uint16", "int32"])
@pytest.mark.parametrize("num_docs", [1025, 10_000])
@pytest.mark.parametrize("shape", SPAN_SHAPES)
def test_mum_window_span_route(dev, shape, num_docs, u16):
    """The large-N route as the wrapper picks it (no switch lowered), one
    call each: N = 1,025 (tiles of 512) and config #3's N = 10,000 (tiles
    of the span, a core every block reduces), C < N, C not a multiple of
    the span, limit -1, four windows of N; against the plain version."""
    assert TC.mum_window_route(num_docs) == "two-pass"
    C, limit = span_shape(shape, num_docs)
    a = mum_synthetic(num_docs, C, limit, u16, num_docs)
    args = (*(to_device(x, dev, x.dtype) for x in a), limit, 12, num_docs)
    before = K.launches["mum_window"]
    got = TC.mum_scan_chunk(*args)
    assert K.launches["mum_window"] == before + 1
    want = TC.mum_scan_chunk_ref(*args)
    for g, w in zip(got, want):
        _equal(g, w)
    if shape == "four windows of N":
        bits = np.unpackbits(want[0].cpu().numpy(), bitorder="little")
        assert bits.sum() > 0


def test_mum_window_chunked_route(dev, monkeypatch):
    """find_multi_mums with the chunked route forced (several chunks of
    C = 2**13) equals the oracle."""
    monkeypatch.setattr(TC, "_CHUNKED_SCAN_MIN_N", 1 << 10)
    ranks, sa, lcp, doc_ids, _ = _build_arrays(5, 5000, 7)
    assert sa.size > 2 * (1 << 13)
    want = O.find_multi_mums(ranks, sa, lcp, doc_ids, 5, 10)
    got = TC.find_multi_mums(ranks, sa, lcp, doc_ids, 5, 10, device=dev)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def _walk_case(dev, num_docs, base_len, min_mum):
    ranks, sa, lcp, doc_ids, fl = _build_arrays(num_docs, base_len,
                                                100 + num_docs)
    ml, mp = O.find_multi_mums(ranks, sa, lcp, doc_ids, num_docs, min_mum)
    assert ml.size > 0
    order = np.argsort(mp, kind="stable")
    return (fl, ml, mp, TCS.fl_tensors(fl, dev), to_device(mp[order], dev),
            to_device(ml[order], dev), int(ml.max()))


@pytest.mark.parametrize("rate", [1, 10])
def test_tunneled_walk(dev, rate):
    fl, ml, mp, fd, p0, lens, T = _walk_case(dev, 4, 3000, 8)
    before = K.launches["tunneled_walk"]
    got = TCS.tunneled_walk(fd, p0, lens, T + 5, rate, 4)
    assert K.launches["tunneled_walk"] == before + 1
    for g, w in zip(got, TCS.tunneled_walk_ref(fd, p0, lens, T + 5, rate,
                                               4)):
        _equal(g, w)
    want = O.col_split_oracle(fl, ml, mp, 4, rate, "tunnels")
    for g, w in zip(TCS.col_split(fl, ml, mp, 4, rate, "tunnels",
                                  device=dev), want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("num_docs,base_len,rate", [
    (3, 2000, 2), (4, 2000, 10), (5, 600, 1), (31, 300, 10), (32, 300, 1),
    (33, 300, 2), (64, 200, 10)])
def test_all_walk(dev, num_docs, base_len, rate):
    """K10b on a collection's MUMs: N not a power of two (lanes of a warp
    left over), one MUM filling a warp, two walkers a lane past 32; the
    col-split through it equals the oracle."""
    fl, ml, mp, fd, p0, lens, T = _walk_case(dev, num_docs, base_len, 6)
    before = K.launches["all_walk"]
    got = TCS.all_walk(fd, p0, lens, T, rate, num_docs)
    assert K.launches["all_walk"] == before + 1
    for g, w in zip(got, TCS.all_walk_ref(fd, p0, lens, T, rate,
                                          num_docs)):
        _equal(g, w)
    want = O.col_split_oracle(fl, ml, mp, num_docs, rate, "all")
    for g, w in zip(TCS.col_split(fl, ml, mp, num_docs, rate, "all",
                                  device=dev), want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("num_docs", [1, 2, 3, 4, 31, 32, 33, 64])
@pytest.mark.parametrize("rate", [1, 10])
def test_all_walk_edges(dev, num_docs, rate):
    """K10b on a random FL table (runs up to 200 long, so that the
    fast-forward runs past its rows) from the walk's edge starts: random,
    the last run, within N - 1 of n, past n, negative (u == 0) and near
    2**31 (wrapping sums); lengths 0 and past T among them."""
    from test_torch_fuzz import walk_case

    fl, p0, lens, T = walk_case(0xE6 + num_docs, num_docs)
    p0 = np.r_[p0, -1, -40, (1 << 31) - 1, (1 << 31) - num_docs,
               -(1 << 31)].astype(np.int32)
    lens = np.r_[lens, 0, T + 9, 3, 5, 7].astype(np.int32)
    fd = TCS.fl_tensors(fl, dev)
    args = (fd, to_device(p0, dev), to_device(lens, dev), T, rate, num_docs)
    for g, w in zip(TCS.all_walk(*args), TCS.all_walk_ref(*args)):
        _equal(g, w)


# ---------------------------------------------------------------------------
# K7: the fused scan; K14: the chunked upload
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ff", [1, 2, 3])
@pytest.mark.parametrize("B,M", [(1, 256), (8193, 255), (32768, 256)])
def test_fused_scan_shapes(dev, case, B, M, ff):
    """K7 against its plain version at one lane, at 8,193 lanes (no
    multiple of the block size) with an odd M, and at the streamed
    engine's batch, 32,768 x 256: the column-major planes and their
    transposes; uint8 ids as the engine uploads them and int32 ids as
    other callers pass them."""
    tbl, _, reads = case
    index = ColPmlIndex.build(tbl, ff_bound=ff)
    ft = TF.build_fused_tables(index, dev)
    enc, lens = index.encode_patterns(_lanes(reads, B), M)
    lens_t = to_device(lens, dev)
    want = None
    for dtype in (np.uint8, np.int32):
        args = (ft, to_device(enc, dev, dtype), lens_t)
        before = K.launches["query_batch_fused"]
        got = TF.query_batch_fused(*args, ff_bound=ff)
        assert K.launches["query_batch_fused"] == before + 1
        if want is None:
            want = TF.query_batch_fused_ref(*args, ff_bound=ff)
        for g, w in zip(got, want):
            assert g.shape == (B, M) and g.is_contiguous()
            _equal(g, w)


@pytest.mark.parametrize("ff", [1, 2, 4])
def test_fused_scan(dev, case, ff):
    """K7 against its plain version on run-split indexes, reads of mixed
    lengths padded into one batch (N reads included), and the oracle."""
    tbl, _, reads = case
    index = ColPmlIndex.build(tbl, ff_bound=ff)
    ft = TF.build_fused_tables(index, dev)
    enc, lens = index.encode_patterns(reads, 256)
    args = (ft, to_device(enc, dev), to_device(lens, dev))
    before = K.launches["query_batch_fused"]
    got = TF.query_batch_fused(*args, ff_bound=index.ff_bound)
    assert K.launches["query_batch_fused"] == before + 1
    want = TF.query_batch_fused_ref(*args, ff_bound=index.ff_bound)
    for g, w in zip(got, want):
        _equal(g, w)
    pml, cid = (t.cpu().numpy() for t in got)
    for b in range(0, len(reads), 37):
        ep, ec = O.query_pml_oracle(tbl, reads[b])
        np.testing.assert_array_equal(pml[b, 256 - len(reads[b]):], ep)
        np.testing.assert_array_equal(cid[b, 256 - len(reads[b]):], ec)


@pytest.mark.parametrize("shape,dtype,cast", [
    ((1000, 8), np.int32, None), ((12345,), np.uint8, None),
    ((777, 3), np.int64, np.int32), ((5,), np.uint16, None)])
def test_upload_rows(dev, tmp_path, shape, dtype, cast):
    """K14 equals the plain version byte for byte, from a memory map too,
    with chunks far smaller than the array."""
    rng = np.random.default_rng(14)
    a = rng.integers(0, 200, shape).astype(dtype)
    np.save(tmp_path / "a.npy", a)
    for src in (a, np.load(tmp_path / "a.npy", mmap_mode="r")):
        before = K.launches["upload_rows"]
        got = TXF.upload_chunked(src, dev, chunk_bytes=1000, dtype=cast)
        assert K.launches["upload_rows"] > before
        want = TXF.upload_chunked_ref(src, dev, chunk_bytes=1000, dtype=cast)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())
        np.testing.assert_array_equal(got.cpu().numpy(),
                                      a.astype(cast or dtype))


# 2 MB slices and up to 8 host threads (csrc/xfer.cu): 9 slices and 12,345
# bytes are no multiple of either
_ODD_BYTES = 9 * (2 << 20) + 12_345


def _upload_source(kind: str, tmp_path):
    """(source array, dtype to cast to or None) for one kind of source."""
    rng = np.random.default_rng(0x14)
    a = rng.integers(0, 256, _ODD_BYTES, dtype=np.uint8)
    if kind == "pinned":
        t = torch.from_numpy(a).pin_memory()
        return t.numpy(), None
    if kind == "unaligned":
        buf = np.empty(a.size + 1, np.uint8)
        buf[1:] = a
        assert buf[1:].ctypes.data % 16
        return buf[1:], None
    if kind == "memmap":
        np.save(tmp_path / "a.npy", a)
        return np.load(tmp_path / "a.npy", mmap_mode="r"), None
    if kind == "cast":
        rows = a[:a.size // 16 * 16].view(np.int32).reshape(-1, 4)
        return rows.astype(np.int64), np.int32
    if kind == "zero rows":
        return np.empty((0, 8), np.int32), None
    return a, None  # "pageable"


@pytest.mark.parametrize("kind", ["pageable", "pinned", "unaligned",
                                  "memmap", "cast", "zero rows"])
def test_upload_rows_sources(dev, tmp_path, kind):
    """K14 at its default 16 MB chunks over a size no multiple of a slice
    or a thread's share: a pinned source (one DMA), a pointer not 16-byte
    aligned, a memory map, a cast and zero rows, equal to the plain
    version and the source."""
    src, cast = _upload_source(kind, tmp_path)
    before = K.launches["upload_rows"]
    got = TXF.upload_chunked(src, dev, dtype=cast)
    # one launch for the whole source; a cast, one for each 16 MB slice
    # cast on the host
    rows = TXF.CHUNK_BYTES // (got.element_size() * got.shape[-1])
    calls = 0 if kind == "zero rows" else (
        1 if cast is None else -(-got.shape[0] // rows))
    assert K.launches["upload_rows"] - before == calls
    want = TXF.upload_chunked_ref(src, dev, dtype=cast)
    _equal(got, want)
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  np.asarray(src).astype(cast or src.dtype))


def test_upload_rows_second_card():
    """K14 to cuda:1, its pool's threads on that card, and to cuda:0
    right after; skipped with one card."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    a = np.random.default_rng(1).integers(0, 256, _ODD_BYTES, dtype=np.uint8)
    for name in ("cuda:1", "cuda:0"):
        d = torch.device(name)
        got = TXF.upload_chunked(a, d)
        assert got.device == d
        np.testing.assert_array_equal(got.cpu().numpy(), a)


# ---------------------------------------------------------------------------
# K11a, K11b: the suffix array by prefix doubling and the LCP by lifting;
# K12: the thresholds' segmented first argmin
# ---------------------------------------------------------------------------

def _round_equal(rank, k, max_rank, order=None, ws=None):
    before = K.launches["doubling_round"]
    got = TC.doubling_round(rank, k, max_rank, order, ws)
    assert K.launches["doubling_round"] == before + 1
    want = TC.doubling_round_ref(rank, k)
    for g, w in zip(got, want):
        _equal(g, w)
    return got


def _argsort(rank):
    return torch.sort(rank, stable=True).indices.to(torch.int32)


@pytest.mark.parametrize("n", [1, 2, 4095, 4096, 4097, 3 * 4096 + 5,
                               (1 << 20) + 3, (1 << 24) + 7])
def test_doubling_round(dev, n):
    """K11a against its plain version with and without the previous order,
    on ranks all equal, with few values and with n values: n = 1, 2, a
    radix tile and either side of it, several tiles, and 2**20 + 3 and
    2**24 + 7 positions; k below n and k >= n (the first pass reads up to
    2n positions)."""
    rng = np.random.default_rng(n)
    ws = TC.DoublingWorkspace(n, dev)
    for top in (1, 7, n):
        rank = to_device(rng.integers(0, top, n), dev)
        order = _argsort(rank)
        for k in sorted({1, 2, max(1, n // 3), n, n + 1}):
            _round_equal(rank, k, int(rank.max()))
            _round_equal(rank, k, int(rank.max()), order, ws)


@pytest.mark.parametrize("bits", list(range(0, 32)))
def test_doubling_round_key_bits(dev, bits):
    """Keys of 0 to 31 bits (every pass count, 1 to 4, and every digit
    width of a last pass), with and without the order, one workspace."""
    n = 50_000
    rng = np.random.default_rng(bits)
    top = 1 << bits
    r = rng.integers(0, top, n, dtype=np.int64)
    r[n // 2] = top - 1
    rank = to_device(r, dev)
    assert int(rank.max()).bit_length() == bits
    ws = TC.DoublingWorkspace(n, dev)
    for k in (1, 16, n):
        _round_equal(rank, k, top - 1)
        _round_equal(rank, k, top - 1, _argsort(rank), ws)


def test_suffix_array_rounds(dev):
    """Every round of a full sequence, each handed the previous round's
    order and one workspace as suffix_array does, held against the plain
    version on the same input, then the suffix array against the oracle's
    and K11b's LCP against its plain version and Kasai's."""
    rng = np.random.default_rng(0x11A)
    base = rng.choice(np.frombuffer(b"ACGT", np.uint8), 5000)
    docs = [base.tobytes(), base[::-1].tobytes(), base[1000:].tobytes()]
    _, ranks, _ = O.concat_collection(docs)
    n = ranks.size
    rank = to_device(ranks, dev)
    ws = TC.DoublingWorkspace(n, dev)
    max_rank, k, pyramid, sa = int(ranks.max()), 1, [], None
    for _ in range(int(np.ceil(np.log2(n)))):
        sa, rank, top = _round_equal(rank, k, max_rank, sa, ws)
        pyramid.append(rank)
        max_rank, k = int(top), 2 * k
        if max_rank == n - 1:
            break
    assert max_rank == n - 1 and len(pyramid) > 8  # long repeats
    before = K.launches["doubling_round"]
    got_sa, _, got_pyr = TC.suffix_array(ranks, with_pyramid=True,
                                         device=dev)
    assert K.launches["doubling_round"] - before == len(pyramid)
    _equal(got_sa, sa)
    assert len(got_pyr) == len(pyramid)
    for g, w in zip(got_pyr, pyramid):
        _equal(g, w)
    want_sa = O.suffix_array(ranks)
    np.testing.assert_array_equal(sa.cpu().numpy(), want_sa)
    r0 = to_device(ranks, dev)
    before = K.launches["lcp_lift"]
    lcp = TC.lcp_from_pyramid(r0, sa, pyramid)
    assert K.launches["lcp_lift"] == before + 1
    _equal(lcp, TC.lcp_from_pyramid_ref(r0, sa, pyramid))
    np.testing.assert_array_equal(lcp.cpu().numpy(),
                                  O.lcp_kasai(ranks, want_sa))


def _lcp_texts(name):
    """Texts that break a walk in text order: one letter, short periods,
    heavy repeats, tiny and power-of-two-adjacent n, and collections of
    n >= 2**18 (haplotypes of one base, and random text)."""
    rng = np.random.default_rng(0x11B)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    if isinstance(name, int):  # one document making n = name positions
        return [rng.choice(acgt, name - 1).tobytes()]
    if name == "haplotypes":
        base = rng.choice(acgt, 20_000)
        docs = []
        for _ in range(16):
            a = base.copy()
            a[rng.integers(0, a.size, 400)] = rng.choice(acgt, 400)
            docs.append(a.tobytes())
        return docs
    return {"one letter": [b"A" * 40_000],
            "period 2": [b"AC" * 20_000],
            "period 3": [b"ACG" * 10_000, b"ACGA" * 3_000],
            "repetitive": [b"ACGT" * 30, b"ACGT" * 30 + b"A",
                           b"ACGTACGT" * 15],
            "random": [rng.choice(acgt, 300_000).tobytes()]}[name]


@pytest.mark.parametrize("levels", [None, 1, 3])
@pytest.mark.parametrize("name", ["one letter", "period 2", "period 3",
                                  "repetitive", 1, 2, 4095, 4097,
                                  "haplotypes", "random"], ids=str)
def test_lcp_walk(dev, name, levels):
    """K11b on the whole pyramid (its top level the inverse suffix array)
    and on its first levels (the cap binds; the entry point scatters the
    inverse first; none at n = 1 and 2), against the plain lift, one
    launch a call."""
    _, ranks, _ = O.concat_collection(_lcp_texts(name))
    n = ranks.size
    sa, _, pyramid = TC.suffix_array(ranks, with_pyramid=True, device=dev)
    if levels is not None:  # no level at all where n has fewer
        pyramid = pyramid[:min(levels, len(pyramid) - 1)]
    r0 = to_device(ranks, dev)
    before = K.launches["lcp_lift"]
    lcp = TC.lcp_from_pyramid(r0, sa, pyramid)
    assert K.launches["lcp_lift"] == before + 1
    _equal(lcp, TC.lcp_from_pyramid_ref(r0, sa, pyramid))
    if levels is None and n > 1:
        np.testing.assert_array_equal(
            lcp.cpu().numpy(), O.lcp_kasai(ranks, sa.cpu().numpy()))


@pytest.mark.parametrize("lcp_top", [4, 1 << 20])
def test_segmented_argmin(dev, case, lcp_top):
    """K12 against its plain version for every character's segments of the
    case's BWT, with an lcp of few values (many ties) and of many; then
    compute_thresholds on the card against the oracle."""
    tbl, _, _ = case
    heads, lens = tbl.char, tbl.length
    n = int(lens.sum())
    lcp = np.random.default_rng(lcp_top).integers(0, lcp_top, n)
    lcp_t = to_device(lcp, dev)
    segs = TC.threshold_segments(heads, lens)
    assert max(int((hi - lo).max()) for _, lo, hi in segs) > 64
    for _, lo, hi in segs:
        args = (lcp_t, to_device(lo, dev, np.int64),
                to_device(hi, dev, np.int64))
        before = K.launches["segmented_argmin"]
        got = TC.segmented_argmin(*args)
        assert K.launches["segmented_argmin"] == before + 1
        _equal(got, TC.segmented_argmin_ref(*args))
    np.testing.assert_array_equal(
        TC.compute_thresholds(heads, lens, lcp, device=dev),
        O.compute_thresholds(heads, lens, lcp))


@pytest.mark.parametrize("name", ARGMIN_CASES)
def test_segmented_argmin_tiles(dev, name):
    """K12 at its tile's edges (the shipped tile, TC._ARGMIN_TILE): a
    segment over many tiles with its minimum tied on both sides of three
    tile edges (the first wins), segments of length 1, one segment the
    whole array, m = 1, one lcp value (ties everywhere), segment ends on
    tile edges, negative lcp; one call (two launches) each, against the
    plain version; the workspace's keys are all ones again after each."""
    lcp, segs = argmin_case(name, TC._ARGMIN_TILE)
    lcp_t = to_device(lcp, dev)
    ws = TC.ArgminWorkspace(lcp.size, dev)
    for lo, hi in segs:
        args = (lcp_t, to_device(lo, dev, np.int64),
                to_device(hi, dev, np.int64))
        before = K.launches["segmented_argmin"]
        got = TC.segmented_argmin(*args, ws)
        assert K.launches["segmented_argmin"] == before + 1
        _equal(got, TC.segmented_argmin_ref(*args))
        assert bool((ws.keys == -1).all())


# ---------------------------------------------------------------------------
# K13a-K13e: the sharded engines, their ip shards as separate tensors on the
# one card (make_mesh over ["cuda:0"] * ip)
# ---------------------------------------------------------------------------

def _mesh(ip, dp=1):
    from colbwt_tpu_torch.parallel import make_mesh

    return make_mesh(dp, ip, devices=["cuda:0"] * (dp * ip))


@pytest.mark.parametrize("ip", [1, 2, 4, 8])
@pytest.mark.parametrize("W,jump", [(2, False), (2, True), (8, False),
                                    (8, True), (16, False), (16, True)])
@pytest.mark.parametrize("B", [0, 1, 4097])
def test_sharded_fetch(dev, ip, W, jump, B):
    """The masked gather of all the shards a card holds, in one launch:
    some lanes owned by none (below 0, past the last shard), a selector
    with a stride; equal to its plain version and to the whole table's
    gather; with half the shards on another card (None), one launch that
    reads only the lanes of this card's shards into `out`."""
    from colbwt_tpu_torch.parallel.mesh import (sharded_fetch,
                                                sharded_fetch_ref)

    rng = np.random.default_rng(ip * 131 + W * 7 + jump + B)
    L, sel = -(-1000 // ip), 3
    full = rng.integers(-2**31, 2**31 - 1, (sel, L * ip, W), dtype=np.int64)
    full = torch.from_numpy(full.astype(np.int32))
    g = to_device(rng.integers(-7, L * ip + 7, B), dev)
    s = to_device(rng.integers(0, sel, B), dev) if jump else None
    shards = [(full[:, i * L:(i + 1) * L] if jump
               else full[0, i * L:(i + 1) * L]).reshape(-1, W)
              .contiguous().to(dev) for i in range(ip)]
    stride = L if jump else 0
    before = K.launches["sharded_fetch"]
    got = sharded_fetch(shards, g, s, L, stride)
    assert K.launches["sharded_fetch"] == before + (1 if B else 0)
    _equal(got, sharded_fetch_ref(shards, g, s, L, stride))
    gc = g.cpu().long()
    ok = (gc >= 0) & (gc < L * ip)
    if B > 1:
        assert 0 < int(ok.sum()) < B
    want = full[s.cpu().long() if jump else 0, gc.clamp(0, L * ip - 1)]
    _equal(got.cpu(), torch.where(ok[:, None], want, 0))
    if ip > 1:
        part = [t if i % 2 == 0 else None for i, t in enumerate(shards)]
        out = torch.full((B, W), 7, dtype=torch.int32, device=dev)
        before = K.launches["sharded_fetch"]
        assert sharded_fetch(part, g, s, L, stride, out=out) is out
        assert K.launches["sharded_fetch"] == before + (1 if B else 0)
        _equal(out, sharded_fetch_ref(part, g, s, L, stride))
        mine = ok & ((gc // L) % 2 == 0)
        _equal(out.cpu(), torch.where(mine[:, None], want, 0))


@pytest.mark.parametrize("A", [4, 6])
@pytest.mark.parametrize("ip", [1, 2, 4])
@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_compose_sharded_tk(dev, case, ip, k, A):
    """K13d for every shard of T_k, over the first A chars' blocks of T1
    (the case's A = sigma + 1 = 6, and 4); ip = 2 and 4 do not divide n, so
    the last shard holds padding rows (self-loops), and no n_local is a
    multiple of the kernel's tile of positions."""
    import re
    from pathlib import Path

    from colbwt_tpu_torch.parallel import query_sharded_pos as TSP

    _, index, _ = case
    n = index.n
    assert index.sigma + 1 == 6
    C = min(n, TQ._T1_CHUNK)
    t1 = TQ.build_t1(index, np.arange(6), TQ.t1_inputs(index, C, dev), C)
    t1 = t1[:A * n].contiguous()
    n_local = -(-n // ip)
    assert ip == 1 or n % ip
    src = (Path(TQ.__file__).resolve().parents[1] / "csrc"
           / "query_sharded.cu").read_text()
    tile = (int(re.search(r"kTkThreads = (\d+);", src).group(1))
            * int(re.search(r"kTkUnroll = (\d+);", src).group(1)))
    assert n_local % tile
    for i in range(ip):
        args = (t1, n, n_local, i * n_local, A, k)
        got = TSP.compose_sharded_tk(*args)
        _equal(got, TSP.compose_sharded_tk_ref(*args))
    pad = n_local * ip - n
    if pad:
        tail = got.view(A ** k, n_local, 2)[:, n_local - pad:]
        assert bool((tail[..., 0] == n - 1).all() and (tail[..., 1] == 0).all())


def _held(launch, ref, args, calls) -> None:
    """launch() the kernel on `args` and run the plain version `ref` on
    clones of them; hold every argument (the outputs written in place)
    equal afterwards."""
    def clone(a):
        if isinstance(a, torch.Tensor):
            return a.clone()
        return tuple(clone(x) for x in a) if isinstance(a, tuple) else a

    twins = [clone(a) for a in args]
    launch()
    ref(*twins)
    for a, b in zip(args, twins):
        for x, y in (zip(a, b) if isinstance(a, tuple) else [(a, b)]):
            if isinstance(x, torch.Tensor):
                _equal(x, y)
    calls.append(args[0])


def _twin_launcher(monkeypatch, module, cls, ref):
    """Run every call of a launcher class (module.cls, made once a chunk, a
    call a launch) as the kernel and, on clones of its public function's
    arguments `launcher.args(*call)`, as the plain version `ref`
    (`_held`)."""
    base = getattr(module, cls)
    calls = []

    class Twin(base):
        def __call__(self, *call):
            _held(lambda: base.__call__(self, *call), ref, self.args(*call),
                  calls)

    monkeypatch.setattr(module, cls, Twin)
    return calls


@pytest.fixture(scope="module")
def shard_case(dev, case):
    tbl, unsplit, reads = case
    sample = reads[:48] + [r for r in reads if b"N" in r][:16]
    return (tbl, unsplit, {ff: ColPmlIndex.build(tbl, ff_bound=ff)
                           for ff in (2, 3)},
            ColPmlIndex.build(scale_table(tbl, 1 << 20), ff_bound=2), sample)


@pytest.mark.parametrize("ip", [1, 2, 4])
@pytest.mark.parametrize("ff", [2, 3])
def test_sharded_compact_rounds(dev, shard_case, monkeypatch, ip, ff):
    """K13a through the per-round route `round_row` (as shards on other
    cards take it): every gather round (1-4, and 5 at ff_bound 3) equal to
    its plain version on the card; the outputs equal the single-card
    compact engine's."""
    from colbwt_tpu_torch.parallel import query_sharded as TS

    _, _, split, _, reads = shard_case
    index = split[ff]
    monkeypatch.setattr(TS, "scan_row", TS.round_row)
    calls = _twin_launcher(monkeypatch, TS, "RoundCompact",
                           TS.sharded_step_compact_ref)
    before = K.launches["sharded_scan_compact"]
    got = TS.query_batch_sharded(index, reads, mesh=_mesh(ip))
    assert K.launches["sharded_scan_compact"] == before
    assert set(calls) == set(TS.rounds(index.ff_bound))
    ref = TX.query_batch(index, reads, device=dev)
    for j in range(len(reads)):
        np.testing.assert_array_equal(got[0][j], ref[0][j])
        np.testing.assert_array_equal(got[1][j], ref[1][j])


@pytest.mark.parametrize("ip", [1, 2, 4])
@pytest.mark.parametrize("engine", ["mega", "wide", "wide-long",
                                    "wide-long-16", "pos"])
def test_sharded_steps(dev, shard_case, monkeypatch, ip, engine):
    """K13b/K13c per step through the per-step route `step_chunk` (narrow
    and wide steps, the wide one also over 64-column chunks with carried
    state, and at the long reads' shape: 16 lanes, chunks of 128 from
    the right, step_offset > 0 past the first) and K13e (k = 3) through
    the per-step route `step_row`, each equal to its plain version step by
    step; the outputs equal the single-card engines."""
    from colbwt_tpu_torch.parallel import query_sharded_mega as TSM
    from colbwt_tpu_torch.parallel import query_sharded_mega_wide as TSW
    from colbwt_tpu_torch.parallel import query_sharded_pos as TSP

    _, unsplit, split, wide, reads = shard_case
    mesh = _mesh(ip)
    if engine == "pos":
        # every row through the per-step route, as shards on other cards
        # take it
        monkeypatch.setattr(TSP, "scan_row", TSP.step_row)
        calls = _twin_launcher(monkeypatch, TSP, "StepPos",
                               TSP.sharded_step_pos_ref)
        before = K.launches["sharded_scan_pos"]
        got = TSP.query_batch_sharded_pos(unsplit, reads, mesh=mesh, k=3)
        assert K.launches["sharded_scan_pos"] == before
        ref = TQ.query_batch(unsplit, reads, k=3, device=dev)
    else:
        # every chunk through the per-step route, as shards on other cards
        # take it
        monkeypatch.setattr(TSM, "scan_chunk", TSM.step_chunk)
        calls = _twin_launcher(monkeypatch, TSM, "StepMega",
                               TSM.sharded_step_mega_ref)
        before = K.launches["sharded_scan_mega"]
        if engine == "mega":
            got = TSM.query_batch_sharded_mega(split[2], reads, mesh=mesh)
            ref = TM.query_batch(split[2], reads, device=dev)
        elif engine == "wide":
            got = TSW.query_batch_sharded_mega_wide(wide, reads, mesh=mesh)
            ref = TW.query_batch(wide, reads, device=dev)
        elif engine == "wide-long":
            long = [r * 3 for r in reads[:8]]
            got = TSW.query_long_reads_sharded_mega_wide(wide, long,
                                                         mesh=mesh, chunk=64)
            ref = TW.query_long_reads(wide, long, chunk=64, device=dev)
        else:
            long = [r * 4 for r in reads[:16]]
            assert len(long) == 16 and max(map(len, long)) > 2 * 128
            got = TSW.query_long_reads_sharded_mega_wide(wide, long,
                                                         mesh=mesh,
                                                         chunk=128)
            ref = TW.query_long_reads(wide, long, chunk=128, device=dev)
        assert K.launches["sharded_scan_mega"] == before
    assert calls
    for j in range(len(ref[0])):
        np.testing.assert_array_equal(got[0][j], ref[0][j])
        np.testing.assert_array_equal(got[1][j], ref[1][j])


def _scan_inputs(dev, index, reads, B: int, M: int, rng):
    """(B, M) uint8 right-aligned dense ids of reads drawn from `reads`
    (each repeated to at least M characters, then cut to a random length
    up to M) and their int32 lengths, on the card."""
    pick = rng.integers(0, len(reads), B)
    lens = rng.integers(0, M + 1, B)
    pats = [(reads[int(i)] * (M // len(reads[int(i)]) + 1))[:int(n)]
            for i, n in zip(pick, lens)]
    enc, ln = index.encode_patterns(pats, M)
    return (torch.from_numpy(enc.astype(np.uint8)).to(dev),
            torch.from_numpy(ln).to(dev))


@pytest.mark.parametrize("ip", [1, 2, 4])
@pytest.mark.parametrize("wide_engine", [False, True])
def test_sharded_scan_mega(dev, shard_case, ip, wide_engine):
    """The K13b/K13c chunk scan, one launch a chunk, against its plain
    version (the step loop of the plain fetch and step): a 263,168-lane
    batch of 152 columns, then 16 lanes over two 2,048-column chunks of
    long reads with the state carried from the first (step_offset 2,048):
    pml, cid and the carried state equal, wide positions through their
    int64 join included."""
    from colbwt_tpu_torch.parallel import query_sharded_mega as TSM
    from colbwt_tpu_torch.parallel import query_sharded_mega_wide as TSW

    _, _, split, wide, reads = shard_case
    index = wide if wide_engine else split[2]
    mesh = _mesh(ip)
    st = (TSW.shard_mega_wide(index, mesh) if wide_engine
          else TSM.shard_mega(index, mesh))
    shards = [st["mega"][("cuda:0", i)] for i in range(ip)]
    L = st["rows_padded"] // ip
    r, n_lo, n_hi = TSM._row_args(st, wide_engine)
    length = st["length"]["cuda:0"]
    rng = np.random.default_rng(ip * 2 + wide_engine)

    def fresh(B):
        if wide_engine:
            return TSW.initial_state_sharded(st, B, mesh)[0]
        return tuple(torch.full((B,), v, dtype=torch.int32, device=dev)
                     for v in (r - 1, st["last_len"] - 1, st["n"] - 1, 0))

    def both(p, ln, s_k, s_r, step_offset):
        before = K.launches["sharded_scan_mega"]
        got = TSM.sharded_scan_mega(shards, L, length, r, n_lo, n_hi, s_k, p,
                                    ln, step_offset, index.ff_bound,
                                    wide_engine)
        assert K.launches["sharded_scan_mega"] == before + 1
        want = TSM.sharded_scan_mega_ref(shards, L, length, r, n_lo, n_hi,
                                         s_r, p, ln, step_offset,
                                         index.ff_bound, wide_engine)
        for a, b in zip(got + tuple(s_k), want + tuple(s_r)):
            _equal(a, b)
        assert bool(got[0].any())

    p, ln = _scan_inputs(dev, index, reads, 263_168, 152, rng)
    s_k = fresh(p.shape[0])
    both(p, ln, s_k, tuple(t.clone() for t in s_k), 0)
    p, ln = _scan_inputs(dev, index, reads, 16, 4096, rng)
    s_k = fresh(16)
    s_r = tuple(t.clone() for t in s_k)
    for j, lo in enumerate((2048, 0)):
        both(p[:, lo:lo + 2048].contiguous(), ln, s_k, s_r, j * 2048)


@pytest.mark.parametrize("ip", [1, 2, 3])
@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_sharded_scan_pos(dev, shard_case, monkeypatch, ip, k):
    """The K13e chunk scan, one launch a batch, against its plain version
    (the step loop of the plain fetch and step): a 263,168-lane batch of
    about 152 columns (M a multiple of k) on the case's T_k shards (ip = 3
    does not divide n), then 4,096 lanes on a random table whose rows send
    a third of the lanes past every shard (those rows read as zeros) and
    keys past A**k - 1 (clipped to the shard); and the per-step route
    `step_row`, its StepPos launches held to the plain step, equal to the
    chunk scan on the random table."""
    from colbwt_tpu_torch.parallel import query_sharded_pos as TSP

    _, unsplit, _, _, reads = shard_case
    mesh = _mesh(ip)
    st = TSP.shard_pos_tables(unsplit, mesh, k=k)
    A, L, n = st["A"], st["n_local"], st["n"]
    shards = [st["table"][("cuda:0", i)] for i in range(ip)]
    rng = np.random.default_rng(ip * 8 + k)

    def both(p, tables):
        before = K.launches["sharded_scan_pos"]
        got = TSP.sharded_scan_pos(tables, L, p, k, A, n)
        assert K.launches["sharded_scan_pos"] == before + 1
        _equal(got, TSP.sharded_scan_pos_ref(tables, L, p, k, A, n))
        assert bool((got >> 8).any())
        return got

    p, _ = _scan_inputs(dev, unsplit, reads, 263_168, k * (152 // k), rng)
    both(p, shards)
    rows = A ** k * L
    pos = rng.integers(0, ip * L, ip * rows)
    far = rng.random(ip * rows) < 0.35
    pos[far] = rng.integers(ip * L, ip * L + 1000, int(far.sum()))
    w0 = pos | (rng.integers(0, 1 << k, ip * rows) << (32 - k))
    w1 = rng.integers(0, 1 << 32, ip * rows, dtype=np.uint64)
    table = np.stack([w0, w1], 1).astype(np.uint32).view(np.int32)
    rand = [torch.from_numpy(table[i * rows:(i + 1) * rows].copy()).to(dev)
            for i in range(ip)]
    p = torch.from_numpy(rng.integers(0, A + 1, (4096, 12 * k)).astype(
        np.uint8)).to(dev)
    got = both(p, rand)
    assert bool((got == 0).any())
    st_rand = dict(st, table={("cuda:0", i): t for i, t in enumerate(rand)})
    steps = _twin_launcher(monkeypatch, TSP, "StepPos",
                           TSP.sharded_step_pos_ref)
    before = K.launches["sharded_step_pos"]
    _equal(TSP.step_row(mesh, st_rand, 0, p), got)
    assert K.launches["sharded_step_pos"] == before + 12
    assert len(steps) == 12


@pytest.mark.parametrize("dp,ip", [(1, 2), (2, 2), (1, 4)])
def test_sharded_pos_chunk_route_on_card(dev, shard_case, dp, ip):
    """Shards on one card: the sharded positional engine is one chunk-scan
    launch a dp row, with no fetch and no per-step launch, and its outputs
    equal the single-card pos engine's."""
    from colbwt_tpu_torch.parallel import query_sharded_pos as TSP

    _, unsplit, _, _, reads = shard_case
    st = TSP.shard_pos_tables(unsplit, _mesh(ip, dp), k=3)
    K.reset_launches()
    got = TSP.query_batch_sharded_pos(unsplit, reads, mesh=_mesh(ip, dp),
                                      st=st)
    assert K.launches["sharded_scan_pos"] == dp
    assert K.launches["sharded_fetch"] == 0
    assert K.launches["sharded_step_pos"] == 0
    ref = TQ.query_batch(unsplit, reads, k=3, device=dev)
    for j in range(len(reads)):
        np.testing.assert_array_equal(got[0][j], ref[0][j])
        np.testing.assert_array_equal(got[1][j], ref[1][j])


@pytest.mark.parametrize("ip", [1, 2, 4])
@pytest.mark.parametrize("ff", [1, 2, 3])
def test_sharded_scan_compact(dev, shard_case, ip, ff):
    """The K13a chunk scan, one launch a batch, against its plain version
    (the rounds of every step through the plain fetch and round): a
    263,168-lane batch of 152 columns from the compact engine's start
    state, then 4,096 lanes from a carried state whose intervals lie below
    0 or past every shard for a third of the lanes each (those rows read
    as zeros); pml, cid and the final state equal."""
    from colbwt_tpu_torch.parallel import mesh as PM
    from colbwt_tpu_torch.parallel import query_sharded as TS

    tbl, _, split, _, reads = shard_case
    index = split.get(ff) or ColPmlIndex.build(tbl, ff_bound=ff)
    assert index.ff_bound == ff
    mesh = _mesh(ip)
    tb = PM.shard_index(index, mesh)
    soa = [tb["soa"][("cuda:0", i)] for i in range(ip)]
    jump = [tb["jump"][("cuda:0", i)] for i in range(ip)]
    L = tb["r_padded"] // ip
    rng = np.random.default_rng(ip * 4 + ff)

    def both(p, ln, state):
        s_r = tuple(t.clone() for t in state)
        before = K.launches["sharded_scan_compact"]
        got = TS.sharded_scan_compact(soa, jump, L, p, ln, state, index.r,
                                      index.n, ff)
        assert K.launches["sharded_scan_compact"] == before + 1
        want = TS.sharded_scan_compact_ref(soa, jump, L, p, ln, s_r,
                                           index.r, index.n, ff)
        for a, b in zip(got + tuple(state), want + s_r):
            _equal(a, b)
        assert bool(got[0].any())

    p, ln = _scan_inputs(dev, index, reads, 263_168, 152, rng)
    B = p.shape[0]
    last = int(index.length[index.r - 1])
    both(p, ln, tuple(torch.full((B,), v, dtype=torch.int32, device=dev)
                      for v in (index.r - 1, last - 1, index.n - 1, 0)))
    p, ln = _scan_inputs(dev, index, reads, 4096, 96, rng)
    interval = rng.integers(0, index.r, 4096)
    interval[0::3] = tb["r_padded"] + rng.integers(0, 1000, 1366)
    interval[1::3] = -rng.integers(1, 1000, 1365)
    state = (interval, rng.integers(0, 3, 4096),
             rng.integers(0, index.n, 4096), rng.integers(0, 9, 4096))
    both(p, ln, tuple(torch.from_numpy(a.astype(np.int32)).to(dev)
                      for a in state))


@pytest.mark.parametrize("dp,ip", [(1, 2), (2, 2), (1, 4)])
def test_sharded_compact_chunk_route_on_card(dev, shard_case, dp, ip):
    """Shards on one card: the sharded compact engine is one chunk-scan
    launch and one fetch (the start offset) a dp row, with no round
    launch, and its outputs equal the single-card compact engine's."""
    from colbwt_tpu_torch.parallel import query_sharded as TS

    _, _, split, _, reads = shard_case
    K.reset_launches()
    got = TS.query_batch_sharded(split[2], reads, mesh=_mesh(ip, dp))
    assert K.launches["sharded_scan_compact"] == dp
    assert K.launches["sharded_fetch"] == dp
    assert K.launches["sharded_step_compact"] == 0
    ref = TX.query_batch(split[2], reads, device=dev)
    for j in range(len(reads)):
        np.testing.assert_array_equal(got[0][j], ref[0][j])
        np.testing.assert_array_equal(got[1][j], ref[1][j])


@pytest.mark.parametrize("dp,ip", [(1, 2), (2, 2), (1, 4)])
def test_sharded_mega_chunk_route_on_card(dev, shard_case, dp, ip):
    """Shards on one card: every chunk of the sharded mega engines is one
    chunk-scan launch (dp rows x chunks), with no fetch and no per-step
    launch, and the outputs equal the single-card engines."""
    from colbwt_tpu_torch.parallel import query_sharded_mega as TSM
    from colbwt_tpu_torch.parallel import query_sharded_mega_wide as TSW

    _, _, split, wide, reads = shard_case
    mesh = _mesh(ip, dp)
    long = [r * 3 for r in reads[:8]]
    n_chunks = -(-max(len(x) for x in long) // 64)
    K.reset_launches()
    got = (TSM.query_batch_sharded_mega(split[2], reads, mesh=mesh),
           TSW.query_batch_sharded_mega_wide(wide, reads, mesh=mesh),
           TSW.query_long_reads_sharded_mega_wide(wide, long, mesh=mesh,
                                                  chunk=64))
    assert K.launches["sharded_scan_mega"] == dp * (2 + n_chunks)
    assert K.launches["sharded_fetch"] == K.launches["sharded_step_mega"] == 0
    ref = (TM.query_batch(split[2], reads, device=dev),
           TW.query_batch(wide, reads, device=dev),
           TW.query_long_reads(wide, long, chunk=64, device=dev))
    for (gp, gc), (wp, wc) in zip(got, ref):
        for j in range(len(wp)):
            np.testing.assert_array_equal(gp[j], wp[j])
            np.testing.assert_array_equal(gc[j], wc[j])


@pytest.mark.parametrize("dp,ip", [(1, 2), (2, 2), (1, 4)])
def test_sharded_wide_slices_on_card(dev, shard_case, dp, ip):
    """Each shard's slice, filled on the card from K6b blocks (the blocks
    that straddle a slice's edge through an r-row temporary), equals the
    full table's rows."""
    from colbwt_tpu_torch.parallel import query_sharded_mega_wide as TSW

    *_, wide, _ = shard_case
    full = TW.build_mega_table_wide(wide, compact=False, device=dev)["mega"]
    st = TSW.shard_mega_wide(wide, _mesh(ip, dp))
    got = torch.cat([st["mega"][("cuda:0", i)] for i in range(ip)])
    _equal(got[:full.shape[0]], full)
    assert not bool(got[full.shape[0]:].any())


# ---------------------------------------------------------------------------
# The sharded engines over distinct cards: one process driving a mesh over
# the default devices cuda:0.., and one process a rank over NCCL.  Each case
# needs a card for every cell of its mesh and skips with fewer.
# ---------------------------------------------------------------------------

def _cards(n):
    if torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} CUDA devices, have "
                    f"{torch.cuda.device_count()}")


def _engines(unsplit, split, wide, reads, mesh) -> dict:
    """Every sharded engine's (pmls, cids) on `mesh`, by name."""
    from colbwt_tpu_torch.parallel import query_batch_sharded_auto
    from colbwt_tpu_torch.parallel import query_sharded as TS
    from colbwt_tpu_torch.parallel import query_sharded_mega as TSM
    from colbwt_tpu_torch.parallel import query_sharded_mega_wide as TSW
    from colbwt_tpu_torch.parallel import query_sharded_pos as TSP

    long = [r * 3 for r in reads[:8]]
    return {
        "compact": TS.query_batch_sharded(split, reads, mesh=mesh),
        "mega": TSM.query_batch_sharded_mega(split, reads, mesh=mesh),
        "pos": TSP.query_batch_sharded_pos(unsplit, reads, mesh=mesh, k=3),
        "wide": TSW.query_batch_sharded_mega_wide(wide, reads, mesh=mesh),
        "wide-long": TSW.query_long_reads_sharded_mega_wide(
            wide, long, mesh=mesh, chunk=64),
        "auto": query_batch_sharded_auto(unsplit, reads, mesh=mesh)[:2],
    }


def _same_engines(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for name, (wp, wc) in want.items():
        gp, gc = got[name]
        assert len(gp) == len(wp), name
        for j in range(len(wp)):
            np.testing.assert_array_equal(gp[j], wp[j], err_msg=name)
            np.testing.assert_array_equal(gc[j], wc[j], err_msg=name)


@pytest.mark.parametrize("dp,ip", [(1, 2), (2, 1), (2, 2), (1, 4)])
def test_sharded_engines_on_distinct_cards(dev, shard_case, dp, ip):
    """A one-process mesh over make_mesh's default devices, a card a cell:
    every launch lands on its tensors' card, and every engine equals the
    same mesh held on cuda:0 alone."""
    from colbwt_tpu_torch.parallel import make_mesh

    _cards(dp * ip)
    _, unsplit, split, wide, reads = shard_case
    mesh = make_mesh(dp, ip)
    assert len(mesh.devices()) == dp * ip and mesh.shards_per_device() == 1
    _same_engines(_engines(unsplit, split[2], wide, reads, mesh),
                  _engines(unsplit, split[2], wide, reads, _mesh(ip, dp)))


NCCL_WORKER = """
import sys

import numpy as np
import torch.distributed as dist

from colbwt_tpu_torch.models.index import ColPmlIndex
from colbwt_tpu_torch.parallel import make_mesh
from colbwt_tpu_torch.parallel.distributed import (init_distributed,
                                                   shutdown_distributed)
from test_torch_kernels import _engines

dp, ip, work = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
rank, world = init_distributed(device="cuda")
assert world == dp * ip and dist.get_backend() == "nccl"
mesh = make_mesh(dp, ip)
assert mesh.distributed
idx = [ColPmlIndex.load(f"{work}/{f}.colpml.npz")
       for f in ("unsplit", "split", "wide")]
with open(f"{work}/reads.txt", "rb") as fh:
    reads = fh.read().split(b"\\n")
out = {}
for name, (p, c) in _engines(*idx, reads, mesh).items():
    out[name + "_len"] = np.array([len(x) for x in p])
    out[name + "_pml"] = np.concatenate(p)
    out[name + "_cid"] = np.concatenate(c)
np.savez(f"{work}/rank{rank}.npz", **out)
shutdown_distributed(mesh)
"""


@pytest.mark.parametrize("dp,ip", [(2, 1), (1, 2), (2, 2)])
def test_sharded_engines_nccl_ranks(dev, shard_case, tmp_path, dp, ip):
    """One process a rank over NCCL (torchrun's environment, a card a
    rank): every rank's outputs of every engine equal the one-process mesh
    on cuda:0.  Each process is killed when it runs over its timeout."""
    import os
    import socket
    import subprocess
    import sys
    from pathlib import Path

    _cards(dp * ip)
    _, unsplit, split, wide, reads = shard_case
    for name, index in (("unsplit", unsplit), ("split", split[2]),
                        ("wide", wide)):
        index.save(tmp_path / f"{name}.colpml")
    (tmp_path / "reads.txt").write_bytes(b"\n".join(reads))
    (tmp_path / "worker.py").write_text(NCCL_WORKER)
    K.load()  # built once, before the ranks start
    repo = Path(__file__).resolve().parents[1]
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, str(tmp_path / "worker.py"), str(dp), str(ip),
         str(tmp_path)], cwd=repo, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, RANK=str(rank), LOCAL_RANK=str(rank),
                 WORLD_SIZE=str(dp * ip), MASTER_ADDR="127.0.0.1",
                 MASTER_PORT=str(port), PYTHONPATH=os.pathsep.join(
                     [str(repo), str(repo / "tests"),
                      os.environ.get("PYTHONPATH", "")])))
        for rank in range(dp * ip)]
    errs = []
    try:
        for p in procs:
            errs.append(p.communicate(timeout=180)[1])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (p, err) in enumerate(zip(procs, errs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{err[-4000:]}"
    want = _engines(unsplit, split[2], wide, reads, _mesh(ip, dp))
    for rank in range(dp * ip):
        got = np.load(tmp_path / f"rank{rank}.npz")
        for name, (wp, wc) in want.items():
            np.testing.assert_array_equal(got[name + "_len"],
                                          [len(x) for x in wp])
            np.testing.assert_array_equal(got[name + "_pml"],
                                          np.concatenate(wp), err_msg=name)
            np.testing.assert_array_equal(got[name + "_cid"],
                                          np.concatenate(wc), err_msg=name)
