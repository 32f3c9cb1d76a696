"""The port's r-index (colbwt_tpu_torch/ops/rindex.py): the cases of
tests/test_rindex.py on the port (brute force, the move tables, backward
search, round trip, save and load), then rank, select, LF, FL, count and
invert equal to the JAX package's RIndex on the same collections.  Every
value is an integer or a byte: exact."""

import numpy as np
import pytest

from colbwt_tpu.ops import oracle as JO
from colbwt_tpu.ops.rindex import RIndex as JaxRIndex
from colbwt_tpu_torch.ops import oracle as O
from colbwt_tpu_torch.ops.rindex import RankSelectRLBWT, RIndex
from tests.conftest import random_docs


def _built(rng, alphabet=b"ACGT"):
    docs = random_docs(rng, 3, lo=50, hi=150, alphabet=alphabet)
    text, ranks, _ = O.concat_collection(docs)
    sa = O.suffix_array(ranks)
    bwt = O.bwt_from_sa(text, sa)
    bwt_norm = bwt.copy()
    bwt_norm[bwt_norm <= 1] = 1
    heads, lens = O.rle(bwt)
    return docs, text, bwt_norm, heads, lens


@pytest.fixture
def built(rng):
    return _built(rng)


def test_rank_select_brute_force(built):
    _, _, bwt, heads, lens = built
    rs = RankSelectRLBWT.from_rlbwt(heads, lens)
    for c in np.unique(bwt):
        c = int(c)
        occ = np.flatnonzero(bwt == c)
        idxs = np.arange(rs.n + 1)
        expect = np.r_[0, np.cumsum(bwt == c)]
        np.testing.assert_array_equal(rs.rank(idxs, c), expect)
        np.testing.assert_array_equal(rs.select(np.arange(occ.size), c), occ)
    np.testing.assert_array_equal(rs.char_at(np.arange(rs.n)), bwt)


def test_lf_fl_match_move_tables(built):
    _, _, _, heads, lens = built
    ri = RIndex.from_rlbwt(heads, lens)
    lf_tbl = O.build_lf_table(heads, lens)
    fl_tbl = O.build_fl_table(heads, lens)
    n = ri.n
    pos = np.arange(n)
    expect_lf = np.empty(n, dtype=np.int64)
    for run in range(lf_tbl.r):
        s = int(lf_tbl.idx[run])
        ln = int(lf_tbl.length[run])
        di, doff = int(lf_tbl.dest_interval[run]), int(lf_tbl.dest_offset[run])
        expect_lf[s:s + ln] = int(lf_tbl.idx[di]) + doff + np.arange(ln)
    np.testing.assert_array_equal(ri.LF(pos), expect_lf)
    np.testing.assert_array_equal(ri.FL(expect_lf), pos)
    got = ri.FL(pos[:64])
    for i in range(64):
        interval = int(np.searchsorted(fl_tbl.idx, i, side="right") - 1)
        off = i - int(fl_tbl.idx[interval])
        di, doff = O.fl_step(fl_tbl, interval, off)
        assert int(got[i]) == int(fl_tbl.idx[di]) + doff


def test_count_backward_search(built, rng):
    docs, _, _, heads, lens = built
    ri = RIndex.from_rlbwt(heads, lens)
    for _ in range(20):
        d = docs[int(rng.integers(0, len(docs)))]
        m = int(rng.integers(3, 12))
        s = int(rng.integers(0, max(1, len(d) - m)))
        pat = d[s:s + m]
        expect = 0
        for dd in docs:  # occurrences within documents (no separator spans)
            start = 0
            while True:
                j = dd.find(pat, start)
                if j < 0:
                    break
                expect += 1
                start = j + 1
        assert ri.count(pat) == expect, pat
    assert ri.count(b"ACGT" * 40) == 0
    assert ri.count(b"\x02\x03") == 0  # absent chars


def test_invert_roundtrip(built):
    _, _, _, heads, lens = built
    ri = RIndex.from_rlbwt(heads, lens)
    assert ri.invert() == O.invert(O.build_lf_table(heads, lens))


def test_save_load(built, tmp_path):
    _, _, _, heads, lens = built
    ri = RIndex.from_rlbwt(heads, lens)
    ri.save(tmp_path / "ri.npz")
    ri2 = RIndex.load(tmp_path / "ri.npz")
    assert ri2.count(b"ACG") == ri.count(b"ACG")
    np.testing.assert_array_equal(ri2.F, ri.F)


@pytest.mark.parametrize("seed,alphabet", [(1, b"ACGT"), (2, b"AC"),
                                           (3, b"ACGTN"), (4, b"ACGT")])
def test_equals_jax(seed, alphabet, tmp_path):
    """rank, select, LF (by BWT char and by a given char), FL, f_at,
    LF_range, count, invert and the saved file equal JAX's RIndex."""
    rng = np.random.default_rng(seed)
    docs, _, bwt, heads, lens = _built(rng, alphabet)
    got, want = RIndex.from_rlbwt(heads, lens), JaxRIndex.from_rlbwt(heads,
                                                                      lens)
    np.testing.assert_array_equal(got.F, want.F)
    assert got.terminator_position == want.terminator_position
    n = got.n
    pos = np.arange(n)
    for c in map(int, np.unique(bwt)):
        np.testing.assert_array_equal(got.bwt.rank(np.arange(n + 1), c),
                                      want.bwt.rank(np.arange(n + 1), c))
        k = np.arange(int((bwt == c).sum()))
        np.testing.assert_array_equal(got.bwt.select(k, c),
                                      want.bwt.select(k, c))
        np.testing.assert_array_equal(got.LF(pos, c), want.LF(pos, c))
        assert got.LF_range(0, n - 1, c) == want.LF_range(0, n - 1, c)
    np.testing.assert_array_equal(got.LF(pos), want.LF(pos))
    np.testing.assert_array_equal(got.FL(pos), want.FL(pos))
    assert [got.f_at(i) for i in range(n)] == [want.f_at(i)
                                               for i in range(n)]
    for d in docs:
        for m in (1, 3, 8, 20):
            pat = d[len(d) // 3:len(d) // 3 + m]
            assert got.count(pat) == want.count(pat)
    assert got.invert() == want.invert() == JO.invert(
        JO.build_lf_table(heads, lens))
    got.save(tmp_path / "t.npz")
    want.save(tmp_path / "j.npz")
    a, b = np.load(tmp_path / "t.npz"), np.load(tmp_path / "j.npz")
    assert sorted(a.files) == sorted(b.files)
    for f in a.files:
        np.testing.assert_array_equal(a[f], b[f])
