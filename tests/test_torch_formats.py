"""The port's copy of the sdsl codecs (colbwt_tpu_torch/io/formats.py),
the oracle's round trips and plain-BWT constructor
(colbwt_tpu_torch/ops/oracle.py) and the single-core C++ engine
(colbwt_tpu_torch/io/native.py query_pml_serial) against the JAX package:
each codec's bytes encoded by one package and decoded by the other, and
every value equal to JAX's on the same seeded inputs.  Exact: integers and
bytes."""

import dataclasses

import numpy as np
import pytest

import colbwt_tpu.io as JIO
import colbwt_tpu_torch.io as TIO
from colbwt_tpu.io import formats as JF
from colbwt_tpu.io import native as JN
from colbwt_tpu.ops import oracle as JO
from colbwt_tpu_torch.io import formats as TF
from colbwt_tpu_torch.io import native as TN
from colbwt_tpu_torch.ops import oracle as TO
from tests.conftest import random_docs
from tests.test_query_xla import build_index, make_reads

BOTH = [(TF, JF), (JF, TF)]
IDS = ["port-to-jax", "jax-to-port"]


def test_io_exports_match_jax():
    names = [n for n in dir(JIO) if not n.startswith("_")
             and n not in ("fasta", "formats", "native", "pml_out")]
    assert names
    for n in names:
        assert hasattr(TIO, n), n
        assert getattr(TIO, n).__module__.replace(
            "colbwt_tpu_torch", "colbwt_tpu") == getattr(JIO, n).__module__


@pytest.mark.parametrize("x", [0, 1, 2, 3, 63, 64, 65, 1 << 40])
def test_bit_helpers_equal_jax(x):
    assert TF._bits_hi(x) == JF._bits_hi(x)
    assert TF._mcl_logn(x) == JF._mcl_logn(x)


@pytest.mark.parametrize("enc,dec", BOTH, ids=IDS)
def test_sdsl_int_vector_across(rng, enc, dec):
    for width in (1, 3, 5, 8, 17, 40, 64):
        hi = (1 << width) - 1 if width < 64 else (1 << 63)
        vals = rng.integers(0, hi, 37, dtype=np.uint64) % np.uint64(max(hi, 1))
        buf = enc.encode_sdsl_int_vector(vals, width)
        assert buf == dec.encode_sdsl_int_vector(vals, width)
        got, want = dec.decode_sdsl_int_vector(buf), \
            enc.decode_sdsl_int_vector(buf)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:] == want[1:] == (width, len(buf))


@pytest.mark.parametrize("enc,dec", BOTH, ids=IDS)
def test_sdsl_bit_vector_across(rng, enc, dec, tmp_path):
    for size in (0, 1, 63, 64, 65, 1000):
        bits = rng.random(size) < 0.3
        buf = enc.encode_sdsl_bit_vector(bits)
        assert buf == dec.encode_sdsl_bit_vector(bits)
        got, off = dec.decode_sdsl_bit_vector(buf)
        np.testing.assert_array_equal(got, bits)
        assert off == len(buf)
        enc.write_sdsl_bit_vector(tmp_path / "b", bits)
        np.testing.assert_array_equal(dec.read_sdsl_bit_vector(tmp_path / "b"),
                                      bits)


@pytest.mark.parametrize("enc,dec", BOTH, ids=IDS)
def test_sd_vector_across(rng, enc, dec, tmp_path):
    for size, m in ((1, 0), (10, 1), (64, 64), (1000, 37), (1 << 20, 4096)):
        positions = np.sort(rng.choice(size, m, replace=False)).astype(
            np.uint64)
        for with_select in (False, True):
            buf = enc.encode_sd_vector(positions, size,
                                       with_select=with_select)
            assert buf == dec.encode_sd_vector(positions, size,
                                               with_select=with_select)
            pos, sz, off = dec.decode_sd_vector(buf)
            np.testing.assert_array_equal(pos, positions.astype(np.int64))
            assert sz == size
            if with_select:
                off = dec.skip_select_support_mcl(buf, off)
                off = dec.skip_select_support_mcl(buf, off)
            assert off == len(buf)
        enc.write_sdsl_sd_vector(tmp_path / "x.sv", positions, size)
        pos, sz = dec.read_sdsl_sd_vector(tmp_path / "x.sv")
        assert sz == size
        np.testing.assert_array_equal(pos, positions.astype(np.int64))


@pytest.mark.parametrize("enc,dec", BOTH, ids=IDS)
@pytest.mark.parametrize("size,density", [(1, 0.5), (100, 0.5), (9000, 0.5),
                                          (1 << 21, 0.0024), (12288, 0.34)])
def test_select_support_mcl_across(rng, enc, dec, size, density):
    """Mini and long blocks, both patterns: the same frame bytes, decoded
    alike, every sampled select query answered alike and truly."""
    bits = rng.random(size) < density
    for pattern in (1, 0):
        buf = enc.encode_select_support_mcl(bits, pattern)
        assert buf == dec.encode_select_support_mcl(bits, pattern)
        got, off = dec.decode_select_support_mcl(buf)
        want, woff = enc.decode_select_support_mcl(buf)
        assert off == woff == len(buf)
        assert got.keys() == want.keys()
        truth = np.flatnonzero(bits if pattern else ~bits)
        assert got["arg_cnt"] == want["arg_cnt"] == truth.size
        if not truth.size:
            continue
        for i in np.unique(np.r_[1, truth.size,
                                 rng.integers(1, truth.size + 1, 64)]):
            assert dec.select_support_mcl_query(got, bits, int(i), pattern) \
                == enc.select_support_mcl_query(want, bits, int(i), pattern) \
                == truth[i - 1]


def _fl(rng):
    docs = random_docs(rng, 3, lo=60, hi=140)
    text, ranks, _ = TO.concat_collection(docs)
    sa = TO.suffix_array(ranks)
    heads, lens = TO.rle(TO.bwt_from_sa(text, sa))
    return docs, heads, lens


@pytest.mark.parametrize("enc,dec", BOTH, ids=IDS)
def test_fl_table_file_across(rng, enc, dec, tmp_path):
    _, heads, lens = _fl(rng)
    fl = TO.build_fl_table(heads, lens)
    fields = dict(n=fl.n, char=fl.char, idx=fl.idx,
                  dest_interval=fl.dest_interval, dest_offset=fl.dest_offset,
                  l_heads=fl.l_heads)
    enc.write_fl_table_file(tmp_path / "a.FL_table", **fields)
    dec.write_fl_table_file(tmp_path / "b.FL_table", **fields)
    assert (tmp_path / "a.FL_table").read_bytes() == \
        (tmp_path / "b.FL_table").read_bytes()
    got = dec.read_fl_table_file(tmp_path / "a.FL_table")
    want = enc.read_fl_table_file(tmp_path / "a.FL_table")
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])
    assert got["n"] == fl.n and got["r"] == fl.r


@pytest.mark.parametrize("seed", [1, 2, 3, 4])
def test_invert_and_decompress_equal_jax(seed):
    rng = np.random.default_rng(seed)
    docs, heads, lens = _fl(rng)
    lf, jlf = TO.build_lf_table(heads, lens), JO.build_lf_table(heads, lens)
    assert TO.invert(lf) == JO.invert(jlf) == JO.invert(lf)
    fl, jfl = TO.build_fl_table(heads, lens), JO.build_fl_table(heads, lens)
    assert TO.decompress(fl) == JO.decompress(jfl) == JO.decompress(fl)
    single = TO.rle(TO.bwt_from_sa(*_text_sa(docs[0])))
    assert TO.invert(TO.build_lf_table(*single)) == docs[0][::-1]
    assert TO.decompress(TO.build_fl_table(*single)) == docs[0]


def _text_sa(doc):
    text, ranks, _ = TO.concat_collection([doc])
    return text, TO.suffix_array(ranks)


@pytest.mark.parametrize("seed", [5, 6, 7])
def test_plain_bwt_constructor_equals_jax(seed):
    """build_col_pml_from_plain_bwt equals JAX's and the RLBWT path on the
    same BWT, col marks and thresholds."""
    rng = np.random.default_rng(seed)
    docs = random_docs(rng, 3, lo=80, hi=160)
    text, ranks, doc_ids = TO.concat_collection(docs)
    sa = TO.suffix_array(ranks)
    lcp = TO.lcp_kasai(ranks, sa)
    bwt = TO.bwt_from_sa(text, sa)
    heads, lens = TO.rle(bwt)
    fl = TO.build_fl_table(heads, lens)
    ml, mp = TO.find_multi_mums(ranks, sa, lcp, doc_ids, len(docs), 8)
    mpos, mids, mhts = TO.col_split_oracle(fl, ml, mp, len(docs), 2,
                                           "tunnels")
    bits, ids = TO.find_col_runs_oracle(mpos, mids, mhts, fl.l_heads, fl.n)
    thr = TO.compute_thresholds(heads, lens, lcp)
    for raw in (bwt.tobytes(), bwt):
        got = TO.build_col_pml_from_plain_bwt(raw, bits, ids, thr)
        want = JO.build_col_pml_from_plain_bwt(raw, bits, ids, thr)
        ref = TO.build_col_pml(heads, lens, bits, ids, thr)
        for f in dataclasses.fields(got):
            for other in (want, ref):
                np.testing.assert_array_equal(getattr(got, f.name),
                                              getattr(other, f.name),
                                              err_msg=f.name)


def test_query_pml_serial_equals_jax(rng):
    """The C++ engine through the port's binding equals it through JAX's
    and the oracle (the library is the repository's, shared)."""
    if not (TN.available() and JN.available()):
        pytest.skip("native/libcolbwt_native.so does not load")
    base = bytes(rng.choice(list(b"ACGT"), 200).astype("uint8"))
    docs = random_docs(rng, 3, mutate_from=base)
    tbl, _ = build_index(docs)
    reads = make_reads(rng, docs, 16) + [b"", b"A", b"NNACGT"]
    got, want = TN.query_pml_serial(tbl, reads), JN.query_pml_serial(tbl,
                                                                     reads)
    for read, gp, gc, wp, wc in zip(reads, *got, *want):
        np.testing.assert_array_equal(gp, wp)
        np.testing.assert_array_equal(gc, wc)
        ep, ec = TO.query_pml_oracle(tbl, read)
        np.testing.assert_array_equal(gp, ep)
        np.testing.assert_array_equal(gc, ec)
