"""The port's own copy of the host layer against the JAX package's
originals, on seeded inputs: the index file both ways, the carry-across
constructors, every file writer read back by the other package, and the
oracle, run-split and sweep functions the port runs.  Exact throughout.
"""

import dataclasses

import numpy as np
import pytest

import colbwt_tpu.io.fasta as JFA
import colbwt_tpu.io.formats as JF
import colbwt_tpu.io.pml_out as JP
import colbwt_tpu.models.index as JI
import colbwt_tpu.ops.colruns_vec as JCV
import colbwt_tpu.ops.oracle as JO
import colbwt_tpu.ops.run_split as JR
import colbwt_tpu.utils.config as JC
import colbwt_tpu_torch.io.fasta as TFA
import colbwt_tpu_torch.io.formats as TF
import colbwt_tpu_torch.io.pml_out as TP
import colbwt_tpu_torch.models.index as TI
import colbwt_tpu_torch.ops.colruns_vec as TCV
import colbwt_tpu_torch.ops.oracle as TO
import colbwt_tpu_torch.ops.run_split as TR
import colbwt_tpu_torch.utils.config as TC
from tests.conftest import random_docs


def _same(a, b, where="value"):
    """Deep equality of the values the two packages return."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, where
        for f in dataclasses.fields(a):
            _same(getattr(a, f.name), getattr(b, f.name), f"{where}.{f.name}")
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _same(a[k], b[k], f"{where}[{k!r}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype, f"{where}: {a.dtype} vs {b.dtype}"
        np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        assert a == b, where


@pytest.fixture(scope="module")
def coll():
    """A collection and every stage's arrays, from the JAX package."""
    rng = np.random.default_rng(0x40C7)
    base = bytes(rng.choice(list(b"ACGT"), 300).astype("uint8"))
    docs = random_docs(rng, 3, mutate_from=base)
    text, ranks, doc_ids = JO.concat_collection(docs)
    sa = JO.suffix_array(ranks)
    lcp = JO.lcp_kasai(ranks, sa)
    heads, lens = JO.rle(JO.bwt_from_sa(text, sa))
    fl = JO.build_fl_table(heads, lens)
    ml, mp = JO.find_multi_mums(ranks, sa, lcp, doc_ids, 3, 10)
    marks = JO.col_split_oracle(fl, ml, mp, 3, 2, "tunnels")
    bits, ids = JO.find_col_runs_oracle(*marks, fl.l_heads, fl.n)
    thr = JO.compute_thresholds(heads, lens, lcp)
    tbl = JO.build_col_pml(heads, lens, bits, ids, thr)
    return dict(docs=docs, text=text, ranks=ranks, doc_ids=doc_ids, sa=sa,
                lcp=lcp, heads=heads, lens=lens, fl=fl, ml=ml, mp=mp,
                marks=marks, bits=bits, ids=ids, thr=thr, tbl=tbl,
                reads=[docs[0][40:90], docs[1][100:160] + b"N" + docs[2][:30],
                       b"ACGTACGTTT", b"A"])


def _fl(pkg, c):
    return pkg.build_fl_table(c["heads"], c["lens"])


def _tbl(pkg, c):
    return pkg.build_col_pml(c["heads"], c["lens"], c["bits"], c["ids"],
                             c["thr"])


# (name, call(oracle module, run-split module, colruns module, coll))
CALLS = {
    "concat_collection": lambda O, R, V, c: O.concat_collection(c["docs"]),
    "suffix_array": lambda O, R, V, c: O.suffix_array(c["ranks"]),
    "lcp_kasai": lambda O, R, V, c: O.lcp_kasai(c["ranks"], c["sa"]),
    "bwt_from_sa": lambda O, R, V, c: O.bwt_from_sa(c["text"], c["sa"]),
    "rle": lambda O, R, V, c: O.rle(O.bwt_from_sa(c["text"], c["sa"])),
    "normalize_heads": lambda O, R, V, c: O.normalize_heads(c["heads"]),
    "build_lf_table": lambda O, R, V, c: O.build_lf_table(c["heads"],
                                                          c["lens"]),
    "build_fl_table": lambda O, R, V, c: _fl(O, c),
    "find_multi_mums": lambda O, R, V, c: O.find_multi_mums(
        c["ranks"], c["sa"], c["lcp"], c["doc_ids"], 3, 10),
    "compute_thresholds": lambda O, R, V, c: O.compute_thresholds(
        c["heads"], c["lens"], c["lcp"]),
    "compute_thresholds_fast": lambda O, R, V, c: O.compute_thresholds_fast(
        c["heads"], c["lens"], c["lcp"]),
    "col_split_oracle-tunnels": lambda O, R, V, c: O.col_split_oracle(
        _fl(O, c), c["ml"], c["mp"], 3, 2, "tunnels"),
    "col_split_oracle-all": lambda O, R, V, c: O.col_split_oracle(
        _fl(O, c), c["ml"], c["mp"], 3, 2, "all"),
    "find_col_runs_oracle": lambda O, R, V, c: O.find_col_runs_oracle(
        *c["marks"], c["fl"].l_heads, c["fl"].n),
    "build_col_pml": lambda O, R, V, c: _tbl(O, c),
    "query_pml_oracle": lambda O, R, V, c: [
        O.query_pml_oracle(_tbl(O, c), r) for r in c["reads"]],
    "split_runs_bounded_ff": lambda O, R, V, c: R.split_runs_bounded_ff(
        _tbl(O, c), 2),
    "split_runs_max_len": lambda O, R, V, c: R.split_runs_max_len(
        _tbl(O, c), 3),
    "max_ff_span": lambda O, R, V, c: R.max_ff_span(
        R.split_runs_bounded_ff(_tbl(O, c), 2)),
    "find_col_runs_uniform": lambda O, R, V, c: V.find_col_runs_uniform(
        c["marks"][0], c["marks"][1], 3, c["fl"].l_heads, c["fl"].n),
    "find_col_runs_mixed": lambda O, R, V, c: V.find_col_runs_mixed(
        *c["marks"], c["fl"].l_heads, c["fl"].n),
}


@pytest.mark.parametrize("name", list(CALLS))
def test_host_function_matches_jax(coll, name):
    call = CALLS[name]
    _same(call(TO, TR, TCV, coll), call(JO, JR, JCV, coll), name)


@pytest.mark.parametrize("ff", [0, 1, 2, 4])
def test_index_build_matches_jax(coll, ff):
    build = (lambda I: I.ColPmlIndex.from_table(coll["tbl"])) if ff == 0 \
        else (lambda I: I.ColPmlIndex.build(coll["tbl"], ff_bound=ff))
    _same(build(TI), build(JI), f"ff_bound={ff}")


@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("direction", ["jax-to-torch", "torch-to-jax"])
def test_colpml_npz_both_ways(coll, tmp_path, direction, wide):
    """Each package's ColPmlIndex.load reads the other's save."""
    src, dst = (JI, TI) if direction == "jax-to-torch" else (TI, JI)
    index = src.ColPmlIndex.build(coll["tbl"], ff_bound=2, wide=wide or None)
    index.save(tmp_path / "idx.colpml")
    got = dst.ColPmlIndex.load(tmp_path / "idx.colpml.npz")
    assert type(got) is dst.ColPmlIndex
    _same(vars(got), vars(index))
    assert got.wide == index.wide and got.sigma == index.sigma


def test_carry_across(coll):
    """from_arrays builds the port's own types from the JAX package's
    fields: the index, the LF table and the FL table."""
    jidx = JI.ColPmlIndex.build(coll["tbl"], ff_bound=2)
    idx = TI.ColPmlIndex.from_arrays(vars(jidx))
    assert type(idx) is TI.ColPmlIndex
    _same(vars(idx), vars(jidx))
    assert idx.nbytes() == jidx.nbytes() and idx.stats() == jidx.stats()
    for cls, obj in ((TO.LFTableArrays, coll["tbl"]),
                     (TO.FLTableArrays, coll["fl"])):
        got = cls.from_arrays(vars(obj))
        assert type(got) is cls
        _same(vars(got), vars(obj))
    # the carried table builds the same index in the port as in JAX
    _same(vars(TI.ColPmlIndex.build(TO.LFTableArrays.from_arrays(
        vars(coll["tbl"])), ff_bound=2)), vars(jidx))


def _files(coll):
    heads, lens, ml, mp = coll["heads"], coll["lens"], coll["ml"], coll["mp"]
    tbl = coll["tbl"]
    bv = np.zeros(int(lens.sum()), dtype=bool)
    bv[coll["bits"]] = True
    return {
        "rlbwt": (lambda F, p: F.write_rlbwt(p, heads, lens),
                  lambda F, p: F.read_rlbwt(p)),
        "plain_bwt": (lambda F, p: F.write_plain_bwt(p, heads, lens),
                      lambda F, p: F.read_plain_bwt(p)),
        "col_mums": (lambda F, p: F.write_col_mums(p, 3, ml, mp),
                     lambda F, p: F.read_col_mums(p)),
        "thresholds": (lambda F, p: F.write_thresholds_file(p, coll["thr"]),
                       lambda F, p: F.read_thresholds_file(p)),
        "col_ids": (lambda F, p: F.write_col_ids(p, coll["ids"] * 40, 1, 8),
                    lambda F, p: F.read_col_ids(p)),
        "sdsl_bit_vector": (lambda F, p: F.write_sdsl_bit_vector(p, bv),
                            lambda F, p: F.read_sdsl_bit_vector(p)),
        "col_pml": (lambda F, p: F.write_col_pml_file(
            p, bwt_r=tbl.bwt_r, n=tbl.n, char=tbl.char, idx=tbl.idx,
            dest_interval=tbl.dest_interval, dest_offset=tbl.dest_offset,
            col_id=tbl.col_id, threshold=tbl.threshold),
            lambda F, p: F.read_col_pml_file(p)),
    }


FILES = ["rlbwt", "plain_bwt", "col_mums", "thresholds", "col_ids",
         "sdsl_bit_vector", "col_pml", "pml_cid_binary", "fasta"]


@pytest.mark.parametrize("direction", ["jax-to-torch", "torch-to-jax"])
@pytest.mark.parametrize("kind", FILES)
def test_writer_read_by_other_package(coll, tmp_path, kind, direction):
    """Each writer's file is byte-equal across the packages and reads back
    the same through the other package's reader."""
    pkgs = {"jax": (JF, JP, JFA), "torch": (TF, TP, TFA)}
    src, dst = direction.split("-to-")
    paths = {pkg: tmp_path / f"{pkg}.{kind}" for pkg in pkgs}
    names = [f"r{i}" for i in range(len(coll["reads"]))]
    arrays = [np.arange(len(r), dtype=np.int64) * 7 for r in coll["reads"]]
    for pkg, (F, P, FA) in pkgs.items():
        p = paths[pkg]
        if kind == "pml_cid_binary":
            P.write_pml_cid_binary(p, f"{p}.cid", names, arrays, arrays)
        elif kind == "fasta":
            FA.write_fasta(p, [FA.FastaRecord(n, r)
                               for n, r in zip(names, coll["docs"] +
                                               coll["reads"][:1])], width=50)
        else:
            _files(coll)[kind][0](F, p)
    written = {pkg: [(f.name[len(pkg):], f.read_bytes()) for f in
                     sorted(tmp_path.glob(f"{pkg}.{kind}*"))] for pkg in pkgs}
    assert written["jax"] == written["torch"] and written["jax"]
    F, P, FA = pkgs[dst]
    p = paths[src]
    if kind == "pml_cid_binary":
        got, want = P.read_pml_cid_binary(p), pkgs[src][1].read_pml_cid_binary(p)
    elif kind == "fasta":
        got = [(r.name, r.seq) for r in FA.read_fasta(p)]
        want = [(r.name, r.seq) for r in pkgs[src][2].read_fasta(p)]
        assert got == [(r.name, r.seq) for r in FA.stream_fasta(p)]
    else:
        got = _files(coll)[kind][1](F, p)
        want = _files(coll)[kind][1](pkgs[src][0], p)
    _same(got, want, kind)


def test_config_fields_match_jax():
    """ColBwtConfig is the same dataclass field for field, with the same
    defaults and choices, so a configuration means the same to both."""
    got = {f.name: f.default for f in dataclasses.fields(TC.ColBwtConfig)}
    want = {f.name: f.default for f in dataclasses.fields(JC.ColBwtConfig)}
    assert got == want
    assert TC.ColBwtConfig._CHOICES == JC.ColBwtConfig._CHOICES
    assert TC.TERMINATOR == JC.TERMINATOR
    assert [m.value for m in TC.SplitMode] == [m.value for m in JC.SplitMode]
