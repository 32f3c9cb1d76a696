"""The PyTorch port's slice as a whole against the JAX package: the build's
artifacts (the host lane, the device lane with the cut-off lowered, the
chunked SA lane), the query pipeline's output files (binary and text,
against the committed goldens too) and the CLI.

The port runs its plain PyTorch path on the CPU (device="cpu").  Every
compared value is an integer or a byte, so every comparison is exact.
"""

import shutil
from pathlib import Path

import numpy as np
import pytest

from colbwt_tpu.io import formats as F
from colbwt_tpu.io.fasta import FastaRecord, read_fasta, write_fasta
from colbwt_tpu.models.index import ColPmlIndex
import colbwt_tpu.pipeline.build as JB
import colbwt_tpu_torch.pipeline.build as TB
from colbwt_tpu_torch.ops import oracle as TO
from colbwt_tpu.ops import oracle as O
from colbwt_tpu.pipeline import build_pipeline as jax_build
from colbwt_tpu.pipeline import query_pipeline as jax_query
from colbwt_tpu.utils.config import ColBwtConfig, SplitMode
from colbwt_tpu_torch.cli import main as torch_cli
from colbwt_tpu_torch.pipeline import build_pipeline, query_pipeline
from colbwt_tpu_torch.pipeline.engines import QueryEngines
from tests.conftest import random_docs
from tests.test_query_xla import build_index, make_reads

GOLD = Path(__file__).parent / "goldens"
CFG = dict(min_mum=20, split_rate=10, rev_comp=True, keep_temp=True)
ARTIFACTS = ["fa.bwt.heads", "fa.bwt.len", "fa.thr_pos", "fa.col_mums",
             "lengths", "fa.col_runs", "fa.col_ids", "fa.col_pml"]


@pytest.fixture(scope="module")
def golden(tmp_path_factory):
    """The goldens' collection built by both packages."""
    tmp = tmp_path_factory.mktemp("golden")
    for f in ("seq1.fa", "seq2.fa", "pattern.fa"):
        shutil.copy(GOLD / f, tmp / f)
    fastas = [str(tmp / "seq1.fa"), str(tmp / "seq2.fa")]
    jax_build(fastas, str(tmp / "jax"), ColBwtConfig(**CFG))
    build_pipeline(fastas, str(tmp / "torch"), ColBwtConfig(**CFG),
                   device="cpu")
    return tmp


@pytest.mark.parametrize("ext", ARTIFACTS)
def test_build_artifacts_match_jax(golden, ext):
    assert (golden / f"torch.{ext}").read_bytes() == \
        (golden / f"jax.{ext}").read_bytes()


def test_index_arrays_match_jax(golden):
    a = np.load(golden / "torch.colpml.npz")
    b = np.load(golden / "jax.colpml.npz")
    assert sorted(a.files) == sorted(b.files)
    for name in a.files:
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)


def _query_outputs(golden, pkg, engine, tag, **cfg):
    """Query the goldens' reads through `pkg` into a file named by `tag`;
    returns the four output files' bytes."""
    pat = golden / f"{tag}.{pkg}.fa"
    shutil.copy(golden / "pattern.fa", pat)
    c = ColBwtConfig(**CFG, engine=engine, **cfg)
    if pkg == "jax":
        jax_query(str(golden / "jax"), str(pat), c, write_text=True)
    else:
        query_pipeline(str(golden / "torch"), str(pat), c, write_text=True,
                       device="cpu")
    return {ext: Path(f"{pat}.{ext}").read_bytes()
            for ext in ("split.pml.bin", "split.cid.bin", "pml", "cid")}


@pytest.mark.parametrize("engine,cfg", [
    ("auto", {}),
    ("pos", {}),
    ("pos", {"long_read_len": 40, "long_read_chunk": 32}),
], ids=["auto-xla", "pos", "pos-long-reads"])
def test_query_matches_jax_and_goldens(golden, engine, cfg):
    tag = f"{engine}{len(cfg)}"
    got = _query_outputs(golden, "torch", engine, tag, **cfg)
    want = _query_outputs(golden, "jax", engine, tag, **cfg)
    assert got == want
    assert got["pml"] == (GOLD / "pattern.fa.pml.golden").read_bytes()
    assert got["cid"] == (GOLD / "pattern.fa.cid.golden").read_bytes()


def test_cli_build_and_query_match_library(golden, tmp_path):
    fastas = [str(golden / "seq1.fa"), str(golden / "seq2.fa")]
    out = str(tmp_path / "cli")
    assert torch_cli(["build", "-o", out, "-r", "-l", "20", "-s", "10",
                      "--device", "cpu", *fastas]) == 0
    for ext in ARTIFACTS[:-1]:  # .fa.col_pml goes with --keep only
        assert Path(f"{out}.{ext}").read_bytes() == \
            (golden / f"torch.{ext}").read_bytes(), ext
    pat = tmp_path / "pattern.fa"
    shutil.copy(GOLD / "pattern.fa", pat)
    assert torch_cli(["query", out, "-p", str(pat), "--text",
                      "--device", "cpu"]) == 0
    assert (tmp_path / "pattern.fa.pml").read_bytes() == \
        (GOLD / "pattern.fa.pml.golden").read_bytes()
    outs = [tmp_path / f"pattern.fa.split.{x}.bin" for x in ("pml", "cid")]
    one_shot = [f.read_bytes() for f in outs]
    assert torch_cli(["query", out, "-p", str(pat), "--stream",
                      "--device", "cpu"]) == 0
    assert [f.read_bytes() for f in outs] == one_shot


@pytest.mark.parametrize("engine,wide,item", [
    ("fused", None, "item 9"),
], ids=["fused"])
def test_engines_not_ported_raise(engine, wide, item):
    """Every engine is ported now (the fused one, ROADMAP Queue 1 `item`,
    last): where the JAX ladder picks the fused engine the port picks it
    too, raises nothing and substitutes no other engine."""
    from colbwt_tpu.pipeline.engines import QueryEngines as JaxEngines

    tbl, _ = build_index(random_docs(np.random.default_rng(5), 2, lo=60,
                                     hi=90))
    split = ColPmlIndex.build(tbl, ff_bound=2, wide=wide)
    cfg = ColBwtConfig(engine=engine)
    eng = QueryEngines(split, cfg, total_chars=10, device="cpu")
    assert eng.name == JaxEngines(split, cfg, total_chars=10).name == engine
    assert eng.ft is not None


@pytest.mark.parametrize("ff", [1, 2])
def test_fused_dispatch_uploads_uint8_ids(ff, monkeypatch):
    """The fused engine's dispatch sends its dense ids up as uint8 (a
    quarter of int32's bytes), and its records equal JAX's query_batch."""
    import torch

    from colbwt_tpu.ops import query_fused as JF
    from colbwt_tpu_torch.ops import query_fused as TF

    rng = np.random.default_rng(0xD158 + ff)
    docs = random_docs(rng, 3, lo=80, hi=160)
    tbl, _ = build_index(docs)
    split = ColPmlIndex.build(tbl, ff_bound=ff)
    reads = (make_reads(rng, docs, 40, lo=1, hi=120)
             + [b"", b"NNACGTN", b"XAC"])
    eng = QueryEngines(split, ColBwtConfig(engine="fused"), total_chars=10,
                       device="cpu")
    assert eng.name == "fused"
    kinds = []
    scan = TF.query_batch_fused

    def spy(ft, patterns, lengths, ff_bound=4):
        kinds.append(patterns.dtype)
        return scan(ft, patterns, lengths, ff_bound)

    monkeypatch.setattr(TF, "query_batch_fused", spy)
    padded = 128
    p, c, lens = QueryEngines.materialize(eng.dispatch(reads, padded))
    assert kinds == [torch.uint8]
    wp, wc = JF.query_batch(split, reads, max_len=padded)
    np.testing.assert_array_equal(lens, [len(r) for r in reads])
    for i, read in enumerate(reads):
        np.testing.assert_array_equal(p[i, padded - len(read):], wp[i])
        np.testing.assert_array_equal(c[i, padded - len(read):], wc[i])


def test_unsplit_wide_index_refused():
    tbl, _ = build_index(random_docs(np.random.default_rng(5), 2, lo=60,
                                     hi=90))
    wide = ColPmlIndex.from_table(tbl, wide=True)
    with pytest.raises(ValueError, match="run splitting"):
        QueryEngines(wide, ColBwtConfig(), total_chars=10, device="cpu")


def _build_both(golden, tag, **cfg):
    """The goldens' collection built by both packages under `cfg`."""
    fastas = [str(golden / "seq1.fa"), str(golden / "seq2.fa")]
    for pkg, build in (("jax", jax_build), ("torch", build_pipeline)):
        kw = {"device": "cpu"} if pkg == "torch" else {}
        build(fastas, str(golden / f"{tag}{pkg}"),
              ColBwtConfig(**CFG, **cfg), **kw)


def _oracle_table(prefix):
    heads, lens = F.read_rlbwt(f"{prefix}.fa")
    return O.build_col_pml(
        heads, lens, np.flatnonzero(F.read_sdsl_bit_vector(
            f"{prefix}.fa.col_runs")),
        F.read_col_ids(f"{prefix}.fa.col_ids").astype(np.int64),
        F.read_thresholds_file(f"{prefix}.fa.thr_pos").astype(np.int64))


def test_mega_pipeline_matches_jax_and_goldens(golden):
    """An index built with run_split="always": a small query makes the
    ladder pick the mega engine by itself (engines.py:62-69)."""
    _build_both(golden, "split", run_split="always")
    pat = {}
    for pkg in ("jax", "torch"):
        pat[pkg] = golden / f"mega.{pkg}.fa"
        shutil.copy(golden / "pattern.fa", pat[pkg])
        index = ColPmlIndex.load(golden / f"split{pkg}.colpml.npz")
        assert index.ff_bound >= 2
    eng = QueryEngines(index, ColBwtConfig(**CFG), total_chars=10_000,
                       device="cpu")
    assert eng.name == "mega" and eng.supports_long_streaming()
    query_pipeline(str(golden / "splittorch"), str(pat["torch"]),
                   ColBwtConfig(**CFG), write_text=True, device="cpu")
    jax_query(str(golden / "splitjax"), str(pat["jax"]), ColBwtConfig(**CFG),
              write_text=True)
    for ext in ("split.pml.bin", "split.cid.bin", "pml", "cid"):
        assert Path(f"{pat['torch']}.{ext}").read_bytes() == \
            Path(f"{pat['jax']}.{ext}").read_bytes(), ext
    assert Path(f"{pat['torch']}.pml").read_bytes() == \
        (GOLD / "pattern.fa.pml.golden").read_bytes()
    assert Path(f"{pat['torch']}.cid").read_bytes() == \
        (GOLD / "pattern.fa.cid.golden").read_bytes()


def test_wide_pipeline_matches_jax_and_oracle(golden):
    """wide_n_limit=100 forces the whole wide path on the goldens: int64
    fields, run-length capping, run splitting and the mega-wide engine, with
    one long read through the chunked scan (long_read_len=128)."""
    _build_both(golden, "wide", wide_n_limit=100)
    docs = [r.seq for f in ("seq1.fa", "seq2.fa")
            for r in read_fasta(golden / f)]
    reads = [r.seq for r in read_fasta(golden / "pattern.fa")][:6] + [
        docs[0][:380], docs[1][30:90] + b"N" + docs[1][91:200]]
    qcfg = ColBwtConfig(**CFG, wide_n_limit=100, long_read_len=128)
    out = {}
    for pkg, query in (("jax", jax_query), ("torch", query_pipeline)):
        pat = golden / f"wmix.{pkg}.fa"
        write_fasta(pat, [FastaRecord(f"w{i}", s)
                          for i, s in enumerate(reads)])
        kw = {"device": "cpu"} if pkg == "torch" else {}
        _, pmls, cids = query(str(golden / f"wide{pkg}"), str(pat), qcfg,
                              **kw)
        out[pkg] = [Path(f"{pat}.{ext}").read_bytes()
                    for ext in ("split.pml.bin", "split.cid.bin")]
    index = ColPmlIndex.load(golden / "widetorch.colpml.npz")
    assert index.wide and index.ff_bound >= 2
    assert out["torch"] == out["jax"]
    tbl = _oracle_table(golden / "widetorch")
    for s, pml, cid in zip(reads, pmls, cids):
        ep, ec = O.query_pml_oracle(tbl, s)
        np.testing.assert_array_equal(pml, ep, err_msg=repr(s))
        np.testing.assert_array_equal(cid, ec, err_msg=repr(s))


def test_wide_cids_take_two_planes_on_mega():
    """An index whose col ids exceed 8 bits (an id_bits > 8 build) gets
    exact two-plane outputs from the mega engine, equal to the JAX
    package's (tests/test_review_fixes.py:192-225) in every real column;
    the port scans its dispatch masked, so its pad columns are zeros
    where JAX's hold its walk past the read."""
    from colbwt_tpu.pipeline.engines import QueryEngines as JaxEngines

    rng = np.random.default_rng(0xC1D)
    base = bytes(rng.choice(list(b"ACGT"), 300).astype("uint8"))
    docs = random_docs(rng, 3, mutate_from=base)
    tbl, _ = build_index(docs)
    index = ColPmlIndex.build(tbl, ff_bound=2)
    index.col_id = index.col_id.copy()
    index.col_id[index.col_id.argmax()] = 300
    cfg = ColBwtConfig(engine="mega")
    eng = QueryEngines(index, cfg, total_chars=10_000_000, device="cpu")
    assert eng.use_mega and not eng._cid8
    jeng = JaxEngines(index, cfg, total_chars=10_000_000)
    reads = make_reads(rng, docs, 8)
    for padded, batch in ((64, reads), (256, reads + [docs[0][:200]])):
        p, c, lens = QueryEngines.materialize(eng.dispatch(batch, padded))
        assert c is not None  # two-plane path, no truncating pack
        jp, jc, jl = JaxEngines.materialize(jeng.dispatch(batch, padded))
        np.testing.assert_array_equal(lens, jl)
        real = np.arange(p.shape[1])[None, :] >= p.shape[1] - lens[:, None]
        np.testing.assert_array_equal(p[real], jp[real])
        np.testing.assert_array_equal(c[real], jc[real])
        assert not p[~real].any() and not c[~real].any()


@pytest.fixture(scope="module")
def lanes(golden):
    """The goldens' collection built by both packages on the device lane
    (_DEVICE_MIN_N = 0 in both: the device multi-MUM scan and col-split,
    the plain PyTorch versions here; the host oracle's scan and walk raise
    if either package reaches them) in tunnels and all mode, and by the
    port's chunked SA lane, whose artifacts must equal the JAX package's
    monolithic build (`golden`'s jax.*)."""
    fastas = [str(golden / "seq1.fa"), str(golden / "seq2.fa")]

    def host_route(*a, **kw):
        raise AssertionError("the host oracle ran on the device lane")

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JB, "_DEVICE_MIN_N", 0)
        mp.setattr(TB, "_DEVICE_MIN_N", 0)
        for oracle in (O, TO):
            mp.setattr(oracle, "find_multi_mums", host_route)
            mp.setattr(oracle, "col_split_oracle", host_route)
        for mode in ("tunnels", "all"):
            cfg = ColBwtConfig(**CFG, mode=SplitMode(mode))
            jax_build(fastas, str(golden / f"dev_{mode}.jax"), cfg)
            build_pipeline(fastas, str(golden / f"dev_{mode}.torch"), cfg,
                           device="cpu")
    build_pipeline(fastas, str(golden / "chunked.torch"),
                   ColBwtConfig(**CFG, sa_mode="chunked", chunk_chars=1000),
                   device="cpu")
    assert not (golden / "chunked.torch.chunked_cache").exists()
    return golden


LANES = {"device-tunnels": ("dev_tunnels.torch", "dev_tunnels.jax"),
         "device-all": ("dev_all.torch", "dev_all.jax"),
         "chunked": ("chunked.torch", "jax")}


@pytest.mark.parametrize("ext", ARTIFACTS)
@pytest.mark.parametrize("lane", list(LANES))
def test_lane_artifacts_match_jax(lanes, lane, ext):
    got, want = LANES[lane]
    assert (lanes / f"{got}.{ext}").read_bytes() == \
        (lanes / f"{want}.{ext}").read_bytes()


@pytest.mark.parametrize("lane", list(LANES))
def test_lane_index_arrays_match_jax(lanes, lane):
    got, want = LANES[lane]
    a = np.load(lanes / f"{got}.colpml.npz")
    b = np.load(lanes / f"{want}.colpml.npz")
    assert sorted(a.files) == sorted(b.files)
    for name in a.files:
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)


def test_all_mode_device_lane_differs_from_tunnels(lanes):
    """The two modes' walks mark differently on this collection, so the
    all-mode comparison above is not the tunnels one twice."""
    assert (lanes / "dev_all.torch.fa.col_ids").read_bytes() != \
        (lanes / "dev_tunnels.torch.fa.col_ids").read_bytes()


def test_cli_chunked_lane_matches_library(golden, tmp_path):
    fastas = [str(golden / "seq1.fa"), str(golden / "seq2.fa")]
    out = str(tmp_path / "cli")
    assert torch_cli(["build", "-o", out, "-r", "-l", "20", "-s", "10",
                      "--sa-mode", "chunked", "--chunk-chars", "1000",
                      "--device", "cpu", *fastas]) == 0
    for ext in ARTIFACTS[:-1]:  # .fa.col_pml goes with --keep only
        assert Path(f"{out}.{ext}").read_bytes() == \
            (golden / f"torch.{ext}").read_bytes(), ext


def test_build_logs_stage_seconds(golden, tmp_path, caplog):
    """build_pipeline attaches each stage's seconds and the MUM and mark
    counts to its log records."""
    import logging

    fastas = [str(golden / "seq1.fa"), str(golden / "seq2.fa")]
    with caplog.at_level(logging.INFO, logger="colbwt_torch.build"):
        build_pipeline(fastas, str(tmp_path / "t"), ColBwtConfig(**CFG),
                       device="cpu")
    values = {}
    for rec in caplog.records:
        for key in ("sa_lcp_s", "bwt_s", "mums_s", "thresholds_s",
                    "colsplit_s", "index_s", "build_s", "mums", "marks"):
            if hasattr(rec, key):
                values[key] = getattr(rec, key)
    assert set(values) == {"sa_lcp_s", "bwt_s", "mums_s", "thresholds_s",
                           "colsplit_s", "index_s", "build_s", "mums",
                           "marks"}
    num_docs, ml, _ = F.read_col_mums(str(tmp_path / "t.fa.col_mums"))
    assert values["mums"] == ml.size > 0
    assert all(values[k] >= 0 for k in values)


def test_n_reads_through_pos_pipeline_match_jax(golden, tmp_path):
    """Reads with N bytes take the general-T1 fallback of the pos engine."""
    docs = [r.seq for f in ("seq1.fa", "seq2.fa")
            for r in read_fasta(golden / f)]
    reads = [docs[0][10:60], docs[1][5:40] + b"N" + docs[1][41:90],
             b"NNNN", docs[0][100:130] + b"NN" + docs[0][132:200]]
    pat = tmp_path / "n.fa"
    write_fasta(pat, [FastaRecord(f"r{i}", s) for i, s in enumerate(reads)])
    _, pmls, cids = query_pipeline(str(golden / "torch"), str(pat),
                                   ColBwtConfig(**CFG, engine="pos"),
                                   device="cpu")
    _, jp, jc = jax_query(str(golden / "jax"), str(pat),
                          ColBwtConfig(**CFG, engine="pos"))
    for read, p, c, a, b in zip(reads, pmls, cids, jp, jc):
        np.testing.assert_array_equal(p, a, err_msg=repr(read))
        np.testing.assert_array_equal(c, b, err_msg=repr(read))


@pytest.mark.parametrize("threshold,warns", [(None, 1), ("n", 1),
                                             ("n+1", 0)],
                         ids=["lowered", "at-count", "above-count"])
def test_large_query_warns_as_jax(golden, tmp_path, caplog, monkeypatch,
                                  threshold, warns):
    """The one-shot query warns from LARGE_QUERY_READS reads held in host
    memory (the JAX package's 1,000,000, lowered here), with the JAX
    package's text (colbwt_tpu/pipeline/build.py:query_pipeline)."""
    import inspect
    import logging

    pat = tmp_path / "w.fa"
    shutil.copy(golden / "pattern.fa", pat)
    n = len(list(read_fasta(pat)))
    assert TB.LARGE_QUERY_READS == 1_000_000 and n >= 3
    limit = {None: 3, "n": n, "n+1": n + 1}[threshold]
    monkeypatch.setattr(TB, "LARGE_QUERY_READS", limit)
    with caplog.at_level(logging.INFO, logger="colbwt_torch.query"):
        query_pipeline(str(golden / "torch"), str(pat), ColBwtConfig(**CFG),
                       device="cpu")
    got = [r for r in caplog.records if r.levelno == logging.WARNING]
    assert len(got) == warns
    if warns:
        text = ("%d reads held in host memory by the one-shot query path — "
                "use --stream for bounded-memory streaming at this scale")
        assert got[0].msg == text and got[0].getMessage() == text % n
        src = inspect.getsource(JB.query_pipeline)
        assert "if len(reads) >= 1_000_000:" in src
        for half in text.split("— "):
            assert half.strip() in src


def test_file_list_build_past_the_tile_route_matches_jax(tmp_path,
                                                          monkeypatch):
    """1,030 genomes of 255 bp given through a file list (`build -i`),
    n = 263,680 >= 2**18, so both packages take their device branch (the
    port's plain versions here), the multi-MUM scan through the chunked
    route (its cut-off lowered in both) at N > _TILE_MAX_N: every artifact
    and the index byte-equal to the JAX package's build."""
    import colbwt_tpu.ops.construct_jax as CJ
    import colbwt_tpu_torch.ops.construct as TC

    monkeypatch.setattr(CJ, "_CHUNKED_SCAN_MIN_N", 1 << 10)
    monkeypatch.setattr(TC, "_CHUNKED_SCAN_MIN_N", 1 << 10)
    chunks = []
    real = TC.mum_scan_chunk

    def spy(*args):
        chunks.append(args[-1])
        return real(*args)

    monkeypatch.setattr(TC, "mum_scan_chunk", spy)
    rng = np.random.default_rng(0xC0F3)
    N, length = 1030, 255
    acgt = np.frombuffer(b"ACGT", np.uint8)
    base = rng.choice(acgt, length)
    sites = rng.choice(length, 12, replace=False)
    files = []
    for d in range(N):
        a = base.copy()
        pos = rng.choice(sites, 2, replace=False)
        a[pos] = rng.choice(acgt, 2)
        files.append(tmp_path / f"g{d}.fa")
        write_fasta(str(files[-1]), [FastaRecord(f"g{d}", a.tobytes())])
    listing = tmp_path / "genomes.txt"
    listing.write_text("".join(f"{f}\n" for f in files))
    assert N > TC._TILE_MAX_N and N * (length + 1) >= TB._DEVICE_MIN_N
    cfg = dict(min_mum=20, split_rate=10, keep_temp=True)
    jax_build([], str(tmp_path / "jax"), ColBwtConfig(**cfg),
              filelist=str(listing))
    assert torch_cli(["build", "-i", str(listing), "-o",
                      str(tmp_path / "torch"), "-m", "tunnels", "-s", "10",
                      "-l", "20", "--keep", "--device", "cpu"]) == 0
    for ext in ARTIFACTS:
        assert (tmp_path / f"torch.{ext}").read_bytes() == \
            (tmp_path / f"jax.{ext}").read_bytes(), ext
    num_docs, ml, _ = F.read_col_mums(str(tmp_path / "torch.fa.col_mums"))
    assert num_docs == N and ml.size > 0 and chunks == [N]
    a = np.load(tmp_path / "torch.colpml.npz")
    b = np.load(tmp_path / "jax.colpml.npz")
    assert sorted(a.files) == sorted(b.files)
    for name in a.files:
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)


def test_run_past_the_col_pml_offset_field(tmp_path):
    """The smallest input whose table has an offset into a run past
    65,535 (one document, 65,537 A's then a C: the head of the C's run
    maps 65,536 positions into the run of A's; config #3's 10,000
    near-identical genomes have such offsets): the reference's .col_pml
    rows keep that offset in 2 bytes, so the JAX package's build raises
    there, and the port's writes no .col_pml, builds the index and answers
    as the oracle."""
    fa = tmp_path / "a.fa"
    write_fasta(str(fa), [FastaRecord("a", b"A" * 65_537 + b"C")])
    cfg = dict(min_mum=20, split_rate=10, keep_temp=True)
    with pytest.raises(OverflowError):
        jax_build([str(fa)], str(tmp_path / "jax"), ColBwtConfig(**cfg))
    index = build_pipeline([str(fa)], str(tmp_path / "torch"),
                           ColBwtConfig(**cfg), device="cpu")
    assert not (tmp_path / "torch.fa.col_pml").exists()
    assert int(index.n) == 65_539
    heads, lens = F.read_rlbwt(str(tmp_path / "torch.fa"))
    tbl = TO.build_col_pml(
        heads, lens,
        np.flatnonzero(F.read_sdsl_bit_vector(
            str(tmp_path / "torch.fa.col_runs"))),
        F.read_col_ids(str(tmp_path / "torch.fa.col_ids")).astype(np.int64),
        F.read_thresholds_file(str(tmp_path / "torch.fa.thr_pos")
                               ).astype(np.int64))
    assert int(np.max(tbl.dest_offset)) == 65_536
    reads = [b"A" * 150, b"AAAAC" + b"A" * 40, b"C" * 10]
    pat = tmp_path / "reads.fa"
    write_fasta(str(pat), [FastaRecord(f"r{i}", r)
                           for i, r in enumerate(reads)])
    query_pipeline(str(tmp_path / "torch"), str(pat),
                   ColBwtConfig(**cfg), device="cpu")
    from colbwt_tpu_torch.io.pml_out import read_pml_cid_binary

    _, pmls = read_pml_cid_binary(f"{pat}.split.pml.bin")
    _, cids = read_pml_cid_binary(f"{pat}.split.cid.bin")
    for r, pm, ci in zip(reads, pmls, cids):
        ep, ec = TO.query_pml_oracle(tbl, r)
        np.testing.assert_array_equal(pm, ep)
        np.testing.assert_array_equal(ci, ec)
