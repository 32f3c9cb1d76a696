"""BASELINE config #4 (8 chr21-scale haplotypes, n = 368,000,008) on the
CPU: chip_smoke.py's generator against scripts/validate_config4.py's, the
decisions config #4 makes by its n (pos k = 1 over ACGT keys, no general
T1, a run-split index) in both packages, and a config-#4-shaped collection
(8 haplotypes, config #4's substitution density, min-MUM 100) built and
streamed by both packages with those decisions forced.  Phase 15 of
chip_smoke.py and `chip_smoke.py --config4` run it on the card."""

from __future__ import annotations

import inspect
import logging
import types
from pathlib import Path

import numpy as np
import pytest

import colbwt_tpu.ops.query_pos as JQ
import colbwt_tpu.ops.query_xla as JX
import colbwt_tpu.pipeline.build as JB
import colbwt_tpu.pipeline.engines as JE
import colbwt_tpu_torch.ops.query_pos as TQ
import colbwt_tpu_torch.ops.query_xla as TX
import colbwt_tpu_torch.pipeline.build as TB
import colbwt_tpu_torch.pipeline.engines as TE
from chip_smoke import (CONFIG4, config4_docs, config4_muts, config4_reads,
                        write_config4_reads)
from colbwt_tpu.io.fasta import FastaRecord, read_fasta, write_fasta
from colbwt_tpu.pipeline import build_pipeline as jax_build
from colbwt_tpu.pipeline.stream import query_stream as jax_stream
from colbwt_tpu.utils.config import ColBwtConfig, SplitMode
from colbwt_tpu_torch.pipeline import build_pipeline, query_stream

ARTIFACTS = ["fa.bwt.heads", "fa.bwt.len", "fa.thr_pos", "fa.col_mums",
             "lengths", "fa.col_runs", "fa.col_ids", "fa.col_pml"]
N_FULL = 368_000_008  # logs/config4_r3.log
# 1, A, C, G, T: the dense alphabet of an ACGT collection (sigma = 5)
ALPHABET = np.frombuffer(b"\x01ACGT", np.uint8)


def validate_config4_generator(docs_n: int, doc_len: int, muts: int,
                               reads_n: int) -> tuple[list, list]:
    """scripts/validate_config4.py:52-60 (the haplotypes) and :107-114
    (the reads), quoted with its `args` as arguments."""
    rng = np.random.default_rng(0xC4)
    base = rng.choice(np.frombuffer(b"ACGT", dtype=np.uint8), doc_len)
    docs = []
    for _ in range(docs_n):
        a = base.copy()
        pos = rng.integers(0, doc_len, muts)
        a[pos] = rng.choice(np.frombuffer(b"ACGT", dtype=np.uint8), muts)
        docs.append(a.tobytes())
    del base

    reads = []
    for _ in range(reads_n):
        d = docs[int(rng.integers(0, docs_n))]
        s = int(rng.integers(0, doc_len - 150))
        arr = bytearray(d[s:s + 150])
        for _ in range(int(rng.integers(0, 4))):
            arr[int(rng.integers(0, 150))] = int(rng.choice(list(b"ACGT")))
        reads.append(bytes(arr))
    return docs, reads


@pytest.mark.parametrize("doc_len", [4_000, 20_000])
def test_generator_equals_validate_config4(doc_len, tmp_path):
    """(a) chip_smoke's haplotypes and reads at a small length are
    validate_config4.py's, and the FASTA it writes holds them, then the
    N reads: each one of those reads with one N inserted."""
    muts = config4_muts(doc_len)
    want_docs, want_reads = validate_config4_generator(
        CONFIG4["docs"], doc_len, muts, 3_000)
    docs, rng = config4_docs(doc_len, muts)
    assert docs == want_docs
    assert config4_reads(docs, rng, 3_000) == want_reads
    assert config4_muts(CONFIG4["doc_len"]) == CONFIG4["muts"]

    path = tmp_path / "reads.fa"
    write_config4_reads(str(path), doc_len, muts, 3_000)
    recs = list(read_fasta(path))
    assert [r.name for r in recs] == (
        [f"q{i}" for i in range(3_000)]
        + [f"n{i}" for i in range(CONFIG4["n_reads"])])
    assert [r.seq for r in recs[:3_000]] == want_reads
    for r in recs[3_000:]:
        p = r.seq.index(b"N")
        assert r.seq.count(b"N") == 1 and len(r.seq) == 151
        assert r.seq[:p] + r.seq[p + 1:] in want_reads


def stub_index(n: int):
    """What choose_k, fits and keeps_general_t1 read of an index."""
    return types.SimpleNamespace(n=n, wide=False, sigma=ALPHABET.size)


@pytest.mark.parametrize("budget", [13 << 30, 60 << 30,
                                    4 * N_FULL * 8,
                                    (4 + ALPHABET.size + 1) * N_FULL * 8])
def test_config4_pos_decisions_equal_jax(budget):
    """(b) At config #4's n both packages pick k = 1 over ACGT keys, no k
    over every char (6·n > 2**31 - 1), and keep no general T1, at any
    budget from the tables' own 4·n·8 bytes up (the port's budget on an
    80 GB card is 60 GB; validate_config4.py's 13 GiB)."""
    index = stub_index(N_FULL)
    A_full = ALPHABET.size + 1
    for k in range(1, 5):
        for A in (4, A_full):
            assert TQ.fits(index, k, A) == JQ.fits(index, k, A)
    assert not TQ.fits(index, 1, A_full) and TQ.fits(index, 1, 4)
    for alphabet in (None, b"ACGT"):
        assert TQ.choose_k(index, budget, alphabet) == \
            JQ.choose_k(index, budget, alphabet)
    assert TQ.choose_k(index, budget) == 0
    assert TQ.choose_k(index, budget, b"ACGT") == 1
    # the JAX package decides inline, in build_pos_tables
    src = inspect.getsource(JQ.build_pos_tables)
    assert ("if fits(index, 1, A_full)\n                      and (A_key ** k"
            " + A_full) * n * 8 <= hbm_budget_bytes") in src
    jax_keeps = (JQ.fits(index, 1, A_full)
                 and (4 ** 1 + A_full) * index.n * 8 <= budget)
    assert TQ.keeps_general_t1(index, 1, b"ACGT", budget) == jax_keeps
    assert not jax_keeps


class _Decided(Exception):
    pass


@pytest.mark.parametrize("run_split", ["auto", "always"])
def test_config4_run_split_equals_jax(run_split, tmp_path, monkeypatch):
    """(b) stage_index of both packages on a table of config #4's n (its
    col-PML table a stub, its files a small build's): both split the runs
    (n > 2**28), under "auto" as under "always"."""
    fa = tmp_path / "d.fa"
    write_fasta(str(fa), [FastaRecord("d", b"ACGTTGCA" * 40)])
    prefix = str(tmp_path / "small")
    build_pipeline([str(fa)], prefix, ColBwtConfig(keep_temp=True),
                   device="cpu")
    stub = types.SimpleNamespace(
        n=N_FULL, bwt_r=36_212_696, char=ALPHABET.copy(),
        idx=np.arange(5), dest_interval=np.zeros(5, np.int64),
        dest_offset=np.zeros(5, np.int64), col_id=np.zeros(5, np.uint8),
        threshold=np.zeros(5, np.int64))
    got = {}
    for name, mod in (("jax", JB), ("torch", TB)):
        def decided(which, name=name):
            def record(*a, **kw):
                got[name] = which
                raise _Decided
            return record

        monkeypatch.setattr(mod.O, "build_col_pml", lambda *a, **kw: stub)
        monkeypatch.setattr(mod.F, "write_col_pml_file", lambda *a, **kw: 0)
        monkeypatch.setattr(mod.ColPmlIndex, "build", decided("split"))
        monkeypatch.setattr(mod.ColPmlIndex, "from_table",
                            decided("unsplit"))
        cfg = ColBwtConfig(force=True, run_split=run_split)
        logger = logging.getLogger("test_torch_config4")
        with pytest.raises(_Decided):
            if mod is JB:
                mod.stage_index(prefix, cfg, logger)
            else:
                mod.stage_index(prefix, cfg, logger, "cpu")
    assert got == {"jax": "split", "torch": "split"}


DOC_LEN = 40_000  # 8 x 40,001 = 320,008 >= 2**18: the device branch


@pytest.fixture(scope="module")
def collection(tmp_path_factory):
    """A config-#4-shaped collection (8 haplotypes of DOC_LEN bp at config
    #4's density, min-MUM 100, tunnels, split rate 10) built by both
    packages with the run split forced, through a file list as `build -i`;
    and its reads with N reads (write_config4_reads)."""
    tmp = tmp_path_factory.mktemp("config4")
    muts = config4_muts(DOC_LEN)
    docs, _ = config4_docs(DOC_LEN, muts)
    files = []
    for i, d in enumerate(docs):
        files.append(tmp / f"hap{i}.fa")
        write_fasta(str(files[-1]), [FastaRecord(f"hap{i}", d)])
    listing = tmp / "haplotypes.txt"
    listing.write_text("".join(f"{f}\n" for f in files))
    n = sum(len(d) + 1 for d in docs)
    assert n >= TB._DEVICE_MIN_N == JB._DEVICE_MIN_N
    cfg = ColBwtConfig(mode=SplitMode.TUNNELS, split_rate=10,
                       min_mum=CONFIG4["min_mum"], run_split="always",
                       keep_temp=True)
    jax_build([], str(tmp / "jax"), cfg, filelist=str(listing))
    build_pipeline([], str(tmp / "torch"), cfg, filelist=str(listing),
                   device="cpu")
    write_config4_reads(str(tmp / "reads.fa"), DOC_LEN, muts, 3_000)
    return tmp, n


@pytest.mark.parametrize("ext", ARTIFACTS)
def test_config4_shaped_build_artifacts_equal_jax(collection, ext):
    """(c) every artifact byte-equal to the JAX package's build."""
    tmp, _ = collection
    assert (tmp / f"torch.{ext}").read_bytes() == \
        (tmp / f"jax.{ext}").read_bytes()


def test_config4_shaped_index_equal_jax(collection):
    """(c) the run-split index byte-equal to the JAX package's, and run
    split indeed (ff_bound 2, more rows than the table's col runs)."""
    from colbwt_tpu_torch.io import formats as F

    tmp, n = collection
    a = np.load(tmp / "torch.colpml.npz")
    b = np.load(tmp / "jax.colpml.npz")
    assert sorted(a.files) == sorted(b.files)
    for name in a.files:
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)
    from colbwt_tpu_torch.models.index import ColPmlIndex

    index = ColPmlIndex.load(str(tmp / "torch.colpml.npz"))
    col_runs = int(F.read_sdsl_bit_vector(str(tmp / "torch.fa.col_runs"))
                   .sum())
    assert index.n == n and index.ff_bound == 2 and index.r > col_runs
    _, ml, _ = F.read_col_mums(str(tmp / "torch.fa.col_mums"))
    assert ml.size > 0 and ml.min() >= CONFIG4["min_mum"]


def test_config4_shaped_stream_equals_jax(collection, monkeypatch):
    """(d) `query_stream` of the reads and N reads under a budget that
    keeps k = 1 over ACGT keys and drops the general T1 (5·n·8 bytes,
    within [4·n·8, (4 + sigma + 1)·n·8)): in both packages the engine is
    pos(k = 1) over ACGT keys without a general T1, the N reads, and only
    they, take the compact engine (K4 on the card), and the records are
    byte-equal."""
    tmp, n = collection
    budget = 5 * n * 8
    reads = {r.name: r.seq for r in read_fasta(tmp / "reads.fa")}
    n_names = [k for k in reads if k.startswith("n")]
    assert len(n_names) == CONFIG4["n_reads"]
    compact = {}
    for name, mod in (("jax", JX), ("torch", TX)):
        real = mod.query_batch_device

        def spy(tb, enc, lens, *a, name=name, real=real, **kw):
            compact[name] = compact.get(name, 0) + int(enc.shape[0])
            return real(tb, enc, lens, *a, **kw)

        monkeypatch.setattr(mod, "query_batch_device", spy)
    engines = {}
    for name, mod in (("jax", JE), ("torch", TE)):
        class Recorded(mod.QueryEngines):
            def __init__(self, *a, name=name, **kw):
                super().__init__(*a, **kw)
                engines[name] = self

        monkeypatch.setattr(mod, "QueryEngines", Recorded)
    out = {}
    for name in ("jax", "torch"):
        pat = tmp / f"stream.{name}.fa"
        pat.write_bytes((tmp / "reads.fa").read_bytes())
        cfg = ColBwtConfig(pos_hbm_budget=budget, batch_size=1024,
                           table_cache="off")
        if name == "jax":
            jax_stream(str(tmp / "jax"), str(pat), cfg)
        else:
            query_stream(str(tmp / "torch"), str(pat), cfg, device="cpu")
        eng = engines[name]
        assert eng.name == "pos(k=1)", (name, eng.name)
        assert eng.pt["A"] == 4 and eng.pt["t1"] is None, name
        out[name] = [Path(f"{pat}.split.{x}.bin").read_bytes()
                     for x in ("pml", "cid")]
    assert out["torch"] == out["jax"]
    assert compact == {"jax": len(n_names), "torch": len(n_names)}


def test_config4_shaped_tables_drop_the_general_t1(collection):
    """(d) the engine the budget gives: k = 1 over ACGT keys with no
    general T1, where a budget of (4 + sigma + 1)·n·8 keeps it."""
    from colbwt_tpu_torch.models.index import ColPmlIndex
    from colbwt_tpu_torch.pipeline.engines import QueryEngines

    tmp, n = collection
    index = ColPmlIndex.load(str(tmp / "torch.colpml.npz"))
    A_full = index.sigma + 1
    assert A_full == 6
    for budget, t1 in ((5 * n * 8, False), ((4 + A_full) * n * 8, True)):
        eng = QueryEngines(index, ColBwtConfig(pos_hbm_budget=budget),
                           total_chars=None, device="cpu")
        assert eng.name == "pos(k=1)"
        assert eng.pt["A"] == 4 and eng.pt["alphabet"] == b"ACGT"
        assert (eng.pt["t1"] is not None) == t1
