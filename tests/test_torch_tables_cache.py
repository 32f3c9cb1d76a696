"""The port's persisted table cache (colbwt_tpu_torch/pipeline/tables.py)
against the JAX package: the cases of tests/test_tables_cache.py on the
port's engines on the CPU (a second engine loads its tables instead of
building them, its outputs equal the first engine's and the JAX engine's,
a stale entry is rejected, "off" writes nothing), the fingerprint equal
to JAX's, an entry of another layout a miss, the measured auto policy, the
port's own `.torch_tables/` directory and the CLI build's prewarm.  Every
compared value is an integer or a byte: exact.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from colbwt_tpu.models.index import ColPmlIndex as JaxIndex
from colbwt_tpu.pipeline import tables as JTB
from colbwt_tpu.pipeline.engines import QueryEngines as JaxEngines
from colbwt_tpu.utils.config import ColBwtConfig as JaxConfig
from colbwt_tpu_torch.cli import main as torch_cli
from colbwt_tpu_torch.models.index import ColPmlIndex
from colbwt_tpu_torch.ops.query_mega_wide import wide_table_bytes
from colbwt_tpu_torch.pipeline import query_pipeline, query_stream
from colbwt_tpu_torch.pipeline import tables as TB
from colbwt_tpu_torch.pipeline.engines import QueryEngines
from colbwt_tpu_torch.utils.config import ColBwtConfig
from tests.conftest import random_docs
from tests.test_query_xla import build_index, make_reads


def _query(eng, reads):
    p, c, lens = eng.materialize(eng.dispatch(reads, 64))
    W = p.shape[1]
    return ([p[i, W - int(lens[i]):] for i in range(len(reads))],
            [c[i, W - int(lens[i]):] for i in range(len(reads))])


def _same(a, b):
    for (pa, ca), (pb, cb) in zip(zip(*a), zip(*b)):
        np.testing.assert_array_equal(pa, pb)
        np.testing.assert_array_equal(ca, cb)


def _engine(index, cfg, tmp_path, **kw):
    return QueryEngines(index, cfg, total_chars=10**9,
                        table_dir=str(tmp_path / "t"), device="cpu", **kw)


@pytest.fixture
def rate(monkeypatch):
    """Set the measured rates (bytes a second) the auto policy sees on the
    CPU, in place of timings: `load` for `read_rate` and the load that
    `project_save` projects, `save` for the save it projects."""
    def set_rate(load, save=float("inf")):
        monkeypatch.setattr(TB, "read_rate", lambda path, dev=None: load)

        def project(dir_, tables, build_seconds, device=None):
            n = TB.dev_bytes(tables)
            return {"save_seconds": n / save, "load_seconds": n / load,
                    "probe_seconds": 0.0}
        monkeypatch.setattr(TB, "project_save", project)
    return set_rate


@pytest.fixture
def read_only(monkeypatch):
    """Make every call that writes the file system fail with EACCES, as in
    a directory the process may not write (the tests run as any user, root
    too, where a chmod would not stop a write)."""
    import errno
    import os

    def deny(real, writes=lambda *a, **k: True):
        def call(*a, **k):
            if writes(*a, **k):
                raise PermissionError(errno.EACCES, "read-only", a[0])
            return real(*a, **k)
        return call

    def on():
        flags = os.O_WRONLY | os.O_RDWR | os.O_CREAT
        monkeypatch.setattr(os, "open", deny(
            os.open, lambda path, fl, *a, **k: bool(fl & flags)))
        for name in ("mkdir", "unlink", "rmdir", "rename", "replace"):
            monkeypatch.setattr(os, name, deny(getattr(os, name)))
    return on


@pytest.mark.parametrize("engine,wide", [("pos", False), ("mega", False),
                                         ("auto", True)])
def test_roundtrip_and_reload(tmp_path, rng, engine, wide):
    """A second engine loads what the first saved; both answer as the JAX
    engine does on the same index and reads."""
    docs = random_docs(rng, 3, lo=120, hi=200)
    tbl, index = build_index(docs)
    if engine == "mega" or wide:
        index = JaxIndex.build(tbl, ff_bound=2, wide=True if wide else None)
    reads = make_reads(rng, docs, 8, lo=20, hi=50)
    cfg = ColBwtConfig(engine=engine, batch_size=8, table_cache="force")

    eng1 = _engine(index, cfg, tmp_path)
    assert [e["event"] for e in eng1.cache_events] == ["build+save"]
    p1 = _query(eng1, reads)
    eng2 = _engine(index, cfg, tmp_path)
    assert [e["event"] for e in eng2.cache_events] == ["load"]
    assert eng2.table_build_seconds == eng2.cache_events[0]["seconds"]
    _same(_query(eng2, reads), p1)
    jeng = JaxEngines(index, JaxConfig(engine=engine, batch_size=8,
                                       table_cache="off"), total_chars=10**9)
    assert jeng.name == eng2.name
    _same(_query(jeng, reads), p1)
    # the loaded tables hold exactly the keys, values and dtypes built
    want = eng1.pt if engine == "pos" else eng1.mt
    got = eng2.pt if engine == "pos" else eng2.mt
    assert got.keys() == want.keys()
    for key, v in want.items():
        if isinstance(v, torch.Tensor):
            assert got[key].dtype == v.dtype and torch.equal(got[key], v)
        elif isinstance(v, np.ndarray):
            np.testing.assert_array_equal(got[key], v)
        else:
            assert got[key] == v and type(got[key]) is type(v), key


def test_stale_cache_rejected(tmp_path, rng):
    docs = random_docs(rng, 2, lo=100, hi=160)
    _, index = build_index(docs)
    cfg = ColBwtConfig(engine="pos", batch_size=4, table_cache="force")
    eng = _engine(index, cfg, tmp_path)
    assert eng.cache_events[0]["event"] == "build+save"

    # a different collection -> different fingerprint -> rebuild, not load
    docs2 = random_docs(rng, 2, lo=100, hi=160)
    _, index2 = build_index(docs2)
    eng2 = _engine(index2, cfg, tmp_path)
    assert eng2.cache_events[0]["event"] == "build+save"

    # a format bump also invalidates
    layout = json.loads((tmp_path / "t" / "pos" / "meta.json").read_text()
                        )["layout"]
    assert TB.load_tables(tmp_path / "t", "pos", index2, "cpu",
                          layout) is not None
    old = TB.TABLES_FORMAT
    try:
        TB.TABLES_FORMAT = old + 1
        assert TB.load_tables(tmp_path / "t", "pos", index2, "cpu",
                              layout) is None
    finally:
        TB.TABLES_FORMAT = old


def test_table_cache_off(tmp_path, rng):
    docs = random_docs(rng, 2, lo=100, hi=160)
    _, index = build_index(docs)
    cfg = ColBwtConfig(engine="pos", batch_size=4, table_cache="off")
    eng = _engine(index, cfg, tmp_path)
    assert not eng.cache_events
    assert not (tmp_path / "t").exists()


def _indexes(rng):
    docs = random_docs(rng, 3, lo=80, hi=150)
    tbl, index = build_index(docs)
    return (index, JaxIndex.build(tbl, ff_bound=2),
            JaxIndex.build(tbl, ff_bound=3, wide=True))


def test_fingerprint_equals_jax(rng):
    """The same string as the JAX package's on the unsplit, the run-split
    and the wide index, carried into the port's own ColPmlIndex too."""
    for index in _indexes(rng):
        want = JTB.index_fingerprint(index)
        assert TB.index_fingerprint(index) == want
        port = ColPmlIndex.from_arrays(vars(index))
        assert TB.index_fingerprint(port) == want


@pytest.mark.parametrize("field,value", [("k", 1), ("alphabet", None),
                                         ("t1", False)])
def test_pos_layout_mismatch_is_a_miss(tmp_path, rng, field, value):
    """An entry whose pos k, key alphabet or general T1 differs from the
    engine's choice is a miss: the engine builds (and saves anew)."""
    _, index = build_index(random_docs(rng, 2, lo=100, hi=160))
    cfg = ColBwtConfig(engine="pos", table_cache="force")
    eng = _engine(index, cfg, tmp_path)
    mf = tmp_path / "t" / "pos" / "meta.json"
    meta = json.loads(mf.read_text())
    assert meta["layout"] == {"k": eng.pos_k, "alphabet": b"ACGT".hex(),
                              "t1": eng.pt["t1"] is not None}
    assert meta["layout"][field] != value
    meta["layout"][field] = value
    mf.write_text(json.dumps(meta))
    eng2 = _engine(index, cfg, tmp_path)
    assert [e["event"] for e in eng2.cache_events] == ["build+save"]
    assert json.loads(mf.read_text())["layout"] == {
        "k": eng.pos_k, "alphabet": b"ACGT".hex(),
        "t1": eng.pt["t1"] is not None}


def test_pos_k_from_budget_is_a_miss(tmp_path, rng):
    """A smaller memory budget picks a smaller k: the saved entry of the
    larger k is not loaded."""
    _, index = build_index(random_docs(rng, 2, lo=100, hi=160))
    big = _engine(index, ColBwtConfig(engine="pos", table_cache="force"),
                  tmp_path)
    budget = (4 ** (big.pos_k - 1)) * index.n * 8
    small = _engine(index, ColBwtConfig(engine="pos", table_cache="force",
                                        pos_hbm_budget=budget), tmp_path)
    assert small.pos_k == big.pos_k - 1 >= 1
    assert [e["event"] for e in small.cache_events] == ["build+save"]
    again = _engine(index, ColBwtConfig(engine="pos", table_cache="force",
                                        pos_hbm_budget=budget), tmp_path)
    assert [e["event"] for e in again.cache_events] == ["load"]


def test_wide_layout_mismatch_is_a_miss(tmp_path, rng):
    """The full mega-wide layout's entry is not loaded for an engine whose
    budget picks the compact layout, and the other way round."""
    _, _, wide = _indexes(rng)
    full = ColBwtConfig(table_cache="force")
    compact = ColBwtConfig(table_cache="force",
                           pos_hbm_budget=wide_table_bytes(wide) - 1)
    for cfg, is_compact in ((full, False), (compact, True), (full, False)):
        eng = _engine(wide, cfg, tmp_path)
        assert [e["event"] for e in eng.cache_events] == ["build+save"]
        assert ("shared" in eng.mt) == is_compact
    eng = _engine(wide, full, tmp_path)
    assert [e["event"] for e in eng.cache_events] == ["load"]
    assert "mega" in eng.mt


def test_auto_policy_is_measured(tmp_path, rng, rate):
    """Under "auto" a build is saved only when the projected save and load
    together beat it, and an entry is loaded only when its projected load
    (device bytes over the measured rate) beats the build seconds it
    recorded; an entry declined so is removed."""
    _, mega, _ = _indexes(rng)
    cfg = ColBwtConfig(engine="mega")
    rate(1.0)  # a byte a second: a load never pays
    eng = _engine(mega, cfg, tmp_path)
    ev = eng.cache_events
    assert [e["event"] for e in ev] == ["build+skip-save"]
    assert ev[0]["projected_seconds"] == TB.dev_bytes(eng.mt)
    assert ev[0]["projected_save_seconds"] == 0.0
    assert not (tmp_path / "t").exists()
    rate(float("inf"))  # a save and a load always pay
    eng = _engine(mega, cfg, tmp_path)
    assert [e["event"] for e in eng.cache_events] == ["build+save"]
    assert eng.table_save_seconds == eng.cache_events[0]["save_seconds"] > 0
    eng = _engine(mega, cfg, tmp_path)
    assert [e["event"] for e in eng.cache_events] == ["load"]
    rate(1.0)
    eng = _engine(mega, cfg, tmp_path)
    assert [e["event"] for e in eng.cache_events] == ["skip-load"]
    assert eng.cache_events[0]["removed"]
    assert not (tmp_path / "t" / "mega").exists()
    eng = _engine(mega, cfg, tmp_path)
    assert [e["event"] for e in eng.cache_events] == ["build+skip-save"]


@pytest.mark.parametrize("save,load,saved", [
    (0.4, 0.4, True), (0.6, 0.6, False), (1.0, 0.0, False),
    (0.0, 1.0, False)])
def test_auto_save_counts_the_save(tmp_path, rng, monkeypatch, save, load,
                                   saved):
    """The save rule: the projected save plus the projected load (each a
    share of the build just measured here) must beat the build."""
    _, mega, _ = _indexes(rng)

    def project(dir_, tables, build_seconds, device=None):
        return {"save_seconds": save * build_seconds,
                "load_seconds": load * build_seconds, "probe_seconds": 0.0}
    monkeypatch.setattr(TB, "project_save", project)
    eng = _engine(mega, ColBwtConfig(engine="mega"), tmp_path)
    ev = eng.cache_events[0]
    assert ev["event"] == ("build+save" if saved else "build+skip-save")
    assert ev["projected_save_seconds"] == save * ev["seconds"]
    assert (tmp_path / "t" / "mega").is_dir() == saved


def _dict_tables():
    return {"table": torch.arange(3000, dtype=torch.int32).reshape(1000, 3),
            "length": torch.ones(50, dtype=torch.int64),
            "n": 7, "host": np.arange(4)}


def test_project_save_measures_and_cleans(tmp_path):
    """The probe writes its sample to a temporary file beside the entries
    (whose directory need not exist), reads it back, projects both from
    the dict's device bytes and leaves nothing behind."""
    got = TB.project_save(tmp_path / "idx.torch_tables", _dict_tables(),
                          float("inf"), "cpu")
    assert got["save_seconds"] > 0 and got["load_seconds"] > 0
    assert got["probe_seconds"] > 0
    assert "error" not in got
    assert list(tmp_path.iterdir()) == []


def test_project_save_stops_when_the_save_cannot_pay(tmp_path, monkeypatch):
    """When the sample's copy to the host already projects past the build,
    nothing is written and no load is projected; with no device array the
    save and the load are free."""
    def no_file(*a, **k):
        raise AssertionError("the probe wrote a file")
    monkeypatch.setattr(TB.tempfile, "mkstemp", no_file)
    got = TB.project_save(tmp_path, _dict_tables(), 0.0, "cpu")
    assert got["load_seconds"] is None and got["save_seconds"] >= 0
    got = TB.project_save(tmp_path, {"n": 7}, 1.0, "cpu")
    assert got["save_seconds"] == got["load_seconds"] == 0.0


@pytest.mark.parametrize("budget", [0.0, float("inf")])
def test_to_host_in_pieces(budget):
    """The copy to the host goes in pieces that double from 1 MB and stops
    after the piece whose projection reaches the budget; a copy that
    finishes is the sample itself."""
    part = torch.arange(3 << 20, dtype=torch.int32).reshape(-1, 3)
    host, proj = TB._to_host(part, torch.device("cpu"), 10 * part.nbytes,
                             budget)
    assert proj >= 0
    if budget == 0.0:
        assert host is None
    else:
        np.testing.assert_array_equal(host, part.numpy())


@pytest.mark.parametrize("cache", ["auto", "force"])
def test_read_only_directory(tmp_path, rng, monkeypatch, read_only, cache):
    """A query in a directory it cannot write builds its tables and
    answers as it would anywhere: the event says why none was saved."""
    _, mega, _ = _indexes(rng)
    reads = make_reads(rng, random_docs(rng, 2, lo=80, hi=150), 4)
    want = _query(_engine(mega, ColBwtConfig(engine="mega",
                                             table_cache="off"),
                          tmp_path), reads)
    (tmp_path / "t").mkdir()
    # the build wins by far under auto, so that the probe goes on to write
    real = TB.project_save
    monkeypatch.setattr(TB, "project_save",
                        lambda d, t, b, dev=None: real(d, t, float("inf"),
                                                       dev))
    read_only()
    eng = _engine(mega, ColBwtConfig(engine="mega", table_cache=cache),
                  tmp_path)
    ev = eng.cache_events
    assert [e["event"] for e in ev] == ["build+skip-save"]
    assert ev[0]["reason"].startswith("PermissionError")
    _same(_query(eng, reads), want)
    monkeypatch.undo()
    assert list((tmp_path / "t").iterdir()) == []


def test_read_only_entry_declined(tmp_path, rng, rate, read_only):
    """An entry declined in a directory that cannot be written stays, and
    the query builds; an entry that pays loads there."""
    _, mega, _ = _indexes(rng)
    cfg = ColBwtConfig(engine="mega")
    rate(float("inf"))
    _engine(mega, cfg, tmp_path)
    rate(1.0)
    read_only()
    eng = _engine(mega, cfg, tmp_path)
    assert [(e["event"], e["removed"]) for e in eng.cache_events] == [
        ("skip-load", False)]
    assert (tmp_path / "t" / "mega" / "meta.json").exists()
    rate(float("inf"))  # a load reads only
    eng = _engine(mega, cfg, tmp_path)
    assert [e["event"] for e in eng.cache_events] == ["load"]


@pytest.mark.parametrize("cache", ["auto", "force"])
def test_concurrent_engines(tmp_path, rng, monkeypatch, cache):
    """Two engines on one index at once: their probes (auto) and saves
    (force) overlap, each in files of its own, and neither fails; one
    entry is left, which a third engine loads, and no probe or staging
    file."""
    import threading

    _, mega, _ = _indexes(rng)
    meet = threading.Barrier(2, timeout=30)
    names = []
    if cache == "auto":  # both probes' files exist when either reads
        real = TB.read_rate

        def read_rate(path, dev=None):
            names.append(Path(path).name)
            meet.wait()
            real(path, dev)
            return float("inf")
        monkeypatch.setattr(TB, "read_rate", read_rate)
        real_project = TB.project_save
        # the build wins by far, so that each probe goes on to the read
        monkeypatch.setattr(TB, "project_save",
                            lambda d, t, b, dev=None: dict(real_project(
                                d, t, float("inf"), dev), save_seconds=0.0))
    else:  # both staging directories exist before either renames
        real_fp = TB.index_fingerprint

        def fingerprint(index):
            meet.wait()
            return real_fp(index)
        monkeypatch.setattr(TB, "index_fingerprint", fingerprint)
    cfg = ColBwtConfig(engine="mega", table_cache=cache)
    engines, errors = [], []

    def run():
        try:
            engines.append(_engine(mega, cfg, tmp_path))
        except BaseException as e:  # noqa: BLE001 - asserted below
            errors.append(e)
    threads = [threading.Thread(target=run) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors and len(engines) == 2
    for eng in engines:
        assert [e["event"] for e in eng.cache_events] == ["build+save"]
        assert "reason" not in eng.cache_events[0]
    if cache == "auto":
        assert len(set(names)) == 2
    monkeypatch.undo()
    assert sorted(p.name for p in tmp_path.iterdir()) == ["t"]
    assert sorted(p.name for p in (tmp_path / "t").iterdir()) == ["mega"]
    eng = _engine(mega, ColBwtConfig(engine="mega", table_cache="force"),
                  tmp_path)
    assert [e["event"] for e in eng.cache_events] == ["load"]


@pytest.mark.parametrize("shape", [(1 << 16, 4), (3,), (1, 16)])
def test_read_rate_samples_the_file_head(tmp_path, monkeypatch, shape):
    """The timed upload is the first RATE_SAMPLE_BYTES of the file's rows
    (one row at least), read through its mmap, after a warm-up of the same
    shape from host memory."""
    calls = []

    def upload(a, dev):
        calls.append((type(a), a.shape))

    monkeypatch.setattr(TB, "upload_chunked", upload)
    monkeypatch.setattr(TB, "RATE_SAMPLE_BYTES", 4096)
    np.save(tmp_path / "a.npy", np.zeros(shape, np.int32))
    assert TB.read_rate(tmp_path / "a.npy", "cpu") > 0
    row = 4 * int(np.prod(shape[1:], dtype=np.int64))
    rows = min(shape[0], max(1, 4096 // row))
    assert [c[1] for c in calls] == [(rows,) + shape[1:]] * 2
    assert calls[0][0] is np.ndarray and calls[1][0] is np.memmap


def test_truncated_entry_rebuilds(tmp_path, rng):
    """A truncated meta.json or a missing array file is no entry."""
    _, index = build_index(random_docs(rng, 2, lo=100, hi=160))
    cfg = ColBwtConfig(engine="pos", table_cache="force")
    _engine(index, cfg, tmp_path)
    mf = tmp_path / "t" / "pos" / "meta.json"
    text = mf.read_text()
    mf.write_text(text[:len(text) // 2])
    assert [e["event"] for e in _engine(index, cfg, tmp_path).cache_events
            ] == ["build+save"]
    (tmp_path / "t" / "pos" / "table.npy").unlink()
    assert TB.peek(tmp_path / "t", "pos", index,
                   json.loads(mf.read_text())["layout"]) is None
    assert [e["event"] for e in _engine(index, cfg, tmp_path).cache_events
            ] == ["build+save"]


def _build_cli(tmp_path, rng, *extra):
    docs = random_docs(rng, 2, lo=150, hi=220)
    fastas = []
    for i, d in enumerate(docs):
        fastas.append(tmp_path / f"d{i}.fa")
        fastas[-1].write_bytes(b">d%d\n" % i + d + b"\n")
    out = tmp_path / "idx"
    assert torch_cli(["build", "-o", str(out), "-l", "10", "--device", "cpu",
                      *extra, *map(str, fastas)]) == 0
    return out, docs


def test_cli_build_prewarms(tmp_path, rng, rate, caplog):
    """`build` prewarms: the engine's tables saved under
    PREFIX.torch_tables (where the measured load pays), prewarm_s and
    build_s logged; never anything under JAX's PREFIX.tables."""
    import logging

    rate(float("inf"))
    with caplog.at_level(logging.INFO, logger="colbwt_torch.build"):
        out, _ = _build_cli(tmp_path, rng)
    assert (Path(f"{out}.torch_tables") / "pos" / "meta.json").exists()
    assert not Path(f"{out}.tables").exists()
    keys = {k for rec in caplog.records for k in ("prewarm_s", "build_s",
                                                  "table_cache")
            if hasattr(rec, k)}
    assert keys == {"prewarm_s", "build_s", "table_cache"}


def test_cli_build_no_prewarm(tmp_path, rng, rate):
    rate(float("inf"))
    out, _ = _build_cli(tmp_path, rng, "--no-prewarm")
    assert not Path(f"{out}.torch_tables").exists()
    assert not Path(f"{out}.tables").exists()


@pytest.mark.parametrize("stream", [False, True], ids=["one-shot", "stream"])
def test_queries_use_own_directory(tmp_path, rng, rate, stream, caplog):
    """The one-shot and streaming queries save into and load from
    PREFIX.torch_tables, log each cache event, and write the same records
    either way; nothing appears under PREFIX.tables."""
    import logging

    rate(float("inf"))
    out, docs = _build_cli(tmp_path, rng, "--no-prewarm")
    pat = tmp_path / "reads.fa"
    pat.write_bytes(b"".join(b">r%d\n" % i + r + b"\n" for i, r in
                             enumerate(make_reads(rng, docs, 20))))
    cfg = ColBwtConfig(engine="pos")
    files = []
    for expect in ("build+save", "load"):
        caplog.clear()
        with caplog.at_level(logging.INFO):
            if stream:
                query_stream(str(out), str(pat), cfg, device="cpu")
            else:
                query_pipeline(str(out), str(pat), cfg, device="cpu")
        events = [rec.table_cache["event"] for rec in caplog.records
                  if hasattr(rec, "table_cache")]
        assert events == [expect]
        files.append([Path(f"{pat}.split.{x}.bin").read_bytes()
                      for x in ("pml", "cid")])
    assert files[0] == files[1]
    assert (Path(f"{out}.torch_tables") / "pos").is_dir()
    assert not Path(f"{out}.tables").exists()


def test_pipeline_cache_off_writes_nothing(tmp_path, rng):
    out, docs = _build_cli(tmp_path, rng, "--no-prewarm")
    pat = tmp_path / "reads.fa"
    pat.write_bytes(b">r\n" + docs[0][:40] + b"\n")
    query_pipeline(str(out), str(pat), ColBwtConfig(engine="pos",
                                                    table_cache="off"),
                   device="cpu")
    assert not Path(f"{out}.torch_tables").exists()
    assert not Path(f"{out}.tables").exists()
