"""The span recorder (colbwt_tpu_torch/utils/profiling.py `StepTimer`) and
the spans and counters the streaming query writes with it
(pipeline/stream.py, pipeline/engines.py): a proper tree of the names the
stream documents, counters equal to hand counts, leaf spans that cover the
job, the same spans in a profiler's trace, and records that do not change
under a profiler.  All on the CPU, through the plain PyTorch path."""

import gc
import json
import logging
import math
import time

import numpy as np
import pytest

from colbwt_tpu.utils import profiling as JP
from colbwt_tpu_torch.io.fasta import FastaRecord, write_fasta
from colbwt_tpu_torch.pipeline import build_pipeline, query_stream
from colbwt_tpu_torch.utils import profiling as TP
from colbwt_tpu_torch.utils.config import ColBwtConfig
from colbwt_tpu_torch.utils.log import get_logger
from tests.conftest import random_docs

STREAM_SPANS = {"stream.job": None, "stream.load_index": "stream.job",
                "stream.tables": "stream.job", "stream.read": "stream.job",
                "stream.dispatch": "stream.job",
                "engine.encode": "stream.dispatch",
                "engine.launch": "stream.dispatch",
                "stream.drain": "stream.job", "engine.wait": "stream.drain",
                "engine.unpack": "stream.drain",
                "stream.slice": "stream.drain", "stream.write": "stream.drain",
                "stream.long": "stream.job", "stream.close": "stream.job"}
LEAVES = {"stream.load_index", "stream.tables", "stream.read",
          "engine.encode", "engine.launch", "engine.wait", "engine.unpack",
          "stream.slice", "stream.write", "stream.long", "stream.close"}
READ_LEN = 60
N_READS = 1100   # not a multiple of the batch: every batch follows a read span
BATCH = 256
N_EVERY = 37     # every 37th read carries an N: the pos engine's fallback


# -- the recorder on its own --------------------------------------------------

def test_recorder_nesting_and_self_time():
    t = TP.StepTimer()
    with t.stage("job"):
        time.sleep(0.002)
        t.begin("a")
        with t.stage("b"):
            time.sleep(0.003)
        t.end()
        with t.stage("b"):
            pass
    names = [s[0] for s in t.spans]
    parents = [s[3] for s in t.spans]
    assert names == ["job", "a", "b", "b"]
    assert parents == [None, 0, 1, 0]
    for name, s, e, parent in t.spans:
        assert e >= s
        if parent is not None:
            ps, pe = t.spans[parent][1:3]
            assert ps <= s <= e <= pe
    dur = [(e - s) * 1e-9 for _, s, e, _ in t.spans]
    got = t.summary()
    assert got["b"]["count"] == 2 and got["job"]["count"] == 1
    assert got["b"]["total_s"] == pytest.approx(dur[2] + dur[3])
    assert got["a"]["self_s"] == pytest.approx(dur[1] - dur[2])
    assert got["job"]["self_s"] == pytest.approx(dur[0] - dur[1] - dur[3])
    assert got["job"]["self_s"] >= 0.002
    # stages keep their totals, as the JAX package's StepTimer does
    assert t.stages["b"] == pytest.approx(dur[2] + dur[3])
    assert set(t.stages) == {"job", "a", "b"}


def test_recorder_counters_and_open_spans():
    t = TP.StepTimer()
    t.count("reads")
    t.count("reads", 41)
    t.count("bytes_up", 7)
    assert t.counters == {"reads": 42, "bytes_up": 7}
    with pytest.raises(ValueError):
        with t.stage("outer"):
            t.begin("left_open")
            t.begin("deeper")
            raise ValueError
    # the stage closed what was left open inside it
    assert [s[2] is not None for s in t.spans] == [True, True, True]
    assert set(t.summary()) == {"outer", "left_open", "deeper"}
    t.begin("unclosed")
    assert "unclosed" not in t.summary() and "unclosed" not in t.stages


@pytest.mark.parametrize("stages", [
    {"scan": 1.25}, {"read": 0.5, "scan": 2.0, "write": 0.0005}])
def test_recorder_report_unchanged(stages):
    t = TP.StepTimer()
    for name in stages:
        with t.stage(name):
            pass
    t.stages = dict(stages)
    want = JP.StepTimer()
    want.stages = dict(stages)
    assert t.report() == want.report()


def test_spans_enter_record_function_only_under_a_profiler(monkeypatch,
                                                           tmp_path):
    import torch

    entered = []
    real = torch.profiler.record_function

    def spy(name):
        entered.append(name)
        return real(name)

    monkeypatch.setattr(torch.profiler, "record_function", spy)
    t = TP.StepTimer()
    with t.stage("outside"):
        pass
    with TP.trace(str(tmp_path), device="cpu"):
        with t.stage("inside"):
            pass
    assert entered == ["inside"]
    assert set(t.stages) == {"outside", "inside"}


def test_build_stage_is_a_span(tmp_path):
    from colbwt_tpu_torch.pipeline.build import _timed

    records = []
    logger = logging.getLogger("test_torch_stream_spans.build")
    logger.setLevel(logging.INFO)
    h = _Keep(records)
    logger.addHandler(h)
    try:
        with TP.trace(str(tmp_path), device="cpu"):
            with _timed(logger, "sa_lcp_s", "[mums] suffix array + LCP"):
                time.sleep(0.001)
    finally:
        logger.removeHandler(h)
    (msg, extras), = records
    assert msg.startswith("[mums] suffix array + LCP in ")
    assert list(extras) == ["sa_lcp_s"] and extras["sa_lcp_s"] >= 0.001
    spans = _trace_spans(tmp_path / TP.TRACE_FILE, {"sa_lcp_s"})
    assert len(spans["sa_lcp_s"]) == 1


# -- the streaming query ------------------------------------------------------

class _Keep(logging.Handler):
    """Keeps (message, extras) of each record."""

    STD = set(vars(logging.makeLogRecord({}))) | {"message", "asctime"}

    def __init__(self, out):
        super().__init__(logging.INFO)
        self.out = out

    def emit(self, record):
        self.out.append((record.getMessage(),
                         {k: v for k, v in vars(record).items()
                          if k not in self.STD}))


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """A port-built index over two related documents and N_READS reads of
    READ_LEN bases, every N_EVERY-th with an N."""
    rng = np.random.default_rng(0x59A5)
    tmp = tmp_path_factory.mktemp("torch_stream_spans")
    base = bytes(rng.choice(list(b"ACGT"), 800).astype("uint8"))
    docs = random_docs(rng, 2, mutate_from=base)
    for i, d in enumerate(docs):
        write_fasta(tmp / f"s{i}.fa", [FastaRecord(f"s{i}", d)])
    build_pipeline([str(tmp / "s0.fa"), str(tmp / "s1.fa")], str(tmp / "idx"),
                   ColBwtConfig(min_mum=15, prewarm=False), device="cpu")
    reads = []
    for i in range(N_READS):
        d = docs[i % 2]
        s = int(rng.integers(0, len(d) - READ_LEN))
        seq = bytearray(d[s:s + READ_LEN])
        if i % N_EVERY == 3:
            seq[int(rng.integers(0, READ_LEN))] = ord("N")
        reads.append(FastaRecord(f"r{i}", bytes(seq)))
    write_fasta(tmp / "reads.fa", reads)
    long_reads = list(reads[:40])
    long_reads.insert(10, FastaRecord("L0", docs[0][:300]))
    write_fasta(tmp / "long.fa", long_reads)
    return tmp


def _cfg(engine: str, **kw) -> ColBwtConfig:
    return ColBwtConfig(engine=engine, batch_size=BATCH, table_cache="off",
                        **kw)


def _run(built, engine: str, name: str = "reads", **kw):
    pat = built / f"{engine}.{name}.{len(list(built.iterdir()))}.fa"
    pat.write_bytes((built / f"{name}.fa").read_bytes())
    records = []
    logger = get_logger("colbwt_torch.stream")
    h = _Keep(records)
    logger.addHandler(h)
    try:
        stats = query_stream(str(built / "idx"), str(pat), _cfg(engine, **kw),
                             device="cpu")
    finally:
        logger.removeHandler(h)
    files = [(built / f"{pat.name}.split.{x}.bin").read_bytes()
             for x in ("pml", "cid")]
    return stats, records, files


@pytest.mark.parametrize("engine", ["pos", "xla"])
def test_stream_spans_form_a_tree(built, engine):
    stats, records, _ = _run(built, engine)
    spans = stats["spans"]
    assert spans[0][0] == "stream.job" and spans[0][3] is None
    for name, s, e, parent in spans:
        assert name in STREAM_SPANS
        assert e is not None and s <= e
        if parent is None:
            assert name == "stream.job"
            continue
        pname, ps, pe, _ = spans[parent]
        assert pname == STREAM_SPANS[name]
        assert ps <= s <= e <= pe
    names = [s[0] for s in spans]
    batches = stats["counters"]["batches"]
    assert batches == math.ceil(N_READS / BATCH)
    assert names.count("stream.read") == names.count("stream.dispatch") \
        == names.count("stream.drain") == batches
    assert len(spans) <= 16 * batches + 6
    assert stats["span_totals"]["stream.job"]["total_s"] == stats["seconds"]
    # the final record: reads first, then the job's spans and counters
    msg, extras = records[-1]
    assert msg.startswith(f"streamed {N_READS} reads")
    assert list(extras)[0] == "reads" and extras["query_s"] == stats["seconds"]
    for key in ("spans", "span_totals", "counters"):
        assert extras[key] == stats[key]
    json.dumps(extras)
    # no other record carries the spans
    assert sum("spans" in ex for _, ex in records) == 1


@pytest.mark.parametrize("engine", ["pos", "xla"])
def test_stream_counters_equal_hand_counts(built, engine):
    stats, _, _ = _run(built, engine)
    c = stats["counters"]
    n_reads = [i for i in range(N_READS) if i % N_EVERY == 3]
    assert c["reads"] == N_READS == stats["reads"]
    assert c["bases"] == N_READS * READ_LEN == stats["chars"]
    assert c["batches"] == math.ceil(N_READS / BATCH)
    assert "long_reads" not in c
    if engine == "pos":
        k = int(stats["engine"][len("pos(k="):-1])
        grp = math.lcm(k, 4)  # ACGT keys: 4 digits a byte
        width = -(-64 // grp) * grp
        fallback = len(n_reads)
    else:
        width, fallback = 64, 0
    assert c.get("fallback_reads", 0) == fallback
    assert c["scanned_bases"] == (N_READS + fallback) * READ_LEN
    assert c["padded_cells"] == (N_READS + fallback) * width
    assert c["bytes_up"] > 0 and c["bytes_down"] > 0
    assert c["launches"] == 0  # the plain path launches no kernel
    assert 0 < c["first_record_s"] < stats["seconds"]


def test_stream_long_reads_are_spanned(built):
    stats, _, _ = _run(built, "pos", "long", long_read_len=128,
                       long_read_chunk=64)
    assert stats["counters"]["long_reads"] == 1
    assert stats["span_totals"]["stream.long"]["count"] == 1
    names = [s[0] for s in stats["spans"]]
    i = names.index("stream.long")
    assert "stream.write" in names[i:]


@pytest.mark.parametrize("engine", ["pos", "xla"])
def test_leaf_spans_cover_the_job(built, engine):
    """At least 90% of the job lies in leaf spans.  A pause of the process
    that lands between spans (a busy host) is a share of this small job
    that a real one would not see: the job runs again then, up to three
    times."""
    shares = []
    for _ in range(3):
        stats, _, _ = _run(built, engine)
        spans = stats["spans"]
        leaves = sorted((s, e) for name, s, e, _ in spans if name in LEAVES)
        covered, end = 0, None
        for s, e in leaves:
            if end is None or s > end:
                covered += e - s
                end = e
            elif e > end:
                covered += e - end
                end = e
        shares.append(covered / (spans[0][2] - spans[0][1]))
        if shares[-1] >= 0.9:
            break
    assert shares[-1] >= 0.9, shares


def _trace_spans(path, names):
    data = json.loads(path.read_text())
    events = data["traceEvents"] if isinstance(data, dict) else data
    out = {}
    for e in events:
        if (e.get("ph") == "X" and e.get("cat") == "user_annotation"
                and e.get("name") in names):
            out.setdefault(e["name"], []).append((float(e["ts"]),
                                                  float(e["dur"])))
    return {k: sorted(v) for k, v in out.items()}


def test_trace_holds_the_spans_and_records_do_not_change(built, tmp_path):
    """Every span is a range of the trace, its duration the same within
    1 ms.  A host that deschedules the process between a range's stamp and
    the recorder's clock can open a wider gap once; the job is traced again
    then, up to three times, with the collector held off meanwhile."""
    _, _, plain = _run(built, "pos")
    late: dict = {}
    for attempt in range(3):
        out = tmp_path / str(attempt)
        gc.disable()
        try:
            with TP.trace(str(out), device="cpu"):
                stats, _, traced = _run(built, "pos")
        finally:
            gc.enable()
        assert traced == plain
        got = _trace_spans(out / TP.TRACE_FILE, set(STREAM_SPANS))
        mine: dict = {}
        for name, s, e, _ in stats["spans"]:
            mine.setdefault(name, []).append((s, e))
        assert set(got) == set(mine)
        late = {}
        for name, spans in mine.items():
            assert len(got[name]) == len(spans), name
            for (ts, dur), (s, e) in zip(got[name], sorted(spans)):
                gap = abs(dur - (e - s) / 1e3)
                if gap >= 1000.0:
                    late[name] = gap
        if not late:
            break
    assert not late, late
