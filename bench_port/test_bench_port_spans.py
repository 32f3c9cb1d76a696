"""The query driver's per-layer metrics (spans.py and the readers that use
it) on a synthetic trace and jobs with known clock offsets, busy intervals
and spans: each reader gives the exact value, and nothing where the
program logged no spans."""

import json
from pathlib import Path

import pytest

from bench_port import harness as H
from bench_port import spans as S
from bench_port import trace as T

ROOT = Path(__file__).resolve().parent.parent
CELLS = ["chr21_hap8.short", "sarscov2_10k.short"]
NEW = {"stream_index_load_s": "s", "stream_parse_s": "s",
       "stream_encode_s": "s", "stream_launch_s": "s", "stream_wait_s": "s",
       "stream_unpack_s": "s", "stream_write_s": "s", "stream_pad_pct": "%",
       "idle_untraced_pct": "%"}


def _spans(start_s: float, rel: list) -> list:
    """[name, start_ns, end_ns, parent] from (name, start, end, parent) in
    microseconds after `start_s` (perf_counter seconds)."""
    base = round(start_s * 1e9)
    return [[n, base + round(s * 1e3),
             None if e is None else base + round(e * 1e3), p]
            for n, s, e, p in rel]


def _totals(spans: list) -> dict:
    out: dict = {}
    for n, s, e, _ in spans:
        if e is not None:
            row = out.setdefault(n, {"count": 0, "total_s": 0.0,
                                     "self_s": 0.0})
            row["count"] += 1
            row["total_s"] += (e - s) * 1e-9
    return out


def _job(start: float, rel: list, counters: dict, error=None) -> H.Job:
    spans = _spans(start, rel)
    return H.Job(start, start + 0.01, 10, 1500,
                 {"reads": 10, "spans": spans, "span_totals": _totals(spans),
                  "counters": counters}, error)


# job 0: the trace's range at 1,000-11,000 us, Job.start 5 s; busy inside
# it 2,000-3,000 and 10,500-11,000 (the second clipped): idle 8,500 us
JOB0 = [("stream.job", 0, 10000, None),
        ("stream.load_index", 0, 500, 0),
        ("stream.read", 500, 1500, 0),       # 500 of it idle, 500 busy
        ("stream.dispatch", 2800, 4500, 0),  # not a leaf: its child counts
        ("engine.encode", 3000, 4000, 3),
        ("stream.drain", 5000, 9000, 0),
        ("engine.wait", 5000, 5200, 5),
        ("engine.unpack", 5200, 6000, 5),
        ("stream.slice", 6000, 6500, 5),
        ("stream.write", 6500, 8500, 5)]
# leaves cover 500 + 500 + 1,000 + 200 + 800 + 500 + 2,000 = 5,500 idle us
# job 1: range 20,000-30,000 us, Job.start 7 s, no busy time: idle 10,000;
# leaves cover 2,000-6,000 (overlapping each other), an open span ignored
JOB1 = [("stream.job", 0, 10000, None),
        ("stream.read", 2000, 5000, 0),
        ("stream.dispatch", 4000, 6000, 0),
        ("engine.launch", 4000, 6000, 2),
        ("engine.unpack", 4500, 4600, 0),
        ("stream.long", 9000, None, 0)]


def _run() -> H.Run:
    jobs = [_job(5.0, JOB0, {"scanned_bases": 150, "padded_cells": 252}),
            _job(7.0, JOB1, {"scanned_bases": 0, "padded_cells": 0}),
            _job(9.0, JOB0, {"scanned_bases": 1, "padded_cells": 1},
                 error="RuntimeError: a failed job counts for nothing")]
    tr = T.Trace(window=(0.0, 100000.0), device=[],
                 spans={"bench:window": (0.0, 100000.0),
                        "bench:job0": (1000.0, 11000.0),
                        "bench:job1": (20000.0, 30000.0),
                        "bench:job2": (40000.0, 50000.0)},
                 markers=[], busy=[(2000.0, 3000.0), (10500.0, 12000.0),
                                   (40000.0, 50000.0)])
    return H.Run({}, {}, {}, None, {}, 0.0, 0.0, jobs=jobs, trace=tr)


def _reader(name):
    return H.Spec(ROOT / "BENCHMARK.json").reader(name)


def test_entries_are_new_per_layer_metrics():
    data = json.loads((ROOT / "BENCHMARK.json").read_text())
    got = {m["name"]: m for m in data["per_layer"] if m["name"] in NEW}
    assert list(got) == list(NEW)
    assert [m["name"] for m in data["per_layer"][-len(NEW):]] == list(NEW)
    for name, m in got.items():
        assert m == {"name": name, "unit": NEW[name], "better": "lower",
                     "source": "program_span", "layer": "query driver",
                     "moves": "query_Mbp_per_s", "workloads": CELLS}


@pytest.mark.parametrize("name,want", [
    ("stream_index_load_s", (500e-6 + 0.0) / 2),
    ("stream_parse_s", (1000e-6 + 3000e-6) / 2),
    ("stream_encode_s", (1000e-6 + 0.0) / 2),
    ("stream_launch_s", (0.0 + 2000e-6) / 2),
    ("stream_wait_s", (200e-6 + 0.0) / 2),
    ("stream_unpack_s", (800e-6 + 500e-6 + 100e-6) / 2),
    ("stream_write_s", (2000e-6 + 0.0) / 2),
    ("stream_pad_pct", (100.0 * (1 - 150 / 252) + 0.0) / 2),
    ("idle_untraced_pct", 100.0 * ((8500 - 5500) + (10000 - 4000))
     / (8500 + 10000))])
def test_readers_exact(name, want):
    assert _reader(name)(_run()) == pytest.approx(want, rel=1e-9, abs=1e-12)


def test_offset_is_per_job():
    """The same spans read the same share wherever a job's range lies."""
    run = _run()
    tr = run.trace
    tr.spans["bench:job0"] = (61000.0, 71000.0)
    tr.busy = [(62000.0, 63000.0), (70500.0, 72000.0)]
    run.jobs = run.jobs[:1]
    assert S.idle_untraced_pct(run) == pytest.approx(100.0 * 3000 / 8500)


def test_nothing_without_spans():
    """A program without the recorder, and an untraced run."""
    run = _run()
    for j in run.jobs:
        j.extras = {"reads": 10, "query_s": 0.01}
    for name in NEW:
        assert _reader(name)(run) is None
    run = _run()
    run.trace = None
    assert S.idle_untraced_pct(run) is None
    assert S.mean_span_s(run, "stream.write") == pytest.approx(1000e-6)


def test_fully_covered_and_busy_jobs():
    run = _run()
    run.jobs = run.jobs[:1]
    run.trace.busy = [(0.0, 100000.0)]
    assert S.idle_untraced_pct(run) == 0.0
    run.trace.busy = []
    run.jobs[0].extras["spans"] = _spans(5.0, [("stream.job", 0, 10000, None),
                                              ("stream.read", -5, 10005, 0)])
    assert S.idle_untraced_pct(run) == 0.0


def test_interval_helpers():
    assert S.merged([(5, 6), (1, 3), (2, 4), (7, 7)]) == [(1, 4), (5, 6)]
    assert S.overlap([(0, 10), (20, 30)], [(5, 25)]) == 10
    assert S.overlap([], [(0, 1)]) == 0
    assert S.is_leaf("engine.wait") and not S.is_leaf("stream.drain")
