"""A run's result line has the keys a runner reads, untraced and traced,
with `checks` last; and run.py prints no result where it must not."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from bench_port import harness as H

ROOT = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("cell,trace", [("sarscov2_10k.short", False),
                                        ("sarscov2_10k.short", True),
                                        ("chr21_hap8.short", False)])
def test_result_line_keys(tiny, cell, trace):
    res, checks = H.run_cell(tiny, cell, 2**31 + 3, 0.2, trace, "cpu",
                             log=lambda m: None)
    assert {"correct", "attempted", "failed", "metrics",
            "device"} <= set(res)
    assert list(res)[-1] == "checks"
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] == res["jobs"] * 1548
    dev = res["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    want = {m["name"] for m in tiny.metrics(cell, trace)}
    got = set(res["metrics"])
    assert all(set(v) == {"value", "unit"} for v in res["metrics"].values())
    if trace:
        # the CPU has no device trace: the trace's readers return nothing
        assert got == want - {"scan_roofline"}
        assert {"busy_s", "window_s"} <= set(dev)
        assert len(res["breakdown"]["device_ops"]) <= 10
        assert 1 <= len(res["breakdown"]["idle_gaps"]) <= 10
    else:
        assert got == want >= {"query_Mbp_per_s", "setup_s"}
        assert ("index_build_s" in got) == (cell == "chr21_hap8.short")
        assert res["metrics"]["setup_s"]["value"] > \
            res["metrics"].get("index_build_s", {"value": 0})["value"] >= 0
    assert all(v == (0, 0) for v in checks.values())
    json.dumps(res)


def _run_py(cwd: Path, **env) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "bench_port/run.py", "--workload",
         "chr21_hap8.short", "--seed", "1", "--seconds", "1", "--trace",
         "0"], cwd=cwd, capture_output=True, text=True,
        env={**os.environ, **env}, timeout=300)


def test_no_result_without_cuda():
    out = _run_py(ROOT, CUDA_VISIBLE_DEVICES="")
    assert out.returncode != 0 and out.stdout == ""


def test_no_result_without_the_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "bench_port", tmp_path / "bench_port")
    out = _run_py(tmp_path)
    assert out.returncode != 0 and out.stdout == ""
