"""Fixtures of the benchmark's CPU tests: the repository's BENCHMARK.json
with its configurations and mix cut to a size a test run holds, written
into a temporary directory beside copies of the metric readers."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# each configuration's tiny size: the same generator and decisions
TINY = {"chr21_hap8": {"doc_len": 4000, "substitutions_per_doc": 20,
                       "build": {"min_mum": 20}},
        "sarscov2_10k": {"docs": 300, "doc_len": 300, "hotspots": 8}}


def tiny_spec(dest: Path) -> Path:
    """A BENCHMARK.json in `dest` naming tiny copies of the repository's
    configurations and mixes; returns its path (the bench dir is
    dest/bench)."""
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench = dest / "bench"
    for sub in ("configs", "traffic"):
        (bench / sub).mkdir(parents=True, exist_ok=True)
    shutil.copytree(ROOT / "bench_port" / "metrics", bench / "metrics")
    for c in spec["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        for k, v in TINY[c["name"]].items():
            if isinstance(v, dict):
                cfg[k].update(v)
            else:
                cfg[k] = v
        c["file"] = f"bench/configs/{c['name']}.json"
        (dest / c["file"]).write_text(json.dumps(cfg))
    for w in spec["workloads"]:
        tr = json.loads((ROOT / "bench_port" / "traffic"
                         / f"{w['traffic']}.json").read_text())
        tr["components"][0]["count"] = 1500
        for comp in tr["components"][1:]:
            comp["count"] = 48
        tr["warmup_reads"] = 300
        (bench / "traffic" / f"{w['traffic']}.json").write_text(
            json.dumps(tr))
    out = dest / "BENCHMARK.json"
    out.write_text(json.dumps(spec))
    return out


@pytest.fixture
def tiny(tmp_path):
    """(Spec of the tiny benchmark)."""
    from bench_port import harness as H

    path = tiny_spec(tmp_path)
    return H.Spec(path, tmp_path / "bench")
