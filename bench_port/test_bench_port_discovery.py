"""BENCHMARK.json and the files it names are found by name, and a
configuration, mix and metric added as files alone are found the same
way."""

import json
import re
from pathlib import Path

from bench_port import harness as H

ROOT = Path(__file__).resolve().parent.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_every_name_has_its_file():
    spec = H.Spec(ROOT / "BENCHMARK.json")
    for w in spec.data["workloads"]:
        cfg = spec.config(w["config"])
        assert cfg["name"] == w["config"]
        assert spec.traffic(w["traffic"])["components"]
        for trace in (False, True):
            for m in spec.metrics(w["name"], trace):
                assert callable(spec.reader(m["name"]))


def test_contract_shapes():
    data = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(data) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in data[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    e2e = {m["name"] for m in data["end_to_end"]}
    assert "setup_s" in e2e
    for m in data["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in data["workloads"]}
    reports = {c: {m["name"] for m in data["end_to_end"]
                   if c in m.get("workloads", [c])} for c in cells}
    for m in data["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= cells
        # every cell a per-layer metric is read in reports what it moves
        assert all(m["moves"] in reports[c] for c in m["workloads"])
    for c in data["configs"]:
        assert (ROOT / c["file"]).exists()
        assert all(NAME.match(k) for k in c["reduced"])
        assert set(c["reduced"]) == set(json.loads(
            (ROOT / c["file"]).read_text())["reduced"])
    assert len(data["workloads"]) // 4 >= sum(
        w["chips"] == 4 for w in data["workloads"]) or all(
        w["chips"] == 1 for w in data["workloads"])


def test_added_config_mix_and_metric_are_found(tmp_path):
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench = tmp_path / "bench"
    for sub in ("configs", "traffic", "metrics"):
        (bench / sub).mkdir(parents=True)
    cfg = json.loads((ROOT / "bench_port/configs/chr21_hap8.json")
                     .read_text())
    cfg["name"] = "tiny_hap"
    (bench / "configs" / "tiny_hap.json").write_text(json.dumps(cfg))
    (bench / "traffic" / "short250.json").write_text(json.dumps(
        {"components": [{"name": "l", "count": 4, "length": {"fixed": 250},
                         "substitutions": {"uniform_max": 2}}],
         "warmup_reads": 2}))
    (bench / "metrics" / "jobs_done.py").write_text(
        "def read(run):\n    return len(run.jobs)\n")
    spec["configs"].append({**spec["configs"][0], "name": "tiny_hap",
                            "file": "bench/configs/tiny_hap.json"})
    spec["workloads"].append({"name": "tiny_hap.short250", "config": "tiny_hap",
                              "traffic": "short250", "chips": 1,
                              "why": "a test"})
    spec["per_layer"].append({"name": "jobs_done", "unit": "jobs",
                              "better": "higher", "source": "host_clock",
                              "layer": "query driver",
                              "moves": "query_Mbp_per_s",
                              "workloads": ["tiny_hap.short250"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    found = H.Spec(tmp_path / "BENCHMARK.json", bench)
    assert found.config("tiny_hap")["name"] == "tiny_hap"
    assert found.traffic("short250")["components"][0]["name"] == "l"
    assert [m["name"] for m in found.metrics("tiny_hap.short250", True)] == [
        "jobs_done"]
    run = H.Run(found.cell("tiny_hap.short250"), cfg, {}, None, {}, 0.0, 0.0,
                jobs=[object(), object()])
    assert found.reader("jobs_done")(run) == 2
