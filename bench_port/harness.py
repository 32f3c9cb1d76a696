"""One run of one cell of BENCHMARK.json: set-up, the measured window, the
judgement and the metrics.  `run.py` is its command line; the tests call
`run_cell` on the CPU.

Set-up: the kernel and native libraries loaded (built on a checkout's first
run), the seed's collection written as FASTA files and a file list, the
program's `build_pipeline` as `col-bwt-torch build -i LIST` runs it with
the configuration's flags and forced decisions (its wall is
`index_build_s`), the seed's reads written, and one smaller warm-up job of
the same mix.  The window: jobs of `query_stream`, the `query --stream`
path, on the read file, back to back until `seconds` have passed; a job
that started before the deadline runs to its end and counts.  After it the
reference (reference.py) derives every read's records from the collection
and each job's files are held to them (judge.py).

Everything a run writes lives in one directory under TMPDIR, removed at the
end; the window stops early before the run's written bytes would pass
WRITE_CAP.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import logging
import shutil
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path

from bench_port import generate as G
from bench_port import judge as J
from bench_port import trace as T

HERE = Path(__file__).resolve().parent
WRITE_CAP = 3 << 30
FORBIDDEN = ("jax", "jaxlib", "flax", "colbwt_tpu")
LOGGERS = ("colbwt_torch.build", "colbwt_torch.stream")
_STD_KEYS = set(vars(logging.makeLogRecord({}))) | {"message", "asctime"}


class Spec:
    """BENCHMARK.json and the files it names: a configuration by its
    `file`, a traffic mix as `<bench>/traffic/<name>.json`, a metric's
    reader as `<bench>/metrics/<name>.py`."""

    def __init__(self, path: Path, bench: Path = HERE):
        self.path = Path(path)
        self.root = self.path.parent
        self.bench = Path(bench)
        self.data = json.loads(self.path.read_text())

    def cell(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in {self.path}")

    def config(self, name: str) -> dict:
        for c in self.data["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no config {name!r} in {self.path}")

    def traffic(self, name: str) -> dict:
        return json.loads((self.bench / "traffic" / f"{name}.json")
                          .read_text())

    def metrics(self, cell: str, trace: bool) -> list[dict]:
        """The metrics a run of `cell` reports: end-to-end ones untraced,
        per-layer ones traced."""
        group = self.data["per_layer" if trace else "end_to_end"]
        return [m for m in group if cell in m.get("workloads", [cell])]

    def reader(self, name: str):
        path = self.bench / "metrics" / f"{name}.py"
        spec = importlib.util.spec_from_file_location(
            "bench_port_metric_" + name.replace(".", "_").replace("-", "_"),
            path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read


class Capture(logging.Handler):
    """Keeps the extras (`extra=` fields) of the program's log records with
    their times; while `marking`, also drops a marker into the profiler's
    trace."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.records: list[tuple] = []
        self.marking = False

    def emit(self, record: logging.LogRecord) -> None:
        extras = {k: v for k, v in vars(record).items()
                  if k not in _STD_KEYS}
        self.records.append((time.perf_counter(), record.getMessage(),
                             extras))
        if self.marking and extras:
            T.mark(next(iter(extras)))

    def take(self, since: float | None = None, log=None) -> dict:
        """The extras since the last take, merged (later wins); with
        `log`, each record's time after `since` and its message's start
        are logged first."""
        out: dict = {}
        for t, msg, extras in self.records:
            if log is not None:
                log(f"  +{t - since:8.3f}s {msg[:70]}")
            out.update(extras)
        self.records = []
        return out


@dataclass
class Job:
    start: float
    end: float
    reads: int
    bases: int
    extras: dict
    error: str | None = None


@dataclass
class Run:
    """What the metric readers read."""

    cell: dict
    config: dict
    traffic: dict
    reads: G.Reads
    build: dict
    build_s: float
    setup_s: float
    jobs: list = field(default_factory=list)
    trace: object = None
    warm_error: str | None = None


def written_bytes() -> int:
    """Bytes this process has written (its `wchar`)."""
    try:
        for line in Path("/proc/self/io").read_text().splitlines():
            if line.startswith("wchar:"):
                return int(line.split()[1])
    except OSError:
        pass
    return 0


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def _configs(cfg: dict, n: int):
    """The program's build and query configurations for `cfg`."""
    from colbwt_tpu_torch.utils.config import ColBwtConfig, SplitMode

    b, f = cfg["build"], cfg["forced"]
    budget = f["pos_hbm_budget_per_n"] * n
    build = ColBwtConfig(mode=SplitMode(b["mode"]),
                         split_rate=b["split_rate"], min_mum=b["min_mum"],
                         id_bits=b["id_bits"], prewarm=True,
                         run_split=f["run_split"], pos_hbm_budget=budget)
    query = ColBwtConfig(batch_size=cfg["query"]["batch_size"],
                         pos_hbm_budget=budget)
    return build, query


def run_cell(spec: Spec, workload: str, seed: int, seconds: float,
             trace: bool, device: str = "cuda", t_start: float | None = None,
             log=print) -> tuple[dict, dict]:
    """One run: (the result line's object, the checks {name: (value,
    limit)})."""
    t_start = time.perf_counter() if t_start is None else t_start
    cell = spec.cell(workload)
    cfg = spec.config(cell["config"])
    traffic = spec.traffic(cell["traffic"])

    import torch

    from colbwt_tpu_torch.io import native
    from colbwt_tpu_torch.pipeline.build import build_pipeline
    from colbwt_tpu_torch.pipeline.stream import query_stream
    from colbwt_tpu_torch.utils.log import get_logger

    dev = torch.device(device)
    if dev.type == "cuda":
        from colbwt_tpu_torch.ops import _kernels as K

        torch.cuda.init()
        torch.zeros(1, device=dev)
        K.load()
    if not native.available():
        raise RuntimeError("the native library (make -C native) did not "
                           "build: the program would run its fallbacks")
    cap = Capture()
    for name in LOGGERS:
        get_logger(name).addHandler(cap)
    work = Path(tempfile.mkdtemp(prefix="bench_port-"))
    w0 = written_bytes()
    try:
        docs = G.collection(cfg, seed)
        listing = G.write_collection(docs, work / "docs")
        n = sum(d.size + 1 for d in docs)
        bcfg, qcfg = _configs(cfg, n)
        prefix = str(work / "index" / "col")
        t0 = time.perf_counter()
        build_pipeline([], prefix, bcfg, filelist=str(listing), device=dev)
        build_s = time.perf_counter() - t0
        log(f"build {build_s:.3f}s, its log records:")
        build = cap.take(t0, log)
        reads = G.reads(docs, traffic, G.rng_for(seed, 1))
        reads_fa = work / "reads.fa"
        reads.write_fasta(reads_fa)
        # the warm-up job: the last batch's worth of another job of the mix,
        # so every shape of the window's batches is met once
        warm = G.reads(docs, traffic, G.rng_for(seed, 2))
        k = traffic["warmup_reads"]
        warm = G.Reads(warm.names[-k:], warm.seqs[-k:], warm.lens[-k:])
        warm_fa = work / "warmup.fa"
        warm.write_fasta(warm_fa)
        try:
            query_stream(prefix, str(warm_fa), qcfg, device=dev)
            warm_err = None
        except Exception as e:  # the program failed the warm-up job
            warm_err = f"{type(e).__name__}: {e}"
            log(f"warm-up job failed: {warm_err}")
        cap.take()
        offs, _ = J.record_layout(reads.names, reads.lens)
        job_bytes = 2 * int(offs[-1])
        out_dir = work / "out"
        out_dir.mkdir()
        setup_s = time.perf_counter() - t_start
        log(f"set-up {setup_s:.3f}s (build {build_s:.3f}s), n = {n}, "
            f"{reads.lens.size} reads a job")

        run = Run(cell, cfg, traffic, reads, build, build_s, setup_s,
                  warm_error=warm_err)
        prof = (T.Profile(dev, work / "trace.json") if trace
                else contextlib.nullcontext())
        with prof:
            cap.marking = trace
            with torch.profiler.record_function("bench:window"):
                deadline = time.perf_counter() + seconds
                while time.perf_counter() < deadline:
                    if written_bytes() - w0 + job_bytes > WRITE_CAP:
                        log("window ended early: the write cap")
                        break
                    i = len(run.jobs)
                    err = None
                    with torch.profiler.record_function(f"bench:job{i}"):
                        t0 = time.perf_counter()
                        try:
                            query_stream(prefix, str(reads_fa), qcfg,
                                         device=dev)
                        except Exception as e:  # the program failed a job
                            err = f"{type(e).__name__}: {e}"
                        t1 = time.perf_counter()
                    for ext in ("pml", "cid"):
                        src = Path(f"{reads_fa}.split.{ext}.bin")
                        if src.exists():
                            src.rename(out_dir / f"job{i}.{ext}")
                    run.jobs.append(Job(t0, t1, reads.lens.size, reads.bases,
                                        cap.take(), err))
                    if err:
                        log(f"job {i} failed: {err}")
                        break
            cap.marking = False
        run.trace = prof.result if trace else None
        peak = (int(torch.cuda.max_memory_allocated(dev))
                if dev.type == "cuda" else 0)
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()

        checks = judge(run, docs, cfg, build, out_dir, dev, log)
        result = report(spec, run, trace, checks, dev, peak,
                        written_bytes() - w0)
        return result, checks
    finally:
        for name in LOGGERS:
            get_logger(name).removeHandler(cap)
        shutil.rmtree(work, ignore_errors=True)


def judge(run: Run, docs, cfg: dict, build: dict, out_dir: Path, dev,
          log) -> dict:
    """Every job's records, and the build's counts of multi-MUMs and
    col-split marks, against the reference's: {check: (value, limit)}."""
    from bench_port import reference as R

    t0 = time.perf_counter()
    reads = run.reads
    pml, cid, counts = R.records(docs, cfg["build"], reads.seqs, reads.lens,
                                 dev)
    offs, _ = J.record_layout(reads.names, reads.lens)
    want = {"pml": J.expected_file(reads.names, pml, reads.lens),
            "cid": J.expected_file(reads.names, cid, reads.lens)}
    wrong = {"pml": 0, "cid": 0}
    for i in range(len(run.jobs)):
        for ext in wrong:
            f = out_dir / f"job{i}.{ext}"
            wrong[ext] += J.wrong_records(J.read_file(f), want[ext], offs)
            f.unlink(missing_ok=True)
    log(f"reference {json.dumps(counts)}, program mums {build.get('mums')} "
        f"marks {build.get('marks')}; reference and judgement "
        f"{time.perf_counter() - t0:.3f}s")
    failed = (sum(1 for j in run.jobs if j.error) + bool(run.warm_error)
              + (not run.jobs))
    return {"jobs_failed": (failed, 0),
            "mums_count_diff": (abs(build.get("mums", -1) - counts["mums"]),
                                0),
            "marks_count_diff": (abs(build.get("marks", -1)
                                     - counts["marks"]), 0),
            "pml_records_wrong": (wrong["pml"], 0),
            "cid_records_wrong": (wrong["cid"], 0)}


def report(spec: Spec, run: Run, trace: bool, checks: dict, dev, peak: int,
           written: int) -> dict:
    """The result line's object; `checks` comes last."""
    import torch

    correct = all(v <= lim for v, lim in checks.values())
    metrics = {}
    for m in spec.metrics(run.cell["name"], trace):
        v = spec.reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": (torch.cuda.get_device_name(dev)
                       if dev.type == "cuda" else "cpu"),
              "count": 1, "memory_peak_bytes": peak}
    out = {"correct": correct,
           "attempted": sum(j.reads for j in run.jobs),
           "failed": sum(j.reads for j in run.jobs if j.error),
           "metrics": metrics, "device": device}
    if trace and run.trace is not None:
        device["busy_s"] = run.trace.busy_s
        device["window_s"] = run.trace.window_s
        out["breakdown"] = {"device_ops": T.device_ops(run.trace),
                            "idle_gaps": T.idle_gaps(run.trace)}
    out["jobs"] = len(run.jobs)
    out["written_bytes"] = written
    out["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in checks.items()}
    return out
