"""Profiling hooks — port of colbwt_tpu/utils/profiling.py: torch.profiler
where the JAX package has jax.profiler (the reference's Timer/status
instrumentation, SURVEY §5.1), and the span recorder the streaming query
and the build's stages write into (`StepTimer`)."""

from __future__ import annotations

import contextlib
import time
from pathlib import Path

import torch

from colbwt_tpu_torch.utils.device import resolve_device

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: str | None = None, device=None):
    """Profile the enclosed block with torch.profiler, host activity plus
    the card's (kernels and copies) when `device` (default cuda) is a
    CUDA device, and export it as a Chrome trace to log_dir/trace.json
    (view it in chrome://tracing or Perfetto).  Yields the profiler, or
    None: a no-op when log_dir is None."""
    if log_dir is None:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    dev = resolve_device(device)
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(Path(log_dir) / TRACE_FILE))


@contextlib.contextmanager
def annotate(name: str):
    """Named region inside a captured trace: a torch.profiler
    record_function while a profiler runs (outside one it would record
    nothing, at about 10 µs a range), and an NVTX range when CUDA is
    available (the CPU build of PyTorch has no NVTX)."""
    with (torch.profiler.record_function(name)
          if torch.autograd._profiler_enabled()
          else contextlib.nullcontext()):
        if not torch.cuda.is_available():
            yield
            return
        torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            torch.cuda.nvtx.range_pop()


class StepTimer:
    """Wall-clock per-stage accumulator; the Timer analog
    (include/common/common.hpp:129-174) with named stages.

    It is also the program's span recorder.  Each stage is a span kept as
    [name, start_ns, end_ns, parent] (`time.perf_counter_ns`; parent the
    index in `spans` of the enclosing span, None at the top) and entered
    as `annotate(name)`, so a torch.profiler trace shows it as a
    user_annotation range beside the card's kernels and copies, on the
    same clock.  `begin`/`end` open and close a span where a `with` block
    does not fit; `count` adds to a named counter.  Spans are meant per
    batch or per stage, never per item: per-item work is counted."""

    def __init__(self) -> None:
        self.stages: dict[str, float] = {}
        self.spans: list[list] = []
        self.counters: dict[str, float] = {}
        self._open: list[tuple[int, contextlib.AbstractContextManager]] = []

    def begin(self, name: str) -> None:
        # the clock is read outside the range's entry and exit, which a
        # profiler stamps at their far ends: the span holds the range
        start = time.perf_counter_ns()
        ann = annotate(name)
        ann.__enter__()
        parent = self._open[-1][0] if self._open else None
        self._open.append((len(self.spans), ann))
        self.spans.append([name, start, None, parent])

    def end(self) -> None:
        """Close the innermost open span."""
        i, ann = self._open.pop()
        ann.__exit__(None, None, None)
        span = self.spans[i]
        span[2] = time.perf_counter_ns()
        self.stages[span[0]] = (self.stages.get(span[0], 0.0)
                                + (span[2] - span[1]) * 1e-9)

    @contextlib.contextmanager
    def stage(self, name: str):
        """A span over the block; spans left open inside it (an exception
        passing through) are closed with it."""
        depth = len(self._open)
        self.begin(name)
        try:
            yield
        finally:
            while len(self._open) > depth:
                self.end()

    def count(self, name: str, n: float = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + n

    def summary(self) -> dict[str, dict]:
        """{name: {"count", "total_s", "self_s"}} over the closed spans;
        a span's self time is its own less what its child spans cover."""
        child = [0] * len(self.spans)
        for name, s, e, parent in self.spans:
            if e is not None and parent is not None:
                child[parent] += e - s
        out: dict[str, dict] = {}
        for (name, s, e, _), c in zip(self.spans, child):
            if e is None:
                continue
            row = out.setdefault(name, {"count": 0, "total_s": 0.0,
                                        "self_s": 0.0})
            row["count"] += 1
            row["total_s"] += (e - s) * 1e-9
            row["self_s"] += (e - s - c) * 1e-9
        return out

    def report(self) -> str:
        total = sum(self.stages.values())
        lines = [f"{k}: {v:.3f}s ({100 * v / max(total, 1e-9):.0f}%)"
                 for k, v in sorted(self.stages.items(), key=lambda kv: -kv[1])]
        return "\n".join(lines)
