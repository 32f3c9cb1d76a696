"""Profiling hooks — port of colbwt_tpu/utils/profiling.py: torch.profiler
where the JAX package has jax.profiler (the reference's Timer/status
instrumentation, SURVEY §5.1)."""

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
    record_function, and an NVTX range when CUDA is available (the CPU
    build of PyTorch has no NVTX)."""
    with torch.profiler.record_function(name):
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
    (include/common/common.hpp:129-174) with named stages."""

    def __init__(self) -> None:
        self.stages: dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        yield
        self.stages[name] = self.stages.get(name, 0.0) + time.perf_counter() - t0

    def report(self) -> str:
        total = sum(self.stages.values())
        lines = [f"{k}: {v:.3f}s ({100 * v / max(total, 1e-9):.0f}%)"
                 for k, v in sorted(self.stages.items(), key=lambda kv: -kv[1])]
        return "\n".join(lines)
