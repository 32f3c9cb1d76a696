"""The traced window: torch.profiler over the jobs (the calls the
utils/profiling.py `trace` of the program makes, kept here so that the
yardstick does not move with the program), read back from its Chrome
trace.

The benchmark's own spans (`bench:window`, `bench:job<i>`) and a marker at
each of the program's log records (`bench:log:<key>`, the first extra the
record carries) are `record_function` ranges; the device's work is the
trace's kernel, copy and memset events.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path

import torch

BUSY = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclass
class Trace:
    window: tuple            # (start, end) in microseconds
    device: list             # (name, category, start, end) of device work
    spans: dict              # bench:* span name -> (start, end)
    markers: list            # (name, time) of the log markers, in order
    busy: list = field(default_factory=list)  # merged (start, end)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy) * 1e-6

    def kernel_seconds(self, names: set[str]) -> float:
        """Device seconds of the kernels whose name holds one of `names`."""
        return sum(e - s for n, c, s, e in self.device
                   if c == "kernel" and any(k in n for k in names)) * 1e-6


def short_name(name: str) -> str:
    """A kernel's name without its return type, namespace and arguments,
    at most 100 characters."""
    name = name.replace("(anonymous namespace)::", "")
    name = name.split("(")[0]
    name = name[5:] if name.startswith("void ") else name
    return name[:100]


def read(path: Path) -> Trace:
    data = json.loads(path.read_text())
    events = data["traceEvents"] if isinstance(data, dict) else data
    spans, markers, device = {}, [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        name, cat = e.get("name", ""), e.get("cat", "")
        ts, dur = float(e["ts"]), float(e.get("dur", 0))
        if cat == "user_annotation" and name.startswith("bench:"):
            if name.startswith("bench:log:"):
                markers.append((name[len("bench:log:"):], ts))
            else:
                spans[name] = (ts, ts + dur)
        elif cat in BUSY:
            device.append((name, cat, ts, ts + dur))
    window = spans.get("bench:window", (0.0, 0.0))
    clipped = sorted((max(s, window[0]), min(e, window[1]))
                     for _, _, s, e in device
                     if e > window[0] and s < window[1])
    busy: list = []
    for s, e in clipped:
        if busy and s <= busy[-1][1]:
            busy[-1] = (busy[-1][0], max(busy[-1][1], e))
        else:
            busy.append((s, e))
    markers.sort(key=lambda m: m[1])
    return Trace(window, device, spans, markers, busy)


def device_ops(tr: Trace, top: int = 10) -> list:
    """[[kernel or copy name, seconds]] of the device work that took most
    time in the window."""
    tot: dict = {}
    for name, cat, s, e in tr.device:
        key = short_name(name) if cat == "kernel" else cat
        tot[key] = tot.get(key, 0.0) + (e - s) * 1e-6
    return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])
            [:top]]


def _phase(tr: Trace, t: float) -> str:
    """What the host was doing at time t: the job, and its phase by the
    program's last log record before t ("tables" before the engine is
    ready, "stream" while reads stream, "close" after the last record)."""
    for name, (s, e) in tr.spans.items():
        if name.startswith("bench:job") and s <= t <= e:
            last = [m for m, mt in tr.markers if s <= mt <= t]
            phase = ("tables" if not last else
                     "stream" if last[-1] in ("engine", "table_cache")
                     else "close")
            return f"{name[len('bench:'):]}:{phase}"
    return "between_jobs"


def idle_gaps(tr: Trace, top: int = 10) -> list:
    """[[what the host was doing, seconds]] of the window's longest spans
    with no device work."""
    edges = [tr.window[0]] + [x for b in tr.busy for x in b] + [tr.window[1]]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[0] - g[1])
    return [[_phase(tr, (a + b) / 2), (b - a) * 1e-6] for a, b in gaps[:top]]


class Profile:
    """torch.profiler over the host and, on a CUDA device, the card;
    `result` is the Trace once the block has ended."""

    def __init__(self, device: torch.device, out: Path):
        self.device = device
        self.out = out
        self.result: Trace | None = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self._prof.export_chrome_trace(str(self.out))
            self.result = read(self.out)
            self.out.unlink(missing_ok=True)
        return False


def mark(name: str) -> None:
    """A zero-length span in the trace: a point in time."""
    with torch.profiler.record_function(f"bench:log:{name}"):
        pass
