"""The program's spans and counters, as the streaming query logs them at a
job's end (colbwt_tpu_torch/pipeline/stream.py: the `spans`, `span_totals`
and `counters` extras of its last record), read per job, and its spans
placed on the device trace's clock.

A program that logs none of them (one from before the recorder) gives
None, never an error; a span or counter the job never reached reads 0.
"""

from __future__ import annotations

# the spans under which no other span of the job runs on the host, but
# for the engine's, which lie under stream.long on the long-read path
LEAVES = ("stream.load_index", "stream.tables", "stream.read",
          "stream.slice", "stream.write", "stream.long", "stream.close")


def is_leaf(name: str) -> bool:
    return name in LEAVES or name.startswith("engine.")


def _jobs(run, key: str) -> list:
    """The completed jobs whose extras hold `key`."""
    return [j for j in run.jobs if j.error is None and key in j.extras]


def mean_span_s(run, *names: str) -> float | None:
    """The mean over the completed jobs of the seconds the spans `names`
    took in all (each span's total, nested ones included)."""
    jobs = _jobs(run, "span_totals")
    if not jobs:
        return None
    return sum(sum(j.extras["span_totals"].get(n, {}).get("total_s", 0.0)
                   for n in names) for j in jobs) / len(jobs)


def pad_pct(run) -> float | None:
    """The mean over the completed jobs of the share of the launched scans'
    cells that were padding: 100 × (1 − scanned_bases / padded_cells)."""
    jobs = _jobs(run, "counters")
    if not jobs:
        return None
    vals = []
    for j in jobs:
        c = j.extras["counters"]
        cells = c.get("padded_cells", 0)
        vals.append(100.0 * (1.0 - c.get("scanned_bases", 0) / cells)
                    if cells else 0.0)
    return sum(vals) / len(vals)


def merged(intervals) -> list:
    """Sorted, disjoint (start, end) covering the same points."""
    out: list = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def overlap(a: list, b: list) -> float:
    """The length the merged interval lists `a` and `b` share."""
    i = j = 0
    tot = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            tot += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return tot


def idle_untraced_pct(run) -> float | None:
    """Of the completed jobs' device-idle time (each `bench:job<i>` range
    of the trace less the trace's busy intervals), the share in % that no
    leaf span of the job covers.  A job's spans go onto the trace's clock
    by one anchor: the range's start against `Job.start`, both taken on
    entering it."""
    tr = run.trace
    if tr is None:
        return None
    idle = untraced = 0.0
    found = False
    for i, job in enumerate(run.jobs):
        win = tr.spans.get(f"bench:job{i}")
        if job.error is not None or "spans" not in job.extras or win is None:
            continue
        found = True
        ws, we = win
        off = ws - job.start * 1e6  # microseconds
        busy = merged((max(s, ws), min(e, we)) for s, e in tr.busy)
        edges = [ws] + [x for b in busy for x in b] + [we]
        gaps = merged((edges[k], edges[k + 1])
                      for k in range(0, len(edges), 2))
        leaves = merged((s / 1e3 + off, e / 1e3 + off)
                        for name, s, e, _ in job.extras["spans"]
                        if e is not None and is_leaf(name))
        gap_us = sum(e - s for s, e in gaps)
        idle += gap_us
        untraced += gap_us - overlap(gaps, leaves)
    if not found:
        return None
    return 100.0 * untraced / idle if idle > 0 else 0.0
