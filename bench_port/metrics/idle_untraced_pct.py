"""Of the jobs' device-idle time in the traced window, the share in %
that no leaf span of the program covers (bench_port/spans.py)."""

from bench_port import spans as S


def read(run):
    return S.idle_untraced_pct(run)
