"""The mean over the window's jobs of the `engine.encode` spans: reads
to dense ids or key digits, packed, the fallback reads' included, in seconds
a job."""

from bench_port import spans as S


def read(run):
    return S.mean_span_s(run, "engine.encode")
