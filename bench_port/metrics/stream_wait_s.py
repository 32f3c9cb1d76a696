"""The mean over the window's jobs of the `engine.wait` spans: the host
waiting on a batch's event, in seconds a job."""

from bench_port import spans as S


def read(run):
    return S.mean_span_s(run, "engine.wait")
