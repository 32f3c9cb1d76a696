"""The mean over the window's jobs of the `stream.write` spans: the
records appended to the output files, in seconds a job."""

from bench_port import spans as S


def read(run):
    return S.mean_span_s(run, "stream.write")
