"""The mean over the window's jobs of the `engine.unpack` and
`stream.slice` spans: the packed plane split, the fallback reads spliced in
and each read's columns sliced out, in seconds a job."""

from bench_port import spans as S


def read(run):
    return S.mean_span_s(run, "engine.unpack", "stream.slice")
