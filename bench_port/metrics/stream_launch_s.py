"""The mean over the window's jobs of the `engine.launch` spans: uploads
(pinning included), the kernel launches, the copies back queued and the
event recorded, in seconds a job."""

from bench_port import spans as S


def read(run):
    return S.mean_span_s(run, "engine.launch")
