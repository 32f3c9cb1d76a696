"""The mean over the window's jobs of the `stream.read` spans: FASTA
parsing and batch assembly between dispatches, in seconds a job."""

from bench_port import spans as S


def read(run):
    return S.mean_span_s(run, "stream.read")
