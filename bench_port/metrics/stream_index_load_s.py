"""The mean over the window's jobs of the `stream.load_index` span: the
index file's load (`ColPmlIndex.load`) in each job, in seconds."""

from bench_port import spans as S


def read(run):
    return S.mean_span_s(run, "stream.load_index")
