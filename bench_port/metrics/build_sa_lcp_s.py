"""The build log's `sa_lcp_s` extra (pipeline/build.py)."""


def read(run):
    return run.build.get("sa_lcp_s")
