"""The build log's `index_s` extra (pipeline/build.py)."""


def read(run):
    return run.build.get("index_s")
