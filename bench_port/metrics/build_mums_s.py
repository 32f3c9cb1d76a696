"""The build log's `mums_s` extra (pipeline/build.py)."""


def read(run):
    return run.build.get("mums_s")
