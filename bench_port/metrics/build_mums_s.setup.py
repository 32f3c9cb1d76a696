"""The build log's `mums_s` extra (pipeline/build.py), in cells whose build
is timed only inside `setup_s`."""


def read(run):
    return run.build.get("mums_s")
