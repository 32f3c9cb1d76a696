"""Process start to window start: libraries, collection, build, reads and
the warm-up job."""


def read(run):
    return run.setup_s
