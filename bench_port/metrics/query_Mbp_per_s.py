"""Bases of the reads of every completed job over the wall from the first
job's start to the last completed job's end, in millions a second."""


def read(run):
    done = [j for j in run.jobs if j.error is None]
    if not done:
        return None
    return sum(j.bases for j in done) / (done[-1].end - run.jobs[0].start) / 1e6
