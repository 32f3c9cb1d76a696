"""The mean over the window's jobs of the stream log's `table_build_s`
extra: the engine tables' build or load in each job."""


def read(run):
    vals = [j.extras["table_build_s"] for j in run.jobs
            if "table_build_s" in j.extras]
    return sum(vals) / len(vals) if vals else None
