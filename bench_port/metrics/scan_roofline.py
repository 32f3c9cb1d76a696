"""The scan kernels' share of their roofline over the traced window, in %:
the least time of the completed jobs' reads on the configuration's engine
path (bench_port/roofline.py) over the device time of those kernels in the
trace."""

import numpy as np

from bench_port import roofline as RF


def read(run):
    if run.trace is None:
        return None
    paths = run.config["scan_path"]
    secs = run.trace.kernel_seconds(RF.scan_kernels(paths))
    done = sum(1 for j in run.jobs if j.error is None)
    if secs <= 0 or not done:
        return None
    r = run.reads
    cols = np.arange(r.seqs.shape[1]) < r.lens[:, None]
    acgt = np.isin(r.seqs, np.frombuffer(b"ACGT", dtype=np.uint8))
    only = (acgt | ~cols).all(axis=1)
    least = done * RF.scan_bytes(r.lens, only, paths) / RF.HBM_BYTES_PER_S
    return 100.0 * least / secs
