"""The scan kernels' least bytes against hand arithmetic."""

import numpy as np

from bench_port import roofline as RF


def test_path_bytes_by_hand():
    lens = np.array([150, 150, 151])
    # K3 over ACGT keys: 2-bit digits (38, 38, 38 bytes), 12 a read,
    # 2 out and 8 gathered a base
    assert RF.path_bytes(lens, "k3_acgt_k1") == (38 * 3 + 36 + 10 * 451)
    # the general T1: a byte a base in
    assert RF.path_bytes(lens, "k3_general_k1") == 451 + 36 + 10 * 451
    # K4: a byte in, 2 out, 40 gathered a base
    assert RF.path_bytes(lens, "k4_compact") == 451 + 36 + 42 * 451


def test_scan_bytes_splits_by_keys():
    lens = np.array([150, 151, 150])
    only = np.array([True, False, True])
    paths = {"acgt": "k3_acgt_k1", "other": "k4_compact"}
    want = (RF.path_bytes(lens[[0, 2]], "k3_acgt_k1")
            + RF.path_bytes(lens[[1]], "k4_compact"))
    assert RF.scan_bytes(lens, only, paths) == want
    assert RF.scan_kernels(paths) == {"query_chunk_pos_kernel",
                                      "query_batch_xla_kernel"}
    # a job of the short150 mix on chr21_hap8's paths
    job = (RF.path_bytes(np.full(261120, 150), "k3_acgt_k1")
           + RF.path_bytes(np.full(1024, 151), "k4_compact"))
    assert job == 261120 * (38 + 12 + 1500) + 1024 * (151 + 12 + 42 * 151)
