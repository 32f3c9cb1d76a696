"""The yardstick of the scan kernels: the card's peaks and the least bytes
the window's reads need on a configuration's engine path.

The rule is PERF.md's table of kernels (section 6) for K3 and K4: inputs
once, outputs once, and a gathered table at the rows its gathers take,
counted here from the reads' own lengths and not from the program's padded
tensors, so the count is the same whatever implements the scan:

- "k3_acgt_k1": K3, the positional scan at k = 1 over ACGT keys: a base's
  2-bit digit, 12 bytes a read (its length and starting state), a base's
  PML and CID (2 bytes, the packed plane), one 8-byte table row a base;
- "k3_general_k1": K3 on the general k = 1 table: a base's 1-byte symbol,
  12 bytes a read, 2 bytes out and one 8-byte row a base;
- "k4_compact": K4, the compact scan: a base's symbol, 12 bytes a read, 2
  bytes out, and a 32-byte run row and an 8-byte successor/predecessor pair
  a base.
"""

from __future__ import annotations

import numpy as np

# NVIDIA's data sheet, H100 SXM at its 700 W limit
HBM_BYTES_PER_S = 3.35e12
# each path's kernel, as its name appears in the profiler's trace
KERNEL_OF_PATH = {"k3_acgt_k1": "query_chunk_pos_kernel",
                  "k3_general_k1": "query_chunk_pos_kernel",
                  "k4_compact": "query_batch_xla_kernel"}
# (input bytes a base, bytes a read, output bytes a base, gathered a base)
BYTES_OF_PATH = {"k3_acgt_k1": (0.25, 12, 2, 8),
                 "k3_general_k1": (1, 12, 2, 8),
                 "k4_compact": (1, 12, 2, 40)}


def path_bytes(lens: np.ndarray, path: str) -> int:
    """The least bytes of scanning reads of lengths `lens` on `path`."""
    per_in, per_read, per_out, per_step = BYTES_OF_PATH[path]
    lens = np.asarray(lens, dtype=np.int64)
    digits = (np.ceil(lens * per_in).sum() if per_in < 1
              else lens.sum() * per_in)
    return int(digits + per_read * lens.size
               + (per_out + per_step) * lens.sum())


def scan_bytes(lens: np.ndarray, acgt_only: np.ndarray, paths: dict) -> int:
    """The least bytes of one job's scan: reads over ACGT alone on
    paths["acgt"], the others on paths["other"]."""
    return (path_bytes(lens[acgt_only], paths["acgt"])
            + path_bytes(lens[~acgt_only], paths["other"]))


def scan_kernels(paths: dict) -> set[str]:
    return {KERNEL_OF_PATH[p] for p in paths.values()}
