"""What decides `correct`: the program's PML and CID records against the
reference's, byte for byte.

A record of the `.split.pml.bin` and `.split.cid.bin` files (the program's
io/pml_out.py layout, little-endian): uint16 name length, the name, uint64
m, then m uint16 values (PML capped at 65535; CID binned below 256).  The
expected files are laid out here from the reference's arrays; a record
counts as wrong when any of its bytes differs, and every record counts as
wrong when the file's length differs.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def record_layout(names: list[str], lens: np.ndarray
                  ) -> tuple[np.ndarray, list[bytes]]:
    """(record start offsets with the end appended, encoded names)."""
    enc = [nm.encode() for nm in names]
    size = 2 + np.array([len(e) for e in enc], dtype=np.int64) + 8 + 2 * lens
    return np.concatenate([[0], np.cumsum(size)]), enc


def expected_file(names: list[str], values: np.ndarray, lens: np.ndarray
                  ) -> np.ndarray:
    """The file's bytes (uint8) for reads whose per-base values sit
    left-aligned in the rows of `values`."""
    offs, enc = record_layout(names, lens)
    buf = np.zeros(int(offs[-1]), dtype=np.uint8)
    nl = np.array([len(e) for e in enc], dtype=np.int64)
    vals = np.clip(values, 0, 0xFFFF).astype("<u2")
    # records of one (name length, read length) shape are written together
    keys = nl * (1 << 32) + lens
    for key in np.unique(keys):
        rows = np.flatnonzero(keys == key)
        k, m = int(nl[rows[0]]), int(lens[rows[0]])
        block = np.empty((rows.size, 2 + k + 8 + 2 * m), dtype=np.uint8)
        block[:, 0:2] = np.array([k], "<u2").view(np.uint8)
        block[:, 2:2 + k] = np.frombuffer(b"".join(enc[i] for i in rows),
                                          dtype=np.uint8).reshape(-1, k)
        block[:, 2 + k:10 + k] = np.array([m], "<u8").view(np.uint8)
        block[:, 10 + k:] = vals[rows, :m].view(np.uint8)
        at = offs[rows][:, None] + np.arange(block.shape[1])
        buf[at] = block
    return buf


def wrong_records(got: np.ndarray | None, expected: np.ndarray,
                  offs: np.ndarray) -> int:
    """How many records of the file's bytes `got` (None: no file) differ
    from `expected`."""
    records = offs.size - 1
    if got is None or got.size != expected.size:
        return records
    bad = np.flatnonzero(got != expected)
    return int(np.unique(np.searchsorted(offs, bad, side="right") - 1).size)


def read_file(path: Path) -> np.ndarray | None:
    return np.fromfile(path, dtype=np.uint8) if path.exists() else None
