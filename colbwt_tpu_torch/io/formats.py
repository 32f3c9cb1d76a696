"""On-disk interchange codecs (SURVEY §2.4) — the port's copy of the parts
of colbwt_tpu/io/formats.py that the build writes and reads (the sd_vector
and .FL_table codecs stay there: no stage of either pipeline uses them).

Every integer is little-endian.  The reference's widths (RW_BYTES = 5 etc.,
include/common/common.hpp:46-54) are parameters here, defaulting to the same
values.  All codecs are NumPy-vectorized: a 5-byte int vector is decoded with
one reshape + dot, not a Python loop.

File contracts implemented (producer → consumer in the reference pipeline):

- ``.bwt.heads`` / ``.bwt.len``   RLBWT: 1 byte run char + rw_bytes run length
                                  (include/ds/FL_table.hpp:102-115)
- ``.bwt``                        explicit BWT bytes (src/rlbwt_to_bwt.cpp:22-27)
- ``.col_mums``                   rw_bytes num_docs, then (len, pos) pairs
                                  (src/col_split.cpp:90-106)
- ``.thr_pos``                    rw_bytes per BWT run (include/col_bwt.hpp:446-448)
- ``.col_ids``                    id_bytes per set bit of col_runs
                                  (include/col_split.hpp:147-156)
- ``.col_runs``                   sdsl plain bit_vector (include/col_split.hpp:374-390)
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

RW_BYTES = 5


# ---------------------------------------------------------------------------
# fixed-width little-endian integer vectors
# ---------------------------------------------------------------------------

def decode_fixed_ints(buf: bytes | np.ndarray, width: int = RW_BYTES) -> np.ndarray:
    """Decode a packed array of `width`-byte little-endian unsigned ints."""
    raw = np.frombuffer(buf, dtype=np.uint8) if isinstance(buf, (bytes, bytearray)) else buf
    if raw.size % width:
        raise ValueError(f"buffer size {raw.size} not a multiple of width {width}")
    mat = raw.reshape(-1, width).astype(np.uint64)
    weights = (np.uint64(1) << (np.uint64(8) * np.arange(width, dtype=np.uint64)))
    return (mat * weights).sum(axis=1, dtype=np.uint64)


def encode_fixed_ints(values: np.ndarray, width: int = RW_BYTES) -> bytes:
    """Encode unsigned ints as packed `width`-byte little-endian."""
    v = np.asarray(values, dtype=np.uint64)
    if v.size and width < 8 and int(v.max(initial=0)) >= (1 << (8 * width)):
        raise OverflowError(f"value {int(v.max())} does not fit in {width} bytes")
    shifts = np.uint64(8) * np.arange(width, dtype=np.uint64)
    mat = ((v[:, None] >> shifts[None, :]) & np.uint64(0xFF)).astype(np.uint8)
    return mat.tobytes()


def read_fixed_ints(path: str | Path, width: int = RW_BYTES) -> np.ndarray:
    return decode_fixed_ints(Path(path).read_bytes(), width)


def write_fixed_ints(path: str | Path, values: np.ndarray, width: int = RW_BYTES) -> None:
    Path(path).write_bytes(encode_fixed_ints(values, width))


# ---------------------------------------------------------------------------
# RLBWT heads/len  (PREFIX.fa.bwt.heads + PREFIX.fa.bwt.len)
# ---------------------------------------------------------------------------

def read_rlbwt(prefix: str | Path, rw_bytes: int = RW_BYTES) -> tuple[np.ndarray, np.ndarray]:
    """Read (heads, lens): heads uint8 run chars, lens uint64 run lengths."""
    heads = np.frombuffer(Path(f"{prefix}.bwt.heads").read_bytes(), dtype=np.uint8)
    lens = read_fixed_ints(f"{prefix}.bwt.len", rw_bytes)
    if heads.size != lens.size:
        raise ValueError(f"heads ({heads.size}) and lens ({lens.size}) run counts differ")
    return heads, lens


def write_rlbwt(prefix: str | Path, heads: np.ndarray, lens: np.ndarray,
                rw_bytes: int = RW_BYTES) -> None:
    Path(f"{prefix}.bwt.heads").write_bytes(np.asarray(heads, dtype=np.uint8).tobytes())
    write_fixed_ints(f"{prefix}.bwt.len", lens, rw_bytes)


def write_plain_bwt(path: str | Path, heads: np.ndarray, lens: np.ndarray) -> None:
    """Expand RLBWT to the explicit one-byte-per-symbol BWT
    (the rlbwt_to_bwt stage, src/rlbwt_to_bwt.cpp:22-27)."""
    bwt = np.repeat(np.asarray(heads, dtype=np.uint8), np.asarray(lens, dtype=np.int64))
    Path(path).write_bytes(bwt.tobytes())


def read_plain_bwt(path: str | Path) -> np.ndarray:
    return np.frombuffer(Path(path).read_bytes(), dtype=np.uint8)


# ---------------------------------------------------------------------------
# .col_mums  (multi-MUM records)
# ---------------------------------------------------------------------------

def read_col_mums(path: str | Path, rw_bytes: int = RW_BYTES
                  ) -> tuple[int, np.ndarray, np.ndarray]:
    """Returns (num_docs, mum_lens, mum_bwt_pos).

    Layout (src/col_split.cpp:90-106): one rw_bytes uint num_docs, then
    num_mums interleaved (length, bwt_position) rw_bytes pairs.
    """
    vals = read_fixed_ints(path, rw_bytes)
    if vals.size % 2 != 1:
        raise ValueError(f".col_mums has {vals.size} values; expected odd count")
    num_docs = int(vals[0])
    pairs = vals[1:].reshape(-1, 2)
    return num_docs, pairs[:, 0].copy(), pairs[:, 1].copy()


def write_col_mums(path: str | Path, num_docs: int, mum_lens: np.ndarray,
                   mum_pos: np.ndarray, rw_bytes: int = RW_BYTES) -> None:
    lens = np.asarray(mum_lens, dtype=np.uint64)
    pos = np.asarray(mum_pos, dtype=np.uint64)
    vals = np.empty(1 + 2 * lens.size, dtype=np.uint64)
    vals[0] = num_docs
    vals[1::2] = lens
    vals[2::2] = pos
    write_fixed_ints(path, vals, rw_bytes)


# ---------------------------------------------------------------------------
# .thr_pos and .col_ids
# ---------------------------------------------------------------------------

def read_thresholds_file(path: str | Path, rw_bytes: int = RW_BYTES) -> np.ndarray:
    return read_fixed_ints(path, rw_bytes)


def write_thresholds_file(path: str | Path, thresholds: np.ndarray,
                          rw_bytes: int = RW_BYTES) -> None:
    write_fixed_ints(path, thresholds, rw_bytes)


def read_col_ids(path: str | Path, id_bytes: int = 1) -> np.ndarray:
    return read_fixed_ints(path, id_bytes)


def write_col_ids(path: str | Path, ids: np.ndarray, id_bytes: int = 1,
                  id_bits: int = 8) -> np.ndarray:
    """Write per-set-bit col IDs with the reference's modular binning
    ((id % (id_max-1)) + 1 for id >= id_max; include/col_split.hpp:147-156).
    Returns the binned ids."""
    v = np.asarray(ids, dtype=np.uint64)
    id_max = np.uint64(1 << id_bits)
    binned = np.where(v >= id_max, (v % (id_max - np.uint64(1))) + np.uint64(1), v)
    write_fixed_ints(path, binned, id_bytes)
    return binned


# ---------------------------------------------------------------------------
# .col_pml packed-row serialization (the reference alt-path index file)
# ---------------------------------------------------------------------------
# Layout (col_pml::serialize -> col_bwt::serialize -> LF_table::serialize,
# include/col_bwt.hpp:360-380 + include/ds/LF_table.hpp:325-357): bwt_r (8B),
# n (8B), r (8B), size (8B, == r), then r raw 18-byte packed col_thr rows
# (write_vec memcpy of the packed struct, include/common/common.hpp:310-323):
# char:8 idx:40 interval:32 offset:16 col_id:8 threshold:40 bits, LSB-first.

_COL_THR_BYTES = 18


def write_col_pml_file(path: str | Path, *, bwt_r: int, n: int,
                       char: np.ndarray, idx: np.ndarray,
                       dest_interval: np.ndarray, dest_offset: np.ndarray,
                       col_id: np.ndarray, threshold: np.ndarray) -> None:
    r = int(np.asarray(char).size)
    rows = np.zeros((r, _COL_THR_BYTES), dtype=np.uint8)

    def put(field, byte_off, width):
        v = np.asarray(field, dtype=np.uint64)
        if width < 8 and v.size and int(v.max(initial=0)) >= (1 << (8 * width)):
            raise OverflowError(f"field at offset {byte_off} overflows {width}B")
        for b in range(width):
            rows[:, byte_off + b] = ((v >> np.uint64(8 * b)) & np.uint64(0xFF)
                                     ).astype(np.uint8)

    put(char, 0, 1)
    put(idx, 1, 5)            # BWT_BYTES = 5
    put(dest_interval, 6, 4)  # RUN_BYTES = 4
    put(dest_offset, 10, 2)   # LEN_BYTES = 2
    put(col_id, 12, 1)        # ID_BYTES = 1
    put(threshold, 13, 5)     # BWT_BYTES = 5
    header = np.array([bwt_r, n, r, r], dtype="<u8").tobytes()
    Path(path).write_bytes(header + rows.tobytes())


def read_col_pml_file(path: str | Path) -> dict:
    raw = Path(path).read_bytes()
    bwt_r, n, r, size = np.frombuffer(raw[:32], dtype="<u8")
    rows = np.frombuffer(raw[32:32 + int(size) * _COL_THR_BYTES],
                         dtype=np.uint8).reshape(int(size), _COL_THR_BYTES)

    def get(byte_off, width):
        v = np.zeros(rows.shape[0], dtype=np.uint64)
        for b in range(width):
            v |= rows[:, byte_off + b].astype(np.uint64) << np.uint64(8 * b)
        return v

    return {
        "bwt_r": int(bwt_r), "n": int(n), "r": int(r),
        "char": get(0, 1).astype(np.uint8),
        "idx": get(1, 5).astype(np.int64),
        "dest_interval": get(6, 4).astype(np.int64),
        "dest_offset": get(10, 2).astype(np.int64),
        "col_id": get(12, 1).astype(np.uint8),
        "threshold": get(13, 5).astype(np.int64),
    }


# ---------------------------------------------------------------------------
# sdsl plain bit_vector codec
# ---------------------------------------------------------------------------
# sdsl int_vector<1> serialization: a uint64 size-in-bits header followed by
# ceil(bits/64) uint64 data words, bit i of the vector stored at bit (i % 64)
# of word (i // 64).  This is the layout written by bv.serialize(out) for
# .col_runs (include/col_split.hpp:383-387).

def write_sdsl_bit_vector(path: str | Path, bits: np.ndarray) -> None:
    b = np.asarray(bits, dtype=bool)
    n = b.size
    n_words = (n + 63) // 64
    padded = np.zeros(n_words * 64, dtype=bool)
    padded[:n] = b
    # bit i lives at bit (i % 8) of byte (i // 8): LSB-first within each byte,
    # bytes ascending — the little-endian uint64 word layout sdsl writes.
    data = np.packbits(padded, bitorder="little").tobytes()
    header = np.array([n], dtype="<u8").tobytes()
    Path(path).write_bytes(header + data)


def read_sdsl_bit_vector(path: str | Path) -> np.ndarray:
    raw = Path(path).read_bytes()
    n = int(np.frombuffer(raw[:8], dtype="<u8")[0])
    n_words = (n + 63) // 64
    body = np.frombuffer(raw[8:8 + 8 * n_words], dtype=np.uint8)
    flat = np.unpackbits(body, bitorder="little")
    return flat[:n].astype(bool)
