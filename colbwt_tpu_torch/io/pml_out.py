"""PML / CID query-output writers — the port's copy of
colbwt_tpu/io/pml_out.py; the files are byte-identical to the JAX
package's.

Two surfaces, matching the reference:

1. Text ``.pml`` / ``.cid`` — the in-repo alt path format
   (src/pml_query.cpp:74-90): per read, a header line ``>NAME \\n`` (note the
   trailing space, kept for byte parity with the reference's
   ``fs << '>' << id << " \\n"``), then every per-base value followed by a
   single space (ostream_iterator semantics: trailing space before newline).

2. Binary ``.split.pml.bin`` / ``.split.cid.bin`` — the shipped movi-split
   output (scripts/col-bwt.py:194-198).  The Movi fork's exact byte layout is
   not pinned down in the reference snapshot (SURVEY §2.4 hard part #1), so the
   layout here is a documented, versioned record format isolated behind this
   module; swap `write_pml_cid_binary` when fork parity golden files exist.

   Record layout (little-endian), per read, identical for pml and cid files:
       uint16  name_len
       bytes   name (name_len bytes, no NUL)
       uint64  m  (number of per-base values)
       uint16 × m  values (PML capped at 65535; CID is <= 255 by id binning)

   A batch of records can be written from its (B, W) output planes
   (`record_layout`, `fill_records`, `PmlCidBinaryWriter.append_planes`):
   each file's bytes are assembled in one buffer, a block of rows a run of
   records of one shape, and written at once.  The bytes are those of the
   per-record path.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import NamedTuple

import numpy as np


def write_pml_cid_text(pml_path: str | Path, cid_path: str | Path,
                       names: list[str],
                       pmls: list[np.ndarray], cids: list[np.ndarray]) -> None:
    with Path(pml_path).open("w") as f_pml, Path(cid_path).open("w") as f_cid:
        for name, p, c in zip(names, pmls, cids):
            f_pml.write(f">{name} \n")
            f_pml.write("".join(f"{int(v)} " for v in p))
            f_pml.write("\n")
            f_cid.write(f">{name} \n")
            f_cid.write("".join(f"{int(v)} " for v in c))
            f_cid.write("\n")


def write_pml_cid_text_long(pml_path: str | Path, cid_path: str | Path,
                            names: list[str],
                            pmls: list[np.ndarray], cids: list[np.ndarray]
                            ) -> None:
    """The ``-l`` long-pattern text mode (pml_direct_to_file,
    src/pml_query.cpp:32-63): the reference streams each value as it is
    computed — header and digits character-reversed, values in backward scan
    order — then shells out to ``rev`` to flip every line.  Reproduced here
    literally (build the ``.rev`` intermediate content, then reverse each
    line) so the final bytes match the reference process exactly."""

    def rev_content(arrays: list[np.ndarray]) -> str:
        parts: list[str] = []
        for name, arr in zip(names, arrays):
            header = f">{name} \n"
            parts.append(header[::-1])  # std::reverse includes the newline
            # store order is i = 0..m-1 -> text index m-1-i (backward scan),
            # each written as ' ' + reversed digits
            vals = np.asarray(arr)
            parts.extend(" " + str(int(v))[::-1] for v in vals[::-1])
            parts.append("\n")
        return "".join(parts)

    def rev_lines(s: str) -> str:
        # `rev FILE > OUT` reverses the characters of every line
        return "\n".join(line[::-1] for line in s.split("\n"))

    Path(pml_path).write_text(rev_lines(rev_content(pmls)))
    Path(cid_path).write_text(rev_lines(rev_content(cids)))


def _record_bytes(name: str, arr: np.ndarray) -> bytes:
    nb = name.encode()
    return (struct.pack("<H", len(nb)) + nb + struct.pack("<Q", arr.size)
            + np.clip(np.asarray(arr), 0, 0xFFFF).astype("<u2").tobytes())


def _write_binary_one(path: str | Path, names: list[str],
                      arrays: list[np.ndarray]) -> None:
    with Path(path).open("wb") as fh:
        for name, arr in zip(names, arrays):
            fh.write(_record_bytes(name, arr))


def write_pml_cid_binary(pml_path: str | Path, cid_path: str | Path,
                         names: list[str],
                         pmls: list[np.ndarray], cids: list[np.ndarray]) -> None:
    _write_binary_one(pml_path, names, pmls)
    _write_binary_one(cid_path, names, cids)


class RecordLayout(NamedTuple):
    """Where a batch's records lie in a file's buffer (the same in both
    files): record i spans bytes offsets[i]:offsets[i + 1], and runs[j]:
    runs[j + 1] is the j-th run of consecutive records of one shape
    (name bytes and value count), filled as one block of rows."""
    offsets: np.ndarray       # (B + 1,) int64
    runs: np.ndarray          # (blocks + 1,) int64: first records, then B
    names: np.ndarray         # uint8: the names' UTF-8 bytes, joined
    name_offsets: np.ndarray  # (B + 1,) int64 into `names`
    lens: np.ndarray          # (B,) int64: the values a record

    @property
    def blocks(self) -> int:
        return self.runs.size - 1


def record_layout(names: list[str], lens: np.ndarray) -> RecordLayout:
    """Lay out the records of reads `names` with `lens` values each."""
    enc = list(map(str.encode, names))
    name_lens = np.fromiter(map(len, enc), dtype=np.int64, count=len(enc))
    lens = np.asarray(lens, dtype=np.int64)
    if lens.shape != name_lens.shape:
        raise ValueError(f"{name_lens.size} names for {lens.size} lengths")
    if name_lens.size and int(name_lens.max()) > 0xFFFF:
        raise ValueError("a read name is longer than 65535 bytes")
    B = name_lens.size
    offsets = np.zeros(B + 1, dtype=np.int64)
    np.cumsum(10 + name_lens + 2 * lens, out=offsets[1:])
    name_offsets = np.zeros(B + 1, dtype=np.int64)
    np.cumsum(name_lens, out=name_offsets[1:])
    cuts = np.flatnonzero((np.diff(name_lens) != 0) | (np.diff(lens) != 0))
    runs = np.concatenate([[0], cuts + 1, [B]]) if B else np.zeros(1, np.int64)
    return RecordLayout(offsets, runs.astype(np.int64),
                        np.frombuffer(b"".join(enc), dtype=np.uint8),
                        name_offsets, lens)


def as_u16_plane(plane: np.ndarray) -> np.ndarray:
    """A plane's values as the binary files store them: little-endian
    uint16, C-contiguous, clipped to 0..65535 unless already uint16 (no
    copy then)."""
    plane = np.asarray(plane)
    if plane.dtype != np.uint16:
        plane = np.clip(plane, 0, 0xFFFF)
    return np.ascontiguousarray(plane, dtype="<u2")


def fill_records(layout: RecordLayout, pml: np.ndarray, cid: np.ndarray
                 ) -> tuple[np.ndarray, np.ndarray]:
    """Both files' bytes (uint8) for a batch whose reads' values sit
    right-aligned in the rows of the (B, W) planes `pml` and `cid`
    (clipped to 0..65535 unless they are uint16).  A run of records of one
    shape is a (rows, record size) block of the buffer, filled by a slice
    assignment a field: the header fields once, then copied whole into the
    CID buffer, then the values of each plane."""
    pml, cid = as_u16_plane(pml), as_u16_plane(cid)
    B = layout.lens.size
    if pml.ndim != 2 or pml.shape[0] != B or cid.shape != pml.shape:
        raise ValueError(f"planes {pml.shape} and {cid.shape} for {B} reads")
    W = pml.shape[1]
    if B and int(layout.lens.max()) > W:
        raise ValueError(f"a read of {int(layout.lens.max())} values in "
                         f"planes {W} wide")
    a, b = layout.runs[:-1], layout.runs[1:]
    nl = layout.name_offsets[a + 1] - layout.name_offsets[a]
    blocks = list(zip(layout.offsets[a].tolist(), layout.offsets[b].tolist(),
                      a.tolist(), b.tolist(), nl.tolist(),
                      layout.lens[a].tolist(),
                      layout.name_offsets[a].tolist(),
                      layout.name_offsets[b].tolist()))
    out_p = np.empty(int(layout.offsets[-1]), dtype=np.uint8)
    for o0, o1, r0, r1, k, m, n0, n1 in blocks:
        blk = out_p[o0:o1].reshape(r1 - r0, 10 + k + 2 * m)
        blk[:, 0:2] = np.frombuffer(struct.pack("<H", k), dtype=np.uint8)
        blk[:, 2:2 + k] = layout.names[n0:n1].reshape(r1 - r0, k)
        blk[:, 2 + k:10 + k] = np.frombuffer(struct.pack("<Q", m),
                                             dtype=np.uint8)
    out_c = out_p.copy()
    for o0, o1, r0, r1, k, m, _, _ in blocks:
        if not m:
            continue
        R = 10 + k + 2 * m
        out_p[o0:o1].reshape(r1 - r0, R)[:, 10 + k:] = \
            pml[r0:r1, W - m:].view(np.uint8)
        out_c[o0:o1].reshape(r1 - r0, R)[:, 10 + k:] = \
            cid[r0:r1, W - m:].view(np.uint8)
    return out_p, out_c


class PmlCidBinaryWriter:
    """Incremental writer for the .split.pml.bin/.split.cid.bin pair —
    byte-identical to write_pml_cid_binary, but records append as batches
    finish, so 100M-read streaming runs hold no outputs in memory
    (the reference streams one read at a time, src/pml_query.cpp:73-86):
    `append` from per-read arrays, a record at a time, and `append_planes`
    from a batch's output planes, a write a file."""

    def __init__(self, pml_path: str | Path, cid_path: str | Path):
        self._pml = Path(pml_path).open("wb")
        self._cid = Path(cid_path).open("wb")
        self.records = 0

    def append(self, names: list[str], pmls: list[np.ndarray],
               cids: list[np.ndarray]) -> None:
        for name, p, c in zip(names, pmls, cids):
            self._pml.write(_record_bytes(name, p))
            self._cid.write(_record_bytes(name, c))
            self.records += 1

    def append_planes(self, layout: RecordLayout, pml: np.ndarray,
                      cid: np.ndarray) -> None:
        """Append a batch from its output planes (`fill_records`): one
        write a file."""
        out_p, out_c = fill_records(layout, pml, cid)
        self._pml.write(out_p)
        self._cid.write(out_c)
        self.records += layout.lens.size

    def close(self) -> None:
        self._pml.close()
        self._cid.close()

    def __enter__(self) -> "PmlCidBinaryWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def read_pml_cid_binary(path: str | Path) -> tuple[list[str], list[np.ndarray]]:
    names: list[str] = []
    arrays: list[np.ndarray] = []
    raw = Path(path).read_bytes()
    off = 0
    while off < len(raw):
        (name_len,) = struct.unpack_from("<H", raw, off)
        off += 2
        names.append(raw[off:off + name_len].decode())
        off += name_len
        (m,) = struct.unpack_from("<Q", raw, off)
        off += 8
        arrays.append(np.frombuffer(raw, dtype="<u2", count=m, offset=off).copy())
        off += 2 * m
    return names, arrays
