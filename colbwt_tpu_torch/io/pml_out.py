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
"""

from __future__ import annotations

import struct
from pathlib import Path

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


class PmlCidBinaryWriter:
    """Incremental writer for the .split.pml.bin/.split.cid.bin pair —
    byte-identical to write_pml_cid_binary, but records append as batches
    finish, so 100M-read streaming runs hold no outputs in memory
    (the reference streams one read at a time, src/pml_query.cpp:73-86)."""

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
