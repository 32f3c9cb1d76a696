"""Memmap-fed, resumable driver of the chunked multi-MUM scan — port of
colbwt_tpu/ops/mum_scan_stream.py.

The scan's three n-sized inputs live on disk as .npy files (lcp int32, the
per-rank document id, the run-change marks bit-packed by
`write_run_change_bits`) and are sliced one chunk at a time, so the
scanning process stays O(chunk) resident at any n.
The scan runs in this process, chunk by chunk through
ops/construct.find_multi_mums_chunked (kernel K8).  After every chunk the
hits so far are saved to a progress file (temp name, then rename), so a
killed build resumes after the last finished chunk.  The progress file
records the scan it belongs to, (n, N, min_mum, C): one written for another
collection, document count, minimum length or chunk size is ignored.
`write_run_change_bits` and `extract_npz_member`, which write two of those
inputs, are copied from the JAX module as they are.
"""

from __future__ import annotations

import shutil
import zipfile
from pathlib import Path

import numpy as np

from colbwt_tpu_torch.ops import construct as TC
from colbwt_tpu_torch.utils.config import TERMINATOR
from colbwt_tpu_torch.utils.device import resolve_device


def write_run_change_bits(heads: np.ndarray, lens: np.ndarray,
                          path: str | Path, block: int = 1 << 26) -> None:
    """Bit-packed (little-endian) equivalent of
    construct_chunked.run_change_from_runs, written blockwise: run starts
    are 1, and every position of a terminator run is 1 (terminators are
    pairwise-distinct ranks).  n/8 bytes on disk instead of n bytes in
    RAM."""
    heads = np.asarray(heads)
    lens = np.asarray(lens, dtype=np.int64)
    n = int(lens.sum())
    starts = np.zeros(heads.size, dtype=np.int64)
    if heads.size > 1:
        np.cumsum(lens[:-1], out=starts[1:])
    term = np.flatnonzero(heads == TERMINATOR)
    term_lo = starts[term]
    term_hi = term_lo + lens[term]
    assert block % 8 == 0
    path = Path(path)
    tmp = path.with_suffix(".tmp.npy")
    with open(tmp, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": "|u1", "fortran_order": False,
                "shape": ((n + 7) // 8,)})
        for bs in range(0, n, block):
            be = min(bs + block, n)
            buf = np.zeros(be - bs, dtype=np.uint8)
            i0 = int(np.searchsorted(starts, bs))
            i1 = int(np.searchsorted(starts, be))
            buf[starts[i0:i1] - bs] = 1
            j0 = int(np.searchsorted(term_hi, bs, side="right"))
            j1 = int(np.searchsorted(term_lo, be))
            for lo, hi in zip(term_lo[j0:j1], term_hi[j0:j1]):
                buf[max(int(lo) - bs, 0):int(hi) - bs] = 1
            f.write(np.packbits(buf, bitorder="little").tobytes())
    tmp.rename(path)


def extract_npz_member(npz_path: str | Path, member: str,
                       out_path: str | Path, block: int = 1 << 24) -> None:
    """Stream one member of an (uncompressed) .npz out to a standalone
    .npy file in O(block) memory — np.load would materialize the whole
    array just to re-save it."""
    out_path = Path(out_path)
    tmp = out_path.with_suffix(".tmp.npy")
    with zipfile.ZipFile(npz_path) as zf:
        with zf.open(member) as src, open(tmp, "wb") as dst:
            shutil.copyfileobj(src, dst, block)
    tmp.rename(out_path)
    np.load(out_path, mmap_mode="r")  # validate the .npy header


def _load_progress(path: Path, key: np.ndarray, log=None
                   ) -> tuple[int, list[np.ndarray], list[np.ndarray]]:
    """(next chunk, lengths, positions) saved for the scan `key`; a missing
    file or one keyed for another scan starts at chunk 0."""
    if path.exists():
        with np.load(path) as z:
            if "key" in z.files and np.array_equal(z["key"], key):
                return int(z["next_chunk"]), [z["ml"]], [z["mp"]]
        if log:
            log(f"mum-scan progress {path.name} belongs to another scan; "
                "starting from chunk 0")
    return 0, [], []


def find_multi_mums_streamed(lcp_path: str | Path, doc_path: str | Path,
                             rc_path: str | Path, num_docs: int,
                             min_mum: int, progress_path=None,
                             chunk: int = 1 << 26, log=None, device=None
                             ) -> tuple[np.ndarray, np.ndarray]:
    """The chunked scan over on-disk inputs on `device` (default cuda):
    (lengths, positions) int64 as oracle.find_multi_mums.  Resumable: the
    hits persist in `progress_path` (default mumscan_progress.npz beside
    the lcp file) across kills and reruns; the file is removed once the
    scan is complete."""
    dev = resolve_device(device)
    lcp_path = Path(lcp_path)
    progress_path = Path(progress_path or lcp_path.parent /
                         "mumscan_progress.npz")
    lcp = np.load(lcp_path, mmap_mode="r")
    docs = np.load(doc_path, mmap_mode="r")
    rc = np.load(rc_path, mmap_mode="r")
    n = int(lcp.shape[0])
    # the chunk size find_multi_mums_chunked buckets to
    C = min(chunk, 1 << max(13, (max(n, 2) - 1).bit_length()))
    n_chunks = -(-n // C)
    key = np.array([n, num_docs, min_mum, C], dtype=np.int64)
    k0, mls, mps = _load_progress(progress_path, key, log)
    if log and k0:
        log(f"mum-scan resumes at chunk {k0}/{n_chunks}")
    for k in range(k0, n_chunks):
        ml, mp = TC.find_multi_mums_chunked(
            lcp, docs, rc, num_docs, min_mum, chunk=chunk, log=log,
            run_change_packed=True, start_chunk=k, max_chunks=1, device=dev)
        mls.append(ml)
        mps.append(mp)
        tmp = progress_path.with_suffix(".tmp.npz")
        np.savez(tmp, key=key, next_chunk=k + 1, ml=np.concatenate(mls),
                 mp=np.concatenate(mps))
        tmp.rename(progress_path)
    progress_path.unlink(missing_ok=True)
    if not mls:
        z = np.empty(0, dtype=np.int64)
        return z, z.copy()
    return (np.concatenate(mls).astype(np.int64),
            np.concatenate(mps).astype(np.int64))
