"""Host-to-device upload in row slices — port of colbwt_tpu/utils/xfer.py.

`upload_chunked` allocates the destination once with `torch.empty` and fills
it slice by slice, so the device holds the destination and nothing more,
and a memory-mapped source is read one slice at a time, never copied whole
on the host (xfer.py:9-13).  On CUDA the copy is K14, `colbwt_upload_rows`
in csrc/xfer.cu (replaces xfer.py:27 `_write_rows`): the copy engine, fed
on a stream of its own by a pool of up to 8 host threads a card, each
copying its 2 MB slices into its two pinned staging buffers (32 MB a card
at most); a pinned source goes to the copy engine whole.  No SM kernel
runs.  `upload_chunked_ref` is the plain version, a pageable `copy_` of
each slice; a CPU destination takes it.
"""

from __future__ import annotations

import numpy as np
import torch

from colbwt_tpu_torch.ops import _kernels as K
from colbwt_tpu_torch.utils.device import resolve_device

CHUNK_BYTES = 16 << 20


def _prepare(arr, device, dtype) -> tuple[np.ndarray, np.dtype, torch.Tensor,
                                          int]:
    """(source as an array of >= 1 dimension, the destination's numpy
    dtype, the empty destination, bytes per destination row)."""
    a = np.atleast_1d(np.asarray(arr))
    dt = np.dtype(dtype or a.dtype)
    row = dt.itemsize * int(np.prod(a.shape[1:], dtype=np.int64))
    dst = torch.empty(a.shape, dtype=torch.from_numpy(np.empty(0, dt)).dtype,
                      device=device)
    return a, dt, dst, row


def _slices(a: np.ndarray, dt: np.dtype, row: int, chunk_bytes: int):
    """(first row, a host copy of the slice in dtype `dt`) for each slice
    of at most `chunk_bytes` (one row at least)."""
    per = max(1, chunk_bytes // max(row, 1))
    for i in range(0, a.shape[0], per):
        yield i, np.array(a[i:i + per], dtype=dt)


def upload_chunked_ref(arr, device, chunk_bytes: int = CHUNK_BYTES,
                       dtype=None) -> torch.Tensor:
    """Plain version: `dst[i:j].copy_(torch.from_numpy(part))` for each row
    slice of at most `chunk_bytes`."""
    a, dt, dst, row = _prepare(arr, device, dtype)
    for i, part in _slices(a, dt, row, chunk_bytes):
        dst[i:i + part.shape[0]].copy_(torch.from_numpy(part))
    return dst.reshape(np.shape(arr))


def upload_chunked(arr, device, chunk_bytes: int = CHUNK_BYTES,
                   dtype=None) -> torch.Tensor:
    """K14: a host array (memory-mapped or not) as a tensor on `device`,
    uploaded `chunk_bytes` at a time and cast to `dtype` when given.  The
    caller's stream waits for the copies; the call returns once the source
    has been read.  A CPU destination takes the plain version."""
    device = resolve_device(device)
    if device.type == "cpu":
        return upload_chunked_ref(arr, device, chunk_bytes, dtype)
    a, dt, dst, row = _prepare(arr, device, dtype)
    if dst.numel() == 0:
        return dst.reshape(np.shape(arr))
    if a.dtype == dt and a.flags.c_contiguous:
        parts = [(0, a)]  # one call streams the whole array
    else:  # each slice is cast (or made contiguous) on the host first
        parts = _slices(a, dt, row, chunk_bytes)
    lib = K.load()
    with torch.cuda.device(device):
        stream = K.stream_handle(device)
        for i, part in parts:
            code = lib.colbwt_upload_rows(
                part.ctypes.data, dst.data_ptr() + i * row, part.nbytes,
                chunk_bytes, stream)
            K.check("upload_rows", code)
            K.launches["upload_rows"] += 1
    return dst.reshape(np.shape(arr))
