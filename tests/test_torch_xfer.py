"""The chunked upload (utils/xfer.py) on the CPU: with chunks far smaller
than the array, the destination equals the source for 1-D, 2-D and
memory-mapped arrays and under a dtype cast; the CPU takes the plain
version.  K14 itself is checked on the card (tests/test_torch_kernels.py).
"""

import numpy as np
import pytest
import torch

from colbwt_tpu_torch.ops import _kernels as K
from colbwt_tpu_torch.utils.xfer import upload_chunked, upload_chunked_ref


def _array(kind: str) -> np.ndarray:
    rng = np.random.default_rng(0x14)
    if kind == "1d":
        return rng.integers(-2**31, 2**31 - 1, 10_007).astype(np.int32)
    if kind == "2d":
        return rng.integers(-2**31, 2**31 - 1, (1_003, 8)).astype(np.int32)
    return rng.integers(0, 255, (517, 3)).astype(np.uint8)


@pytest.mark.parametrize("kind", ["1d", "2d", "u8-rows"])
@pytest.mark.parametrize("memmap", [False, True], ids=["array", "memmap"])
@pytest.mark.parametrize("chunk", [1, 100, 4096, 1 << 24])
def test_upload_equals_source(tmp_path, kind, memmap, chunk):
    a = _array(kind)
    src = a
    if memmap:
        np.save(tmp_path / "a.npy", a)
        src = np.load(tmp_path / "a.npy", mmap_mode="r")
    before = dict(K.launches)
    got = upload_chunked(src, "cpu", chunk_bytes=chunk)
    assert dict(K.launches) == before  # no kernel on the CPU
    assert got.dtype == torch.from_numpy(a).dtype and got.shape == a.shape
    np.testing.assert_array_equal(got.numpy(), a)


@pytest.mark.parametrize("memmap", [False, True], ids=["array", "memmap"])
def test_upload_casts_dtype(tmp_path, memmap):
    a = np.arange(-500, 500, dtype=np.int64).reshape(250, 4)
    src = a
    if memmap:
        np.save(tmp_path / "a.npy", a)
        src = np.load(tmp_path / "a.npy", mmap_mode="r")
    got = upload_chunked(src, "cpu", chunk_bytes=48, dtype=np.int32)
    assert got.dtype == torch.int32 and got.shape == (250, 4)
    np.testing.assert_array_equal(got.numpy(), a.astype(np.int32))
    np.testing.assert_array_equal(
        upload_chunked_ref(src, "cpu", chunk_bytes=48, dtype=np.uint8).numpy(),
        a.astype(np.uint8))


def test_upload_non_contiguous_and_scalar():
    a = _array("2d")[:, ::2]
    np.testing.assert_array_equal(
        upload_chunked(a, "cpu", chunk_bytes=64).numpy(), a)
    s = upload_chunked(np.int32(7), "cpu")
    assert s.shape == () and int(s) == 7


def test_upload_to_cuda_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        upload_chunked(_array("1d"), "cuda")
