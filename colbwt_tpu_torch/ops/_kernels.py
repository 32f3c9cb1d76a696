"""Build and bind the hand-written CUDA kernels (csrc/*.cu).

The sources compile with nvcc, one process per source side by side, into
one shared library with a plain C interface, loaded with ctypes: no
PyTorch headers, so a cold build takes seconds.  The library is built at
first use into build/colbwt_kernels/ at the checkout root, named by a
hash of the sources, the headers they include (csrc/*.cuh) and the
flags, so an edited source is rebuilt and an unchanged one is reused.

The wrappers call an entry point through `on(device)`, which makes the
tensors' card the current device for the launch; a kernel launched many
times on the same tensors (the sharded per-step routes) goes through a
`Launcher`, bound once.  Every C entry point
returns cudaGetLastError(); `check` raises on a nonzero code.  `launches`
counts kernel launches per wrapper name (the wrappers in ops/query_pos.py,
ops/query_xla.py, ops/query_mega.py, ops/query_mega_wide.py,
ops/query_fused.py, ops/construct.py (the multi-MUM scan, the suffix
array, LCP and thresholds), ops/colsplit.py, utils/xfer.py and the sharded
engines of parallel/ add one where they launch, and nowhere else), so a
run can show which kernels its path went through.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from collections import Counter
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "colbwt_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xcompiler", "-pthread"]

KERNELS = ("build_t1_chunk", "compose_tables", "query_chunk_pos",
           "query_batch_xla", "query_chunk_mega", "query_chunk_mega_wide",
           "fill_block_wide", "shared_table_wide", "query_batch_fused",
           "mum_window", "mum_window_two_pass", "tunneled_walk", "all_walk",
           "upload_rows", "doubling_round", "lcp_lift", "segmented_argmin",
           "sharded_fetch", "compose_sharded_tk", "sharded_step_pos",
           "sharded_step_mega", "sharded_step_compact", "sharded_scan_mega",
           "sharded_scan_compact", "sharded_scan_pos")
launches: Counter = Counter()

_P = ctypes.c_void_p
_I = ctypes.c_int64
_SIGNATURES = {
    "colbwt_build_t1_chunk": [_P] * 9 + [_I] * 6 + [_P],
    "colbwt_compose_tables": [_P] * 3 + [_I] * 5 + [_P],
    "colbwt_query_chunk_pos": ([_P, _I, _I, _P, _I, _P, _P, _P] + [_I] * 8
                               + [_P] * 4 + [_P]),
    "colbwt_query_batch_xla": [_P] * 2 + [_I] * 3 + [_P] * 2 + [_I] * 3
                              + [_P] * 2 + [_P],
    "colbwt_query_chunk_mega": ([_P, _I, _P, _I, _I, _P, _P] + [_P] * 4
                                + [_I] * 6 + [_P] * 6 + [_P]),
    "colbwt_query_chunk_mega_wide": ([_I, _P, _I, _P, _P, _I, _I, _P, _P]
                                     + [_P] * 5 + [_I] * 6 + [_P] * 7
                                     + [_P]),
    "colbwt_fill_block_wide": [_P, _I, _I, _I] + [_P] * 11 + [_I] * 4 + [_P],
    "colbwt_shared_table_wide": [_P] * 8 + [_I] + [_P],
    "colbwt_query_batch_fused": [_P] * 3 + [_I] * 3 + [_P] * 2 + [_I] * 3
                                + [_P] * 2 + [_P],
    "colbwt_upload_rows": [_P, _P, _I, _I, _P],
    "colbwt_host_stage": [_P, _I, _I],
    "colbwt_upload_threads": [],
    "colbwt_mum_window": [_P, _P, _I, _P] + [_I] * 4 + [_P] * 2 + [_P],
    "colbwt_mum_window_two_pass": ([_P, _P, _I, _P] + [_I] * 4
                                   + [_P, _I, _P, _P] + [_P]),
    "colbwt_tunneled_walk": [_P] * 2 + [_I] + [_P] * 2 + [_I] * 4 + [_P] * 2
                            + [_P],
    "colbwt_all_walk": [_P] * 2 + [_I] + [_P] * 2 + [_I] * 4 + [_P] * 3
                       + [_P],
    "colbwt_doubling_round": ([_P] + [_I] * 3 + [_P] * 6 + [_I] * 2
                              + [_P] * 3 + [_P]),
    "colbwt_lcp_lift": [_P] * 3 + [_I] * 2 + [_P] * 3,
    "colbwt_segmented_argmin": [_P, _I, _P, _P, _I] + [_P] * 3 + [_P],
    "colbwt_sharded_fetch": [_P, _I, _I, _I, _P, _P, _I, _I, _P, _P],
    "colbwt_compose_sharded_tk": [_P] + [_I] * 6 + [_P, _P],
    # a parameter block prepared once, then the step (and round, last)
    "colbwt_sharded_step_pos": [_P, _I],
    "colbwt_sharded_step_mega": [_P, _I],
    "colbwt_sharded_step_compact": [_P, _I, _I, _I],
    "colbwt_sharded_scan_mega": ([_I, _P, _I, _I, _P, _I, _I] + [_P] * 7
                                 + [_I] * 4 + [_P] * 3),
    "colbwt_sharded_scan_compact": ([_P, _P, _I, _I] + [_P] * 6 + [_I] * 5
                                    + [_P] * 3),
    "colbwt_sharded_scan_pos": [_P, _I, _I, _P] + [_I] * 5 + [_P, _P],
}


def reset_launches() -> None:
    launches.clear()
    for name in KERNELS:
        launches[name] = 0


reset_launches()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([str(Path(home) / "bin" / "nvcc")] if home else []) + [
            shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]:
        if cand and Path(cand).exists():
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "are built from colbwt_tpu_torch/csrc at first use")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _headers() -> list[Path]:
    return sorted(CSRC.glob("*.cuh"))


def _run_all(cmds: list[list[str]]) -> list[str]:
    """Run the commands side by side; raises with the first failure's
    output once all have ended, else returns each command's stderr."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for c in cmds]
    outs = [p.communicate() for p in procs]
    for cmd, p, (_, err) in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}):\n"
                               f"{' '.join(cmd)}\n{err}")
    return [err for _, err in outs]


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources() + _headers():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libcolbwt_kernels_{h.hexdigest()[:16]}.so"


@functools.cache
def load() -> ctypes.CDLL:
    """Build (when absent) and load the kernel library; raises when CUDA or
    nvcc is missing or the build fails.  Never falls back."""
    if not torch.cuda.is_available():
        raise RuntimeError("the CUDA kernels need a CUDA device")
    lib_path = library_path()
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # build in a private directory, then rename: a concurrent process
        # never loads a half-written library
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            nvcc = _nvcc()
            objs = [str(Path(tmp) / f"{src.stem}.o") for src in _sources()]
            # one nvcc per source, all started together, then the link
            _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
                      for obj, src in zip(objs, _sources())])
            so = str(Path(tmp) / "lib.so")
            _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", so, *objs]])
            os.replace(so, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


class _OnDevice:
    """The library's entry points, each called with `device` the current
    CUDA device: a launch into a stream of another card than the current
    one fails or reads the wrong card's memory."""

    def __init__(self, device: torch.device):
        self._device = device

    def __getattr__(self, name: str):
        fn = getattr(load(), name)

        def call(*args):
            with torch.cuda.device(self._device):
                return fn(*args)
        return call


def on(device: torch.device) -> _OnDevice:
    """The kernel library, its launches made on `device`."""
    return _OnDevice(device)


class Launcher:
    """One entry point bound for repeated launches on `device`: the
    arguments `fixed` (ints, the address of a parameter block among them)
    are kept, and a call passes them and what changes from launch to
    launch (`per_call`), raises on a nonzero code and counts one launch of
    `kernel`.  The caller validates the tensors once, when it makes the
    launcher; `keep` holds what `fixed` points to (a ctypes block) alive.
    `lib` is the library to bind (default: the port's)."""

    def __init__(self, device: torch.device, entry: str, kernel: str,
                 *fixed, lib: ctypes.CDLL | None = None, keep=None):
        self._fn = getattr(lib or load(), entry)
        self._fixed = fixed
        self._keep = keep
        self._index = (device.index if device.index is not None
                       else torch.cuda.current_device())
        self._kernel = kernel

    def __call__(self, *per_call) -> None:
        if torch.cuda.current_device() == self._index:
            code = self._fn(*self._fixed, *per_call)
        else:
            with torch.cuda.device(self._index):
                code = self._fn(*self._fixed, *per_call)
        check(self._kernel, code)
        launches[self._kernel] += 1


def block_fields(*spec: tuple[str, str]) -> list:
    """A parameter block's ctypes fields, field for field with its C
    struct: (name, "p") a pointer, (name, "i") an int64."""
    return [(name, ctypes.c_void_p if kind == "p" else ctypes.c_int64)
            for name, kind in spec]


class BatchLauncher:
    """A kernel's launcher for one batch over a parameter block made once.
    A subclass checks its arguments once in its constructor (device,
    dtype, shape, ...) and passes them on as `fixed`; it names the C
    `entry`, the `kernel` its launches count under, `params` (the ctypes
    block of `fixed`, unchecked) and `ref` (the plain version, called
    with `args(*call)`), and checks each call in `check_call`.  A call
    launches the kernel with the block and `per_call(*call)`, or runs the
    plain version on the CPU; a batch of no lanes launches nothing.  The
    tensors are rewritten in place between calls, never replaced."""

    entry = kernel = ""

    def __init__(self, device: torch.device, fixed: tuple, lanes: int):
        self._fixed = fixed
        self._plain = device.type == "cpu"
        self._launch = None
        if not self._plain and lanes:
            block = self.params(*fixed)
            self._launch = Launcher(device, self.entry, self.kernel,
                                    ctypes.addressof(block), keep=block)

    def args(self, *call) -> tuple:
        """The public per-call wrapper's arguments for this call."""
        raise NotImplementedError

    def check_call(self, *call) -> None:
        """Raise on a call outside the batch."""

    def per_call(self, *call) -> tuple:
        """The entry point's arguments after the block."""
        return call

    def __call__(self, *call) -> None:
        self.check_call(*call)
        if self._plain:
            self.ref(*self.args(*call))
        elif self._launch is not None:
            self._launch(*self.per_call(*call))


def check(name: str, code: int) -> None:
    if code != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {code}")


def stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def require(t: torch.Tensor, name: str, dtype: torch.dtype,
            device: torch.device) -> None:
    """Validate a kernel argument: device, dtype and contiguity."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def require_aligned(t: torch.Tensor, name: str, nbytes: int) -> None:
    """A table the kernel reads with nbytes-wide vector loads."""
    if t.data_ptr() % nbytes:
        raise ValueError(f"{name} must be {nbytes}-byte aligned")
