"""Logging, timing and the device-memory peak — the port's copy of
colbwt_tpu/utils/log.py.

Behavioral equivalent of the reference's console layer
(include/common/common.hpp:92-205: message/submessage/error, verbose-only
log/status pairs, Timer) rebuilt on Python logging, plus the CUDA
allocator's peak in place of malloc_count's mem_peak
(include/common/common.hpp:118-120).  The JAX package's compilation cache
has no counterpart here: the CUDA kernels are built once per source hash
(ops/_kernels.py).
"""

from __future__ import annotations

import contextlib
import logging
import sys
import time

import torch

_FMT = "[%(levelname)s] %(name)s: %(message)s"


def get_logger(name: str = "colbwt", verbose: bool | None = None) -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(logging.Formatter(_FMT))
        logger.addHandler(h)
        logger.setLevel(logging.INFO)
    if verbose is not None:
        logger.setLevel(logging.DEBUG if verbose else logging.INFO)
    return logger


class Timer:
    """Wall-clock stage timer (reference Timer, include/common/common.hpp:129-174)."""

    def __init__(self) -> None:
        self._start = 0.0
        self._mid = 0.0
        self._end = 0.0

    def start(self) -> "Timer":
        self._start = time.perf_counter()
        return self

    def mid(self) -> None:
        self._mid = time.perf_counter()

    def end(self) -> None:
        self._end = time.perf_counter()

    @property
    def start_duration(self) -> float:
        return self._end - self._start

    @property
    def mid_duration(self) -> float:
        return self._end - self._mid


@contextlib.contextmanager
def status(msg: str, logger: logging.Logger | None = None):
    """Phase timing context: logs "<msg>... DONE (Xs)" at DEBUG level.

    Equivalent of the status()/status() bracket pair at
    include/common/common.hpp:193-205.
    """
    logger = logger or get_logger()
    logger.debug("%s...", msg)
    t0 = time.perf_counter()
    yield
    logger.debug("%s DONE (%.3fs)", msg, time.perf_counter() - t0)


def device_mem_peak(device: torch.device) -> int | None:
    """Peak bytes the CUDA allocator has held on `device` since the last
    `torch.cuda.reset_peak_memory_stats`; None on the CPU."""
    if device.type != "cuda":
        return None
    return int(torch.cuda.max_memory_allocated(device))
