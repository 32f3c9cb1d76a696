"""Device-memory and host-RAM budgets (counterpart of colbwt_tpu/utils/hbm.py).

The positional-automaton tables are sized against a device byte budget
(ColBwtConfig.pos_hbm_budget).  The default (0) takes a fixed share of the
card's memory; on the CPU it is the JAX package's 10 GB fallback, so CPU
runs pick the same table depth k as the JAX package does there.
"""

from __future__ import annotations

import torch

from colbwt_tpu_torch.utils.device import resolve_device

_FALLBACK = 10 << 30
_RESERVE_FRACTION = 0.75  # leave room for batches, outputs and temps


def resolve_pos_budget(configured: int, device=None) -> int:
    """Effective pos-table budget: the configured value when positive, else
    _RESERVE_FRACTION of the CUDA device's memory, else (CPU) 10 GB."""
    if configured > 0:
        return configured
    dev = resolve_device(device)
    if dev.type != "cuda":
        return _FALLBACK
    total = torch.cuda.get_device_properties(dev).total_memory
    return int(total * _RESERVE_FRACTION)


def host_ram_bytes() -> int | None:
    """Total host RAM from /proc/meminfo (None when unreadable)."""
    try:
        with open("/proc/meminfo") as fh:
            for line in fh:
                if line.startswith("MemTotal:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return None


# monolithic SA-IS + Kasai working set (colbwt_tpu/utils/hbm.py:74-75)
_SA_BYTES_PER_CHAR = 40


def resolve_sa_budget_chars(configured: int) -> int:
    """Character budget for monolithic host suffix-array construction: the
    configured value when positive, else 60% of host RAM / 40 B per char."""
    if configured > 0:
        return configured
    total = host_ram_bytes()
    if total is None:
        return 1 << 30
    return int(total * 0.6) // _SA_BYTES_PER_CHAR
