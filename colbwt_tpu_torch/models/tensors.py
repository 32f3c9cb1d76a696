"""The index and its positional tables as PyTorch tensors.

`index_tensors` is the counterpart of colbwt_tpu/ops/query_xla.py:39
`index_device_arrays`.  `pos_tables_from_numpy` / `pos_tables_to_numpy`
and `mega_table_from_numpy` / `mega_table_to_numpy` convert between the
JAX package's `build_pos_tables` and `build_mega_table(_wide)` dicts and the
port's (arrays go through `np.asarray`, so JAX arrays are accepted as they
are), which lets tests feed tables built by one package into the other's
scan.
"""

from __future__ import annotations

import numpy as np
import torch

from colbwt_tpu_torch.models.index import ColPmlIndex

SOA_FIELDS = ("char", "idx", "length", "dest_interval", "dest_offset",
              "col_id", "threshold", "pred_jump", "succ_jump")


def to_device(a, device: torch.device, dtype=np.int32) -> torch.Tensor:
    """A host array as a contiguous tensor on `device` (a read-only array,
    such as a view of a JAX array, is copied first)."""
    arr = np.ascontiguousarray(a, dtype=dtype)
    if not arr.flags.writeable:
        arr = arr.copy()
    return torch.from_numpy(arr).to(device)


def index_tensors(index: ColPmlIndex, device: torch.device) -> dict:
    """The index fields as int32 tensors on `device`, plus n and r."""
    if index.wide:
        raise ValueError("n >= 2**31: int32 positions would overflow — "
                         "use ops.query_mega_wide")
    tb = {f: to_device(getattr(index, f), device) for f in SOA_FIELDS}
    tb["n"] = int(index.n)
    tb["r"] = int(index.r)
    return tb


def pos_tables_from_numpy(pt: dict, device: torch.device) -> dict:
    """A `build_pos_tables` dict (JAX or numpy arrays) as the port's."""
    out = dict(pt)
    out["table"] = to_device(np.asarray(pt["table"]), device)
    out["t1"] = (None if pt["t1"] is None
                 else to_device(np.asarray(pt["t1"]), device))
    out["n"] = int(np.asarray(pt["n"]))
    out["digit_of_dense"] = np.asarray(pt["digit_of_dense"])
    return out


def pos_tables_to_numpy(pt: dict) -> dict:
    """The port's pos-table dict with numpy arrays in place of tensors."""
    out = dict(pt)
    out["table"] = pt["table"].cpu().numpy()
    out["t1"] = None if pt["t1"] is None else pt["t1"].cpu().numpy()
    return out


def mega_table_from_numpy(mt: dict, device: torch.device) -> dict:
    """A `build_mega_table` / `build_mega_table_wide` dict (JAX or numpy
    arrays) as the port's: arrays become int32 tensors on `device`,
    scalars Python ints."""
    out = {}
    for key, v in mt.items():
        arr = np.asarray(v)
        out[key] = int(arr) if arr.ndim == 0 else to_device(arr, device)
    return out


def mega_table_to_numpy(mt: dict) -> dict:
    """The port's mega-table dict with numpy arrays in place of tensors."""
    return {key: v.cpu().numpy() if isinstance(v, torch.Tensor) else v
            for key, v in mt.items()}
