"""The index and its positional tables as PyTorch tensors.

`index_tensors` is the counterpart of colbwt_tpu/ops/query_xla.py:39
`index_device_arrays`; on a CUDA device it also holds the compact
engine's kernel tables (`compact_tables`: `compact_rows`, `jump_pairs`).
`pos_tables_from_numpy` / `pos_tables_to_numpy` and
`mega_table_from_numpy` / `mega_table_to_numpy` convert between the
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
# the run row's columns (`compact_rows`) that are fields of the index
ROW_FIELDS = {"char": 0, "col_id": 1, "dest_interval": 2, "dest_offset": 3,
              "length": 5, "threshold": 7}


def wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 values wrapped to int32, as int32 sums wrap."""
    return (((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)).to(torch.int32)


def to_device(a, device: torch.device, dtype=np.int32) -> torch.Tensor:
    """A host array as a contiguous tensor on `device` (a read-only array,
    such as a view of a JAX array, is copied first)."""
    arr = np.ascontiguousarray(a, dtype=dtype)
    if not arr.flags.writeable:
        arr = arr.copy()
    return torch.from_numpy(arr).to(device)


def compact_rows(tb: dict) -> torch.Tensor:
    """The compact engine's run rows, (r, 8) int32, one a run j: char,
    col_id, dest_interval, dest_offset, dest_head =
    idx[clip(dest_interval)] + dest_offset wrapped to int32, length,
    length[clip(dest_interval)] (the first fast-forward round's length)
    and threshold, from the fields of `tb` (ops/query_fused.py fused_rows's
    run row, columns 0-6, with the threshold in column 7)."""
    r = tb["idx"].shape[0]
    dest = tb["dest_interval"].long().clamp(0, r - 1)
    head = wrap32(tb["idx"].long()[dest] + tb["dest_offset"].long())
    return torch.stack([tb["char"], tb["col_id"], tb["dest_interval"],
                        tb["dest_offset"], head, tb["length"],
                        tb["length"][dest], tb["threshold"]], 1).contiguous()


def jump_pairs(succ: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
    """The (sigma+1, r) jump tables as ((sigma+1)*r, 2) int32 [succ, pred]
    pairs, the pair of (c, run j) at c*r + j (parallel/mesh.py's layout)."""
    return torch.stack([succ.reshape(-1), pred.reshape(-1)], 1).contiguous()


def compact_tables(index: ColPmlIndex, device: torch.device) -> dict:
    """The index fields and the compact engine kernel's tables on
    `device`: "rows" (`compact_rows`) and "pairs" (`jump_pairs`), built by
    PyTorch ops on the host and uploaded once, with the plain version's
    fields as views of them (the jumps of "pairs", the row fields of
    "rows"; idx apart), so the device holds each value once."""
    host = {f: to_device(getattr(index, f), torch.device("cpu"))
            for f in SOA_FIELDS}
    rows = compact_rows(host).to(device)
    pairs = jump_pairs(host["succ_jump"], host["pred_jump"]).to(device)
    shape = host["succ_jump"].shape
    tb = {"rows": rows, "pairs": pairs, "idx": host["idx"].to(device),
          "succ_jump": pairs[:, 0].view(shape),
          "pred_jump": pairs[:, 1].view(shape)}
    tb.update({f: rows[:, j] for f, j in ROW_FIELDS.items()})
    return tb


def index_tensors(index: ColPmlIndex, device: torch.device) -> dict:
    """The index fields as int32 tensors on `device`, plus n and r; on a
    CUDA device as `compact_tables` holds them, with the kernel's tables."""
    if index.wide:
        raise ValueError("n >= 2**31: int32 positions would overflow — "
                         "use ops.query_mega_wide")
    device = torch.device(device)
    if device.type == "cuda":
        tb = compact_tables(index, device)
    else:
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
