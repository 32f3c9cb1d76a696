"""Multi-process orchestration — port of colbwt_tpu/parallel/distributed.py.

Topology: torch.distributed, one process a device, and a dp×ip mesh over
the ranks (parallel/mesh.make_mesh).  Read batches split by process: each
process owns the contiguous slice [pid * ceil(R / P), ...) of the input
FASTA's reads, writes its own part files, and rank 0 concatenates them in
read order after a barrier — the output does not depend on the process
count.

Runs unchanged single-process (P = 1).  `shutdown_distributed` ends a
run: it closes the meshes, whose process groups would otherwise outlive
`destroy_process_group` into interpreter exit.

ASSUMPTION: the part-file merge needs a filesystem every process sees.
Without one, point each process's pattern_file at local scratch and
concatenate the part files out of band: the record format is
self-delimiting, so plain byte concatenation in process order is the merge.
"""

from __future__ import annotations

import gc
import os
from pathlib import Path

import torch
import torch.distributed as dist

from colbwt_tpu_torch.utils.device import resolve_device
from colbwt_tpu_torch.utils.log import get_logger


def _rank_world() -> tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def init_distributed(device=None) -> tuple[int, int]:
    """Initialise torch.distributed from torchrun's environment (RANK,
    WORLD_SIZE, MASTER_ADDR, MASTER_PORT; LOCAL_RANK picks the card) when
    WORLD_SIZE > 1.  `device` (default cuda) chooses the backend: NCCL for
    cuda, gloo for cpu.

    Returns (rank, world), or (0, 1) with no group."""
    if dist.is_available() and dist.is_initialized():
        return _rank_world()
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        return 0, 1
    dev = resolve_device(device)
    rank = int(os.environ["RANK"])
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank))
                              % torch.cuda.device_count())
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo",
        init_method=(f"tcp://{os.environ['MASTER_ADDR']}:"
                     f"{os.environ['MASTER_PORT']}"),
        rank=rank, world_size=world)
    return rank, world


def shutdown_distributed(*meshes) -> None:
    """The end of a distributed run, `init_distributed`'s counterpart: a
    barrier (no rank tears down while another still has collectives in
    flight), then `meshes` closed and the process groups destroyed.

    A mesh over the ranks holds its dp and ip process groups, and their
    gloo or NCCL worker threads, for as long as it is referenced, past
    `destroy_process_group`; left to interpreter exit, those threads are
    torn down in no set order and can abort the process ("terminate called
    without an active exception").  Closing the meshes first ends them
    here.  Without a group, only the meshes are closed."""
    if dist.is_available() and dist.is_initialized():
        dist.barrier()
    for mesh in meshes:
        mesh.close()
    gc.collect()  # a device mesh may sit in a reference cycle
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def host_read_slice(num_reads: int, pid: int, nproc: int) -> tuple[int, int]:
    """Contiguous per-process slice [lo, hi) of the global read list."""
    per = -(-num_reads // nproc)
    lo = min(pid * per, num_reads)
    return lo, min(lo + per, num_reads)


def merge_part_files(out_path: str | Path, part_paths: list[str | Path],
                     bufsize: int = 32 << 20) -> None:
    """Order-preserving concatenation of per-process binary record files
    (the record format is self-delimiting, io/pml_out.py), streamed in
    bounded buffers."""
    with Path(out_path).open("wb") as out:
        for p in part_paths:
            with Path(p).open("rb") as fh:
                while True:
                    chunk = fh.read(bufsize)
                    if not chunk:
                        break
                    out.write(chunk)


def distributed_query(index, pattern_file: str, names: list[str],
                      reads: list[bytes], query_fn) -> tuple[list, list, list]:
    """Per-process slice → local query → part files → rank-0 merge.

    query_fn(reads_slice) -> (pmls, cids).  Returns this process's (names,
    pmls, cids) slice; rank 0 also writes the merged
    PATTERN.split.pml.bin / .split.cid.bin."""
    from colbwt_tpu_torch.io.pml_out import write_pml_cid_binary

    logger = get_logger("colbwt_torch.dist")
    pid, nproc = _rank_world()
    lo, hi = host_read_slice(len(reads), pid, nproc)
    logger.info("process %d/%d: reads [%d, %d)", pid, nproc, lo, hi)

    local_names = names[lo:hi]
    pmls, cids = query_fn(reads[lo:hi])

    pml_part = f"{pattern_file}.split.pml.bin.part{pid}"
    cid_part = f"{pattern_file}.split.cid.bin.part{pid}"
    write_pml_cid_binary(pml_part, cid_part, local_names, pmls, cids)

    # every process's parts are written before rank 0 merges them
    if nproc > 1:
        dist.barrier()
    if pid == 0:
        parts_pml = [f"{pattern_file}.split.pml.bin.part{p}"
                     for p in range(nproc)]
        parts_cid = [f"{pattern_file}.split.cid.bin.part{p}"
                     for p in range(nproc)]
        merge_part_files(f"{pattern_file}.split.pml.bin", parts_pml)
        merge_part_files(f"{pattern_file}.split.cid.bin", parts_cid)
        for p in parts_pml + parts_cid:
            Path(p).unlink(missing_ok=True)
    return local_names, pmls, cids
