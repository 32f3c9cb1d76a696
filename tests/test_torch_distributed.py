"""The port's multi-process orchestration (colbwt_tpu_torch/parallel/
distributed.py) and its sharded engines across processes.

The single-process cases mirror tests/test_distributed.py.  The two
2-process runs start this machine's Python twice with torchrun's
environment (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT and
TORCHELASTIC_USE_AGENT_STORE) over gloo on 127.0.0.1, the test process
hosting the rendezvous store as torchrun's agent does: dp = 2 (the part
files merged by rank 0 byte-equal to a one-process query, and every
sharded engine's dp all-gather) and ip = 2 (every sharded engine's masked
gathers summed by all_reduce over the ip group, equal to the unsharded
engines).  Each rank ends through `shutdown_distributed`, which closes
its mesh before the groups go: a mesh left open kept its groups' gloo
threads alive into interpreter exit, where a rank aborted now and then
under load.  Each process has its own timeout and is killed when it runs
over, so nothing hangs the suite.
"""

import os
import subprocess
import sys
import textwrap
from datetime import timedelta
from pathlib import Path

import numpy as np
import pytest
import torch.distributed as dist

from colbwt_tpu.models.index import ColPmlIndex
from colbwt_tpu.parallel import distributed as JD
from colbwt_tpu_torch.io.fasta import FastaRecord, write_fasta
from colbwt_tpu_torch.io.pml_out import read_pml_cid_binary
from colbwt_tpu_torch.ops import query_mega as TM
from colbwt_tpu_torch.ops import query_mega_wide as TW
from colbwt_tpu_torch.parallel import make_mesh
from colbwt_tpu_torch.parallel.distributed import (distributed_query,
                                                   host_read_slice,
                                                   init_distributed,
                                                   merge_part_files,
                                                   shutdown_distributed)
from tests.conftest import random_docs
from tests.test_query_wide import scale_table
from tests.test_query_xla import build_index, make_reads

REPO = Path(__file__).resolve().parents[1]
PROC_TIMEOUT = 120  # seconds, each process of a 2-process run


def test_host_read_slice_partitions():
    for total in (0, 1, 7, 64, 100):
        for nproc in (1, 2, 3, 8):
            slices = [host_read_slice(total, p, nproc) for p in range(nproc)]
            assert slices == [JD.host_read_slice(total, p, nproc)
                              for p in range(nproc)]
            covered = []
            for lo, hi in slices:
                covered.extend(range(lo, hi))
            assert covered == list(range(total))


def test_merge_part_files(tmp_path):
    (tmp_path / "a").write_bytes(b"AAA")
    (tmp_path / "b").write_bytes(b"BB")
    merge_part_files(tmp_path / "out", [tmp_path / "a", tmp_path / "b"])
    assert (tmp_path / "out").read_bytes() == b"AAABB"
    merge_part_files(tmp_path / "small", [tmp_path / "a", tmp_path / "b"],
                     bufsize=1)
    assert (tmp_path / "small").read_bytes() == b"AAABB"


def test_init_distributed_without_group(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert init_distributed(device="cpu") == (0, 1)
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert init_distributed(device="cpu") == (0, 1)


def test_shutdown_distributed_without_group():
    """With no process group, shutdown_distributed closes the meshes and
    nothing else; a closed mesh holds no devices."""
    mesh = make_mesh(1, 2, devices=["cpu"] * 2)
    shutdown_distributed(mesh)
    assert not dist.is_initialized()
    # no group's gloo thread is left to be torn down at interpreter exit
    tasks = Path("/proc/self/task")
    if tasks.is_dir():
        names = [(t / "comm").read_text().strip() for t in tasks.iterdir()]
        assert not any("gloo" in x for x in names), names
    assert not mesh.distributed and mesh._grid is None


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(0xD157)
    base = bytes(rng.choice(list(b"ACGT"), 200).astype("uint8"))
    docs = random_docs(rng, 2, mutate_from=base)
    tbl, _ = build_index(docs)
    index = ColPmlIndex.build(tbl, ff_bound=2)
    wide = ColPmlIndex.build(scale_table(tbl, 2**23), ff_bound=2)
    assert wide.wide
    reads = make_reads(rng, docs, 11) + [b"NNAC", b"A"]
    names = [f"r{i}" for i in range(len(reads))]
    return index, wide, reads, names


def test_distributed_query_single_process(tmp_path, case):
    """One process: the merged files hold every read's records, equal to the
    port's mega engine (pml clipped to 16 bits, the record format)."""
    index, _, reads, names = case
    pattern_file = str(tmp_path / "p.fa")

    def qfn(batch):
        return TM.query_batch(index, batch, device="cpu")

    ln, lp, lc = distributed_query(index, pattern_file, names, reads, qfn)
    assert ln == names
    got_names, got_pmls = read_pml_cid_binary(f"{pattern_file}.split.pml.bin")
    assert got_names == names
    ref_p, _ = TM.query_batch(index, reads, device="cpu")
    for a, b in zip(got_pmls, ref_p):
        np.testing.assert_array_equal(a, np.clip(b, 0, 65535))
    assert not list(tmp_path.glob("*.part*"))


WORKER = textwrap.dedent("""
    import sys
    from pathlib import Path

    import numpy as np
    import torch
    import torch.distributed as dist

    from colbwt_tpu_torch.io.fasta import read_fasta
    from colbwt_tpu_torch.models.index import ColPmlIndex
    from colbwt_tpu_torch.ops import query_mega
    from colbwt_tpu_torch.parallel import (make_mesh, query_batch_sharded,
                                           query_batch_sharded_pos)
    from colbwt_tpu_torch.parallel.distributed import (distributed_query,
                                                       init_distributed,
                                                       shutdown_distributed)
    from colbwt_tpu_torch.parallel.query_sharded_mega import (
        query_batch_sharded_mega)
    from colbwt_tpu_torch.parallel.query_sharded_mega_wide import (
        query_batch_sharded_mega_wide)

    mode, work = sys.argv[1], sys.argv[2]
    torch.set_num_threads(1)
    rank, world = init_distributed(device="cpu")
    assert (rank, world) == (dist.get_rank(), 2), (rank, world)
    assert dist.get_backend() == "gloo"
    index = ColPmlIndex.load(f"{work}/split.colpml.npz")
    wide = ColPmlIndex.load(f"{work}/wide.colpml.npz")
    recs = list(read_fasta(f"{work}/reads.fa"))
    names = [r.name for r in recs]
    reads = [r.seq for r in recs]
    if mode == "dp":
        distributed_query(index, f"{work}/dist.fa", names, reads,
                          lambda b: query_mega.query_batch(index, b,
                                                           device="cpu"))
    mesh = make_mesh(2, 1) if mode == "dp" else make_mesh(1, 2)
    assert mesh.distributed
    out = {}
    for name, fn in (
            ("compact", lambda: query_batch_sharded(index, reads, mesh=mesh)),
            ("mega", lambda: query_batch_sharded_mega(index, reads,
                                                      mesh=mesh)),
            ("pos", lambda: query_batch_sharded_pos(index, reads, mesh=mesh,
                                                    k=2)),
            ("wide", lambda: query_batch_sharded_mega_wide(wide, reads,
                                                           mesh=mesh))):
        p, c = fn()
        out[name + "_len"] = np.array([len(x) for x in p])
        out[name + "_pml"] = np.concatenate(p)
        out[name + "_cid"] = np.concatenate(c)
    np.savez(f"{work}/{mode}{rank}.npz", **out)
    shutdown_distributed(mesh)
    assert not dist.is_initialized()
    # no group's gloo thread is left to be torn down at interpreter exit
    tasks = Path("/proc/self/task")
    if tasks.is_dir():
        names = [(t / "comm").read_text().strip() for t in tasks.iterdir()]
        assert not any("gloo" in x for x in names), names
""")


def _run_two(work: Path, mode: str) -> None:
    """Start the two ranks with torchrun's environment; kill both when one
    runs over its timeout or fails; report both ranks' return codes and
    the ends of both stderrs when either fails.

    This process hosts the ranks' TCP store, as torchrun's agent does: it
    binds port 0 itself and holds the store until both ranks have exited,
    and TORCHELASTIC_USE_AGENT_STORE makes every rank a client of it.  So
    no port is picked, freed and then taken by another process before a
    rank binds it, and no rank tears the store down while the other still
    uses it (rank 0 hosted it before, and aborted at exit under load)."""
    script = work / "worker.py"
    script.write_text(WORKER)
    store = dist.TCPStore("127.0.0.1", 0, is_master=True,
                          wait_for_workers=False,
                          timeout=timedelta(seconds=PROC_TIMEOUT))
    procs = []
    errs = ["", ""]
    try:
        for rank in range(2):
            env = dict(os.environ, RANK=str(rank), LOCAL_RANK=str(rank),
                       WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
                       MASTER_PORT=str(store.port),
                       TORCHELASTIC_USE_AGENT_STORE="True",
                       OMP_NUM_THREADS="1",
                       PYTHONPATH=os.pathsep.join(
                           [str(REPO), os.environ.get("PYTHONPATH", "")]))
            procs.append(subprocess.Popen(
                [sys.executable, str(script), mode, str(work)], cwd=REPO,
                env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True))
        for rank, p in enumerate(procs):
            errs[rank] = p.communicate(timeout=PROC_TIMEOUT)[1]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
        del store
    codes = [p.returncode for p in procs]
    assert codes == [0, 0], "\n".join(
        f"rank {rank} exited with {code}:\n{err[-3000:]}"
        for rank, (code, err) in enumerate(zip(codes, errs)))


@pytest.fixture(scope="module")
def two_process_work(tmp_path_factory, case):
    index, wide, reads, names = case
    work = tmp_path_factory.mktemp("dist")
    index.save(work / "split.colpml")
    wide.save(work / "wide.colpml")
    write_fasta(work / "reads.fa",
                [FastaRecord(n, r) for n, r in zip(names, reads)])
    return work


def _ref(case):
    index, wide, reads, _ = case
    narrow = TM.query_batch(index, reads, device="cpu")
    return {"compact": narrow, "mega": narrow, "pos": narrow,
            "wide": TW.query_batch(wide, reads, device="cpu")}


def _check_ranks(work: Path, mode: str, ref: dict) -> None:
    for rank in range(2):
        got = np.load(work / f"{mode}{rank}.npz")
        for name, (p, c) in ref.items():
            np.testing.assert_array_equal(got[name + "_len"],
                                          [len(x) for x in p])
            np.testing.assert_array_equal(got[name + "_pml"],
                                          np.concatenate(p), err_msg=name)
            np.testing.assert_array_equal(got[name + "_cid"],
                                          np.concatenate(c), err_msg=name)


def test_two_processes_dp2(two_process_work, case):
    """dp = 2 over gloo: rank 0's merged part files are byte-equal to a
    one-process query's, and every sharded engine all-gathers the two rows
    into the whole batch on both ranks."""
    index, _, reads, names = case
    work = two_process_work
    _run_two(work, "dp")
    single = str(work / "single.fa")
    distributed_query(index, single, names, reads,
                      lambda b: TM.query_batch(index, b, device="cpu"))
    for ext in ("pml", "cid"):
        assert (Path(f"{work}/dist.fa.split.{ext}.bin").read_bytes()
                == Path(f"{single}.split.{ext}.bin").read_bytes())
    assert not list(work.glob("*.part*"))
    _check_ranks(work, "dp", _ref(case))


def test_two_processes_ip2(two_process_work, case):
    """ip = 2 over gloo: each rank holds one shard of every table, and the
    all_reduce over the ip group gives the unsharded engines' outputs."""
    _run_two(two_process_work, "ip")
    _check_ranks(two_process_work, "ip", _ref(case))
