"""The PyTorch port imports no JAX and nothing of the JAX package, and its
default device is CUDA: with CUDA absent every default entry point raises
instead of running on the CPU.
"""

import ast
import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from colbwt_tpu_torch.cli import main as torch_cli
from colbwt_tpu_torch.ops import _kernels, query_fused, query_pos, query_xla
from colbwt_tpu_torch.pipeline import (build_pipeline, query_pipeline,
                                       query_stream)
from colbwt_tpu_torch.utils.config import ColBwtConfig
from colbwt_tpu_torch.utils.device import resolve_device
from colbwt_tpu_torch.utils.hbm import resolve_pos_budget
from tests.conftest import random_docs
from tests.test_query_xla import build_index

REPO = Path(__file__).resolve().parents[1]


def test_no_module_imports_jax():
    """Every module of the package, and chip_smoke.py, in a fresh process
    (tests/conftest.py imports jax into this one): neither jax nor any
    module of the JAX package colbwt_tpu gets loaded."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import colbwt_tpu_torch, chip_smoke\n"
        "mods = [m.name for m in pkgutil.walk_packages("
        "colbwt_tpu_torch.__path__, 'colbwt_tpu_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "assert len(mods) >= 44, mods\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'colbwt_tpu'))\n"
        "assert not bad, bad\n"
        "print(len(mods))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 44


def test_every_jax_module_has_a_port():
    """Each module of the JAX package has its counterpart at the same
    relative path in the port (construct_jax.py and colsplit_jax.py as
    construct.py and colsplit.py), the table cache, profiling hooks and
    r-index among them."""
    jax_root, port_root = REPO / "colbwt_tpu", REPO / "colbwt_tpu_torch"
    missing = [str(f.relative_to(jax_root))
               for f in sorted(jax_root.rglob("*.py"))
               if not (port_root / str(f.relative_to(jax_root)).replace(
                   "_jax.py", ".py")).exists()]
    assert not missing
    for rel in ("pipeline/tables.py", "utils/profiling.py", "ops/rindex.py"):
        assert (port_root / rel).exists()


def _imported_modules(path: Path) -> set[str]:
    """Every module an `import` or `from ... import` in `path` names, at
    any depth of the file (function bodies included)."""
    mods = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            mods.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            mods.add(node.module)
    return mods


@pytest.mark.parametrize("root", ["colbwt_tpu_torch", "chip_smoke.py",
                                  "scan_designs.py",
                                  "scripts/profile_doubling_round.py"])
def test_source_imports_nothing_of_jax_package(root):
    """The port keeps its own copy of the host layer: no source file of it,
    nor chip_smoke.py, the scans' design sweep or the port's profiling
    script, imports jax or anything of colbwt_tpu."""
    files = ([REPO / root] if root.endswith(".py")
             else sorted((REPO / root).rglob("*.py")))
    assert files
    bad = {f"{f.relative_to(REPO)}: {m}" for f in files
           for m in _imported_modules(f)
           if m.split(".")[0] in ("jax", "colbwt_tpu")}
    assert not bad, sorted(bad)


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.fixture(scope="module")
def small_index():
    _, index = build_index(random_docs(np.random.default_rng(9), 2, lo=50,
                                       hi=80))
    return index


def test_resolve_device(no_cuda):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError):
        resolve_device("cuda:0")
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_budget_default_needs_cuda(no_cuda):
    with pytest.raises(RuntimeError):
        resolve_pos_budget(0)
    assert resolve_pos_budget(0, "cpu") == 10 << 30
    assert resolve_pos_budget(123, "cpu") == 123


@pytest.mark.parametrize("entry", ["build_pos_tables", "pos_query_batch",
                                   "xla_query_batch", "build_fused_tables",
                                   "fused_query_batch"])
def test_default_device_entry_points_raise(no_cuda, small_index, entry):
    reads = [b"ACGTACGT"]
    split = dataclasses.replace(small_index, ff_bound=1)  # fused needs >= 1
    call = {
        "build_pos_tables": lambda: query_pos.build_pos_tables(small_index,
                                                               1),
        "pos_query_batch": lambda: query_pos.query_batch(small_index, reads,
                                                         k=1),
        "xla_query_batch": lambda: query_xla.query_batch(small_index, reads),
        "build_fused_tables": lambda: query_fused.build_fused_tables(split),
        "fused_query_batch": lambda: query_fused.query_batch(split, reads),
    }[entry]
    with pytest.raises(RuntimeError, match="is_available"):
        call()


@pytest.mark.parametrize("command", ["build", "query", "query-stream",
                                     "query-fused"])
def test_cli_default_device_raises(no_cuda, tmp_path, command):
    fa = tmp_path / "x.fa"
    fa.write_text(">x\nACGTACGTAC\n")
    extra = {"query-stream": ["--stream"],
             "query-fused": ["--engine", "fused"]}.get(command, [])
    argv = (["build", "-o", str(tmp_path / "idx"), str(fa)]
            if command == "build" else
            ["query", str(tmp_path / "idx"), "-p", str(fa), *extra])
    with pytest.raises(RuntimeError, match="is_available"):
        torch_cli(argv)
    assert not (tmp_path / "idx.colpml.npz").exists()
    assert not (tmp_path / "x.fa.split.pml.bin").exists()


@pytest.mark.parametrize("extra", [["--stream"], ["--engine", "fused"],
                                   ["--stream", "--engine", "fused"]],
                         ids=["stream", "fused", "stream-fused"])
def test_cli_stream_and_fused_run_on_cpu(tmp_path, extra):
    """`query --stream` and `--engine fused` answer with --device cpu, and
    their files equal the one-shot default query's."""
    rng = np.random.default_rng(0x5F)
    docs = random_docs(rng, 2, lo=150, hi=200)
    fastas = []
    for i, d in enumerate(docs):
        fastas.append(tmp_path / f"d{i}.fa")
        fastas[-1].write_bytes(b">d%d\n" % i + d + b"\n")
    build_pipeline([str(f) for f in fastas], str(tmp_path / "idx"),
                   ColBwtConfig(min_mum=10, run_split="always"),
                   device="cpu")
    reads = b"".join(b">r%d\n" % i + docs[i % 2][i:i + 40 + i] + b"\n"
                     for i in range(30))
    files = {}
    for tag, args in (("ref", []), ("got", extra)):
        pat = tmp_path / f"{tag}.fa"
        pat.write_bytes(reads)
        assert torch_cli(["query", str(tmp_path / "idx"), "-p", str(pat),
                          "--device", "cpu", *args]) == 0
        files[tag] = [Path(f"{pat}.split.{x}.bin").read_bytes()
                      for x in ("pml", "cid")]
    assert files["got"] == files["ref"]


def test_library_pipeline_default_device_raises(no_cuda, tmp_path):
    with pytest.raises(RuntimeError):
        build_pipeline([str(tmp_path / "none.fa")], str(tmp_path / "i"))
    with pytest.raises(RuntimeError):
        query_pipeline(str(tmp_path / "i"), str(tmp_path / "none.fa"))
    with pytest.raises(RuntimeError, match="is_available"):
        query_stream(str(tmp_path / "i"), str(tmp_path / "none.fa"))


def test_kernel_library_needs_cuda(no_cuda):
    with pytest.raises(RuntimeError, match="CUDA"):
        _kernels.load()
    assert set(_kernels.launches) == set(_kernels.KERNELS)
