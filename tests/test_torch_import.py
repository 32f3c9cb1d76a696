"""The PyTorch port imports no JAX, and its default device is CUDA: with
CUDA absent every default entry point raises instead of running on the CPU.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from colbwt_tpu_torch.cli import main as torch_cli
from colbwt_tpu_torch.ops import _kernels, query_pos, query_xla
from colbwt_tpu_torch.pipeline import build_pipeline, query_pipeline
from colbwt_tpu_torch.utils.device import resolve_device
from colbwt_tpu_torch.utils.hbm import resolve_pos_budget
from tests.conftest import random_docs
from tests.test_query_xla import build_index

REPO = Path(__file__).resolve().parents[1]


def test_no_module_imports_jax():
    """Every module of the package, and chip_smoke.py, in a fresh process
    (tests/conftest.py imports jax into this one)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import colbwt_tpu_torch, chip_smoke\n"
        "mods = [m.name for m in pkgutil.walk_packages("
        "colbwt_tpu_torch.__path__, 'colbwt_tpu_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "assert len(mods) >= 12, mods\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] == 'jax')\n"
        "assert not bad, bad\n"
        "print(len(mods))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 12


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
                                   "xla_query_batch"])
def test_default_device_entry_points_raise(no_cuda, small_index, entry):
    reads = [b"ACGTACGT"]
    call = {
        "build_pos_tables": lambda: query_pos.build_pos_tables(small_index,
                                                               1),
        "pos_query_batch": lambda: query_pos.query_batch(small_index, reads,
                                                         k=1),
        "xla_query_batch": lambda: query_xla.query_batch(small_index, reads),
    }[entry]
    with pytest.raises(RuntimeError, match="is_available"):
        call()


@pytest.mark.parametrize("command", ["build", "query"])
def test_cli_default_device_raises(no_cuda, tmp_path, command):
    fa = tmp_path / "x.fa"
    fa.write_text(">x\nACGTACGTAC\n")
    argv = (["build", "-o", str(tmp_path / "idx"), str(fa)]
            if command == "build" else
            ["query", str(tmp_path / "idx"), "-p", str(fa)])
    with pytest.raises(RuntimeError, match="is_available"):
        torch_cli(argv)
    assert not (tmp_path / "idx.colpml.npz").exists()
    assert not (tmp_path / "x.fa.split.pml.bin").exists()


def test_library_pipeline_default_device_raises(no_cuda, tmp_path):
    with pytest.raises(RuntimeError):
        build_pipeline([str(tmp_path / "none.fa")], str(tmp_path / "i"))
    with pytest.raises(RuntimeError):
        query_pipeline(str(tmp_path / "i"), str(tmp_path / "none.fa"))


def test_kernel_library_needs_cuda(no_cuda):
    with pytest.raises(RuntimeError, match="CUDA"):
        _kernels.load()
    assert set(_kernels.launches) == set(_kernels.KERNELS)
