"""colbwt_tpu_torch — the PyTorch/CUDA port of colbwt_tpu.

Builds a run-length BWT index of a genome collection and answers per-base
PML (pseudo matching length) and CID (multi-MUM column id) queries for
reads against it, with the device programs of the query and of the build
(multi-MUM scan, col-split walk) written by hand in CUDA C++ for Hopper
(sm_90a).  The JAX package `colbwt_tpu` is the reference: every module here
mirrors the one of the same name there and must give byte-identical
results.

- ``colbwt_tpu_torch.ops``      query engines and build stages: CUDA
                                kernels (csrc/) with a plain PyTorch
                                version beside each; the NumPy oracle
- ``colbwt_tpu_torch.models``   the index (ColPmlIndex) and its device
                                tensors
- ``colbwt_tpu_torch.pipeline`` the build pipeline and its prewarm,
                                engine selection, the persisted table
                                cache, the one-shot and streaming queries
- ``colbwt_tpu_torch.io``       file formats, FASTA, PML/CID writers, the
                                native host library
- ``colbwt_tpu_torch.utils``    configuration, logging, device selection,
                                memory budgets, the chunked upload,
                                profiling hooks

The device defaults to ``cuda`` everywhere and raises when CUDA is absent;
the plain PyTorch path runs only when a caller passes ``device="cpu"``.
This package imports torch and never jax, and nothing of colbwt_tpu: the
host layer it shares with the JAX package is its own copy.
"""

__version__ = "0.1.0"

from colbwt_tpu_torch.utils.config import ColBwtConfig, SplitMode  # noqa: F401

__all__ = ["build_pipeline", "query_pipeline"]


def __getattr__(name: str):
    if name in __all__:
        from colbwt_tpu_torch.pipeline import build

        return getattr(build, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
