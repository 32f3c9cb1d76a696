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
                                version beside each
- ``colbwt_tpu_torch.models``   the index as a dict of device tensors
- ``colbwt_tpu_torch.pipeline`` the build pipeline, engine selection,
                                the one-shot query pipeline
- ``colbwt_tpu_torch.utils``    device selection and memory budgets

The device defaults to ``cuda`` everywhere and raises when CUDA is absent;
the plain PyTorch path runs only when a caller passes ``device="cpu"``.
This package imports torch and never jax.
"""

__version__ = "0.1.0"

__all__ = ["build_pipeline", "query_pipeline"]


def __getattr__(name: str):
    if name in __all__:
        from colbwt_tpu_torch.pipeline import build

        return getattr(build, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
