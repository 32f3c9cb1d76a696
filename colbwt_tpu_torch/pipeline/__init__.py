"""Build and query pipelines of the PyTorch/CUDA port."""

from colbwt_tpu_torch.pipeline.build import (  # noqa: F401
    build_pipeline, query_pipeline)
from colbwt_tpu_torch.pipeline.stream import query_stream  # noqa: F401
