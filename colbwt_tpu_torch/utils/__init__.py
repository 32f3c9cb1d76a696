"""Configuration, logging, device selection, memory budgets, the chunked
upload and the profiling hooks."""

from colbwt_tpu_torch.utils.config import ColBwtConfig, SplitMode  # noqa: F401
from colbwt_tpu_torch.utils.log import get_logger, Timer, status  # noqa: F401
