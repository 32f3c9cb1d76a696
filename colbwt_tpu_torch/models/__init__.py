"""Index state carried onto the device as PyTorch tensors."""

from colbwt_tpu_torch.models.index import ColPmlIndex  # noqa: F401
