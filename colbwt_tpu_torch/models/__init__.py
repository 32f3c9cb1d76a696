"""Index state carried onto the device as PyTorch tensors."""
