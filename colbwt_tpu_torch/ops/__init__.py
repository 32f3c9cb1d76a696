"""Query engines: hand-written CUDA kernels with a plain PyTorch version
beside each, plus the host col-split copy."""
