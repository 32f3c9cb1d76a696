"""Query engines and the build's device stages (multi-MUM scan, col-split
walk): hand-written CUDA kernels with a plain PyTorch version beside each,
plus the host col-split walkers."""
