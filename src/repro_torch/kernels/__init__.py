"""Hand-written Hopper kernels with their plain PyTorch versions."""
