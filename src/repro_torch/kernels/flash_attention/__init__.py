"""Blockwise causal attention (K4): CUDA kernel, plain version, wrapper."""
