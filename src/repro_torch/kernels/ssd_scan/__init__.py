"""Mamba2 SSD chunked scan (K5): CUDA kernel, plain version, wrapper."""
