"""PyTorch/CUDA port of ``repro``: the RFold placement loop on an NVIDIA H100."""
