"""Public entry point for blockwise causal attention:
:func:`flash_attention` launches the CUDA kernel for tensors on the card
and takes the plain version for tensors on the CPU (``kernel.py`` makes
that one choice). The choice follows the tensors' device alone;
``repro``'s ``force_ref`` and ``force_kernel`` switches, which work
around its choice of backend, have no counterpart here."""
from .kernel import flash_attention

__all__ = ["flash_attention"]
