"""Public entry point for the SSD scan: :func:`ssd_scan` launches the
CUDA kernel for tensors on the card and takes the chunked oracle for
tensors on the CPU (``kernel.py`` makes that one choice). The choice
follows the tensors' device alone; ``repro``'s ``force_ref`` and
``force_kernel`` switches have no counterpart here."""
from .kernel import ssd_scan

__all__ = ["ssd_scan"]
