"""Importing this module registers every architecture whose blocks the
port has: zamba2-1.2b (Mamba2 and shared attention). The other families
of ``repro`` come with their blocks."""
from . import zamba2_1_2b  # noqa: F401

ARCH_IDS = ["zamba2-1.2b"]
