"""The mask-query client seam in the reference: no client is ever
installed, so every torus answers its fit queries on the host from its
own integral image (``fitmask.py``)."""
from __future__ import annotations


class MaskQueryClient:
    """The type a torus would submit mask work to; never instantiated."""


def resolve_mask_client(selection=None) -> None:
    del selection
    return None
