"""Where the port runs: on the card unless the caller asks otherwise."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the card. Raises ``RuntimeError`` when the card is
    asked for (explicitly or by default) and none is present: the port
    never carries on on the CPU unless the caller asks for it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card unless the caller "
            "asks for device='cpu' (or, for placement, engine='numpy')")
    return dev
