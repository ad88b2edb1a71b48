"""Window-sum oracle for the fitmask kernels: ``Tensor.unfold`` over the
three grid axes, then ``sum`` — exact, and independent of the integral
image the kernels and their plain versions build."""
from __future__ import annotations

from typing import Sequence, Tuple

import torch


def fitmask_reference(occ: torch.Tensor,
                      box: Tuple[int, int, int]) -> torch.Tensor:
    """occ: (B, X, Y, Z). Returns (B, X, Y, Z) int32, 1 where the box
    fits (un-wrapped), 0 elsewhere (including origins where the box
    would overhang)."""
    bsz, x, y, z = occ.shape
    a, b, c = (int(v) for v in box)
    out = torch.zeros((bsz, x, y, z), dtype=torch.int32, device=occ.device)
    if a > x or b > y or c > z:
        return out
    sums = (occ.to(torch.int32).unfold(1, a, 1).unfold(2, b, 1)
            .unfold(3, c, 1).sum((-3, -2, -1)))
    out[:, :x - a + 1, :y - b + 1, :z - c + 1] = sums == 0
    return out


def fitmask_multibox_reference(occ: torch.Tensor,
                               boxes: Sequence[Tuple[int, int, int]]
                               ) -> torch.Tensor:
    """Multi-box oracle: (B, X, Y, Z) x K boxes -> (B, K, X, Y, Z)
    int32, one :func:`fitmask_reference` plane per box."""
    bsz, x, y, z = occ.shape
    if not len(boxes):
        return torch.zeros((bsz, 0, x, y, z), dtype=torch.int32,
                           device=occ.device)
    return torch.stack([fitmask_reference(occ, b) for b in boxes], dim=1)
