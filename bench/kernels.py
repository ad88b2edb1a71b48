"""The fitmask kernels' launch counters, read from the program, and the
names the benchmark gives them.

K1 is the multi-box kernel, in its plain form or fused with the free
counts (one kernel, ``fitmask_multibox_kernel``); K2 counts the occupied
cells of each grid (``occupancy_counts``); K3 is the multi-box kernel
with one box (``fitmask_batched``)."""
from __future__ import annotations

from typing import Dict

KERNELS = {"K1": ("fitmask_multibox", "fitmask_multibox_bucketed"),
           "K2": ("occupancy_counts",),
           "K3": ("fitmask_batched",)}


def launch_counts() -> Dict[str, int]:
    from repro_torch.kernels.fitmask import kernel
    return dict(kernel.launch_counts())


def delta(before: Dict[str, int], after: Dict[str, int]) -> Dict[str, int]:
    return {k: after[k] - before.get(k, 0) for k in after}


def launches_of(counts: Dict[str, int], kernel_id: str) -> int:
    return sum(counts.get(name, 0) for name in KERNELS[kernel_id])


def is_fitmask_kernel(device_op: str) -> bool:
    """A device operation of the fitmask kernels, by its kernel name."""
    return "fitmask" in device_op or "occupancy" in device_op
