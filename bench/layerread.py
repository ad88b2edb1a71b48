"""Readings shared by several per-layer metrics' readers."""
from __future__ import annotations

from typing import Any, Dict, Optional

from bench.kernels import is_fitmask_kernel


def fitmask_us_per_launch(ctx: Dict[str, Any]) -> Optional[float]:
    """Device time of the fitmask kernels in the traced window, by kernel
    name from the profiler, over the launches the program counted."""
    prof = ctx.get("profile")
    launches = sum(ctx.get("launches", {}).values())
    if not prof or not launches:
        return None
    busy = sum(s for name, s in prof["kernel_s"].items()
               if is_fitmask_kernel(name))
    if busy <= 0:
        return None
    return busy / launches * 1e6


def device_idle(ctx: Dict[str, Any]) -> Optional[float]:
    """Share of the traced window in which no operation ran on the
    device."""
    prof = ctx.get("profile")
    if not prof or prof["window_s"] <= 0 or prof["busy_s"] <= 0:
        return None
    return 1.0 - prof["busy_s"] / prof["window_s"]
