"""Readings of the program's spans and counters (``repro_torch.obs``),
which each fleet of the window hands back in its stats as ``trace``.
A window whose fleets carry no ``trace`` (a program without the spans)
reads as nothing."""
from __future__ import annotations

from typing import Any, Dict, List, Optional


def traces(ctx: Dict[str, Any]) -> List[Dict[str, Any]]:
    return [f["trace"] for f in ctx.get("fleets") or []
            if f and "trace" in f]


def layer_self_s(ctx: Dict[str, Any], prefix: str) -> Optional[float]:
    """Self seconds of the window's spans whose names start with
    ``prefix`` (0 where the traces hold none: every lookup hit a
    cache); ``None`` without traces."""
    ts = traces(ctx)
    if not ts:
        return None
    return sum(s["self_s"] for t in ts for name, s in t["spans"].items()
               if name.startswith(prefix))


def layer_ms_per_job(ctx: Dict[str, Any], prefix: str) -> Optional[float]:
    self_s = layer_self_s(ctx, prefix)
    if self_s is None or not ctx.get("jobs"):
        return None
    return self_s / ctx["jobs"] * 1e3


def counter(ctx: Dict[str, Any], name: str) -> Optional[int]:
    """A counter summed over the window's fleets; ``None`` without
    traces."""
    ts = traces(ctx)
    if not ts:
        return None
    return sum(t["counters"].get(name, 0) for t in ts)


def span_total_s(ctx: Dict[str, Any], name: str) -> Optional[float]:
    """Total seconds of one span name over the window's fleets (0 where
    the traces hold none of it); ``None`` without traces."""
    ts = traces(ctx)
    if not ts:
        return None
    return sum(t["spans"].get(name, {}).get("total_s", 0.0) for t in ts)
