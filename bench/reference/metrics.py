"""Metrics: JCR, JCT percentiles, time-weighted utilization (paper §4)."""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from .simulator import SimResult


def jct_percentiles(result: SimResult,
                    qs: Sequence[float] = (50, 90, 99)) -> Dict[str, float]:
    jcts = np.array([j.jct for j in result.completed], dtype=np.float64)
    if jcts.size == 0:
        return {f"p{int(q)}": float("nan") for q in qs}
    return {f"p{int(q)}": float(np.percentile(jcts, q)) for q in qs}


def time_weighted_utilization(result: SimResult) -> Dict[str, float]:
    """Utilization sampled as a step function over event times; the paper
    plots the per-run time series as a CDF — we report its time-weighted
    mean and percentiles."""
    samples = result.utilization_samples
    if len(samples) < 2:
        return {"mean": 0.0, "p50": 0.0, "p90": 0.0}
    ts = np.array([t for t, _ in samples])
    us = np.array([u for _, u in samples])
    widths = np.diff(ts)
    vals, w = us[:-1], widths
    mask = w > 0
    vals, w = vals[mask], w[mask]
    if vals.size == 0:
        return {"mean": float(us.mean()), "p50": float(us.mean()),
                "p90": float(us.mean())}
    order = np.argsort(vals)
    vals, w = vals[order], w[order]
    cum = np.cumsum(w) / w.sum()

    def wq(q: float) -> float:
        return float(vals[np.searchsorted(cum, q)])

    return {"mean": float((vals * w).sum() / w.sum()),
            "p50": wq(0.50), "p90": wq(0.90)}


def utilization_cdf(result: SimResult, grid: int = 101) -> Tuple[np.ndarray, np.ndarray]:
    """(utilization levels, CDF) — time-weighted, for Fig-4-style output."""
    samples = result.utilization_samples
    ts = np.array([t for t, _ in samples])
    us = np.array([u for _, u in samples])
    w = np.diff(ts)
    vals = us[:-1]
    levels = np.linspace(0.0, 1.0, grid)
    cdf = np.array([(w[vals <= lv]).sum() for lv in levels]) / max(w.sum(), 1e-12)
    return levels, cdf


def summarize(result: SimResult) -> Dict[str, float]:
    out: Dict[str, float] = {"jcr": result.jcr}
    out.update({f"jct_{k}": v for k, v in jct_percentiles(result).items()})
    util = time_weighted_utilization(result)
    out.update({f"util_{k}": v for k, v in util.items()})
    out["num_jobs"] = len(result.jobs)
    out["num_dropped"] = len(result.dropped)
    return out


def aggregate(summaries: List[Dict[str, float]]) -> Dict[str, float]:
    """Average metric dicts across runs (paper averages 100 runs)."""
    keys = summaries[0].keys()
    return {k: float(np.nanmean([s[k] for s in summaries])) for k in keys}
