"""Aggregate per-run eval records into the paper's tables/figures.

Input: the per-run record dicts produced by ``runner.run_task``
(summary metrics + utilization CDF per seeded run). Output: Table 1
(JCR), Fig 3 (JCT percentiles + Reconfig/RFold ratios) and Fig 4
(utilization CDF + headline deltas), each annotated with the
paper-reported reference values so reproduction drift is visible in
one place.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.sim.metrics import aggregate

# Paper-reported Avg JCR % (Table 1).
PAPER_TABLE1 = {
    "FirstFit (16^3)": 10.4,
    "Folding (16^3)": 44.11,
    "Reconfig (8^3)": 31.46,
    "RFold (8^3)": 73.35,
    "Reconfig (4^3)": 100.0,
    "RFold (4^3)": 100.0,
}

# Paper-reported Reconfig/RFold JCT ratios (Fig 3); 2^3 is reported
# only as "at most ~1.3x", kept as an upper bound.
PAPER_FIG3_RATIOS = {
    "4^3": {"p50": 11.0, "p90": 6.0, "p99": 2.0},
    "2^3": {"p50": 1.3, "p90": 1.3, "p99": 1.3},
}

# Paper-reported absolute utilization gains (Fig 4), percentage points.
PAPER_FIG4_DELTAS = {
    "RFold (4^3) - FirstFit (16^3)": 57.0,
    "RFold (4^3) - Reconfig (4^3)": 20.0,
}


def aggregate_by_label(records: Sequence[Dict]) -> Dict[str, Dict]:
    """Group per-run records by label; average summaries and CDFs.

    Returns ``{label: {"agg": metric means, "cdf_levels": [...],
    "cdf": [...], "runs": n, "sim_s_total": s}}``.
    """
    by_label: Dict[str, List[Dict]] = {}
    for rec in records:
        by_label.setdefault(rec["label"], []).append(rec)
    out: Dict[str, Dict] = {}
    for label, recs in by_label.items():
        recs = sorted(recs, key=lambda r: r["run_idx"])
        out[label] = {
            "agg": aggregate([r["summary"] for r in recs]),
            "cdf_levels": recs[0]["cdf_levels"],
            "cdf": [float(x) for x in
                    np.mean([r["cdf"] for r in recs], axis=0)],
            "runs": len(recs),
            "sim_s_total": round(sum(r["sim_s"] for r in recs), 3),
        }
    return out


def table1(aggs: Dict[str, Dict],
           labels: Optional[Sequence[str]] = None) -> Dict[str, Dict]:
    """Table 1: measured vs paper JCR per policy, delta in points."""
    out = {}
    for label in (labels or PAPER_TABLE1):
        if label not in aggs:
            continue
        jcr_pct = 100.0 * aggs[label]["agg"]["jcr"]
        paper = PAPER_TABLE1.get(label)
        out[label] = {
            "jcr_pct": round(jcr_pct, 2),
            "paper_jcr_pct": paper,
            "delta_pts": None if paper is None else round(jcr_pct - paper, 2),
        }
    return out


def fig3(aggs: Dict[str, Dict],
         cube_sizes: Sequence[str] = ("4^3", "2^3")) -> Dict:
    """Fig 3: JCT percentiles for the 100%-JCR policies, plus the
    Reconfig/RFold speedup ratios the paper headlines (up to 11x)."""
    percentiles = {
        label: {k: agg["agg"][f"jct_{k}"] for k in ("p50", "p90", "p99")}
        for label, agg in aggs.items()
    }
    ratios = {}
    for n in cube_sizes:
        rc = percentiles.get(f"Reconfig ({n})")
        rf = percentiles.get(f"RFold ({n})")
        if not rc or not rf:
            continue
        ratios[n] = {
            k: round(rc[k] / rf[k], 2) if rf[k] else None
            for k in ("p50", "p90", "p99")
        }
        ratios[n]["paper"] = PAPER_FIG3_RATIOS.get(n)
    return {"percentiles": percentiles, "ratios": ratios}


def fig4(aggs: Dict[str, Dict]) -> Dict:
    """Fig 4: time-weighted utilization stats + mean CDF per policy,
    and the paper's two headline absolute deltas."""
    per_policy = {
        label: {"agg": agg["agg"],
                "cdf": [agg["cdf_levels"], agg["cdf"]]}
        for label, agg in aggs.items()
    }
    deltas = {}
    for key, paper in PAPER_FIG4_DELTAS.items():
        hi, lo = (s.strip() for s in key.split(" - "))
        if hi in aggs and lo in aggs:
            ours = 100.0 * (aggs[hi]["agg"]["util_mean"]
                            - aggs[lo]["agg"]["util_mean"])
            deltas[key] = {"ours_pts": round(ours, 2), "paper_pts": paper}
    return {"per_policy": per_policy, "deltas": deltas}
