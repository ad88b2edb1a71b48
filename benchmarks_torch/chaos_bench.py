"""Chaos benchmark on the port: degradation and recovery across the
scenario matrix.

Runs every (scenario x policy) cell of the chaos layer — the five named
scenarios of :mod:`repro_torch.sim.scenarios` against the five paper
policies at 512 XPUs — and records each cell's degradation/recovery
block (:class:`~repro_torch.sim.faults.ChaosObserver`). The matrix, the
seeds and the records are those of ``benchmarks/chaos_bench.py``; a
cell's record (``cell_s`` aside) is byte-identical to the reference's.

Two asserts ride on top:

* **Determinism.** Every cell is run twice with the same seed; the two
  records must be byte-identical JSON.
* **Headline.** Under ``node_churn``, RFold's time-weighted utilization
  over the degraded run is at least the best static baseline's
  (FirstFit, Folding) less ``--tolerance``, and RFold recovers.

The engine is ``cuda`` on the card unless ``--engine``/``--device`` ask
for another (``--engine numpy``: the host). The JSON goes to ``--out``
(default ``experiments/chaos_bench_torch.json``), never to the committed
BENCH_*.json snapshots.

    python3 benchmarks_torch/chaos_bench.py [--quick] [--scenario node_churn]
        [--engine cuda] [--device cuda] [--out PATH]
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List

ROOT = Path(__file__).resolve().parents[1]

# The service-bench parity matrix, reused: 512 XPUs per policy.
POLICY_CONFIGS = [
    ("firstfit", "FirstFit (8^3)", "firstfit", dict(dims=(8, 8, 8))),
    ("folding", "Folding (8^3)", "folding", dict(dims=(8, 8, 8))),
    ("reconfig", "Reconfig (4^3)", "reconfig",
     dict(num_xpus=512, cube_n=4)),
    ("rfold", "RFold (4^3)", "rfold", dict(num_xpus=512, cube_n=4)),
    ("rfold_be", "RFold-BE (4^3)", "rfold_be",
     dict(num_xpus=512, cube_n=4)),
]

STATIC_BASELINES = ("firstfit", "folding")
TRACE_KW = dict(cluster_xpus=512, size_max=512)


def run_cell(scenario: str, policy: str, policy_kw: dict, num_jobs: int,
             seed: int, engine=None) -> Dict:
    """One (scenario, policy) cell on ``engine`` (an engine name or
    ``EngineConfig``; None: the registry's), run twice with the same
    seed; the returned record carries the determinism verdict."""
    from repro_torch.sim.scenarios import run_scenario

    kw = dict(policy_kw, engine=engine)
    t0 = time.perf_counter()
    first = run_scenario(scenario, policy=policy, policy_kw=kw,
                         num_jobs=num_jobs, seed=seed,
                         trace_kw=dict(TRACE_KW))
    second = run_scenario(scenario, policy=policy, policy_kw=kw,
                          num_jobs=num_jobs, seed=seed,
                          trace_kw=dict(TRACE_KW))
    identical = (json.dumps(first, sort_keys=True)
                 == json.dumps(second, sort_keys=True))
    first["deterministic"] = identical
    first["cell_s"] = round(time.perf_counter() - t0, 3)
    return first


def run_matrix(scenarios: List[str], num_jobs: int, seed: int,
               engine=None, emit=print) -> Dict[str, Dict[str, Dict]]:
    out: Dict[str, Dict[str, Dict]] = {}
    for scenario in scenarios:
        out[scenario] = {}
        for key, label, policy, kw in POLICY_CONFIGS:
            cell = run_cell(scenario, policy, kw, num_jobs, seed, engine)
            cell["label"] = label
            out[scenario][key] = cell
            ch = cell["chaos"]
            emit(f"  {scenario:13s} {label:16s} "
                 f"det={cell['deterministic']} "
                 f"jcr={cell['summary']['jcr']:.3f} "
                 f"dip={ch['dip_depth']:.3f} "
                 f"recovered_util={ch['recovered_util']:.3f} "
                 f"pre={ch['preempted']} mig={ch['migrated']} "
                 f"({cell['cell_s']}s)")
    return out


def headline_from(matrix: Dict[str, Dict[str, Dict]],
                  tolerance: float) -> Dict:
    """The recovery claim: under ``node_churn`` RFold (a) sustains at
    least the best static baseline's time-weighted utilization over
    the whole degraded run, and (b) recovers. ``util_overall`` rather
    than the post-repair tail: a policy that stalls during degradation
    piles up a backlog whose drain saturates its tail window, so tail
    utilization alone rewards exactly the wrong behaviour. Determinism
    is asserted on every cell that ran."""
    det = all(cell["deterministic"]
              for cells in matrix.values() for cell in cells.values())
    head: Dict = {"deterministic": det, "tolerance": tolerance}
    churn = matrix.get("node_churn")
    if churn is None:
        head.update({"criterion": "determinism only "
                                  "(node_churn not in this run)",
                     "pass": det})
        return head
    rfold = churn["rfold"]["chaos"]["util_overall"]
    recovered = bool(churn["rfold"]["chaos"]["recovered"])
    static_best = max(churn[k]["chaos"]["util_overall"]
                      for k in STATIC_BASELINES)
    head.update({
        "criterion": "rfold util_overall >= max(static) - tolerance "
                     "under node_churn, rfold recovered, all cells "
                     "deterministic",
        "rfold_util": round(rfold, 4),
        "static_best_util": round(static_best, 4),
        "rfold_recovered": recovered,
        "util_ok": rfold >= static_best - tolerance,
        "pass": det and recovered and rfold >= static_best - tolerance,
    })
    return head


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="60-job cells")
    ap.add_argument("--scenario", default=None,
                    help="run a single scenario; default: all five")
    ap.add_argument("--num-jobs", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tolerance", type=float, default=0.02,
                    help="absolute util slack for the node_churn headline")
    ap.add_argument("--engine", type=str, default=None,
                    help="fitmask engine (default: the registry's, cuda)")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device of a tensor engine (default: the "
                         "card)")
    ap.add_argument("--out", default=os.path.join(
        "experiments", "chaos_bench_torch.json"),
        help="JSON output ('' disables); never a committed BENCH_*.json")
    args = ap.parse_args(argv)
    if args.out and os.path.basename(args.out).startswith("BENCH_"):
        ap.error("the committed BENCH_*.json snapshots are the reference "
                 "package's; write the port's JSON elsewhere")
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    from repro_torch.core.engineconfig import EngineConfig
    from repro_torch.sim.scenarios import SCENARIOS
    if args.scenario and args.scenario not in SCENARIOS:
        ap.error(f"unknown scenario {args.scenario!r}; "
                 f"have {sorted(SCENARIOS)}")
    engine = EngineConfig(args.engine, device=args.device)
    card = None
    if engine.resolve_name() != "numpy" and torch.device(
            args.device or "cuda").type == "cuda":
        if not torch.cuda.is_available():
            print("chaos_bench: no CUDA device", file=sys.stderr)
            raise SystemExit(1)
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", "0"],
            capture_output=True, text=True, check=True).stdout.strip()
        print(card)

    num_jobs = args.num_jobs or (60 if args.quick else 120)
    scenarios = [args.scenario] if args.scenario else sorted(SCENARIOS)
    print(f"# chaos bench: {len(scenarios)} scenario(s) x "
          f"{len(POLICY_CONFIGS)} policies, {num_jobs} jobs/cell, engine "
          f"{engine.resolve_name()}, every cell run twice (determinism)")
    t0 = time.perf_counter()
    matrix = run_matrix(scenarios, num_jobs, args.seed, engine)
    head = headline_from(matrix, args.tolerance)
    bench = {"num_jobs": num_jobs, "seed": args.seed,
             "engine": engine.resolve_name(), "device": args.device,
             "card": card, "scenarios": matrix, "headline": head,
             "wall_s": time.perf_counter() - t0}
    print(f"# headline: deterministic={head['deterministic']}", end="")
    if "rfold_util" in head:
        print(f", rfold util {head['rfold_util']} vs static best "
              f"{head['static_best_util']} "
              f"(recovered={head['rfold_recovered']})", end="")
    print(f" -> pass={head['pass']} ({bench['wall_s']} s)")
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(bench, f, indent=1)
        print(f"# wrote {args.out}")
    if not head["pass"]:
        raise SystemExit(f"chaos_bench: headline failed: {head}")
    return bench


if __name__ == "__main__":
    main()
