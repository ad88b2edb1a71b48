"""Paper evaluation reproductions on the port: Table 1 (JCR), Fig 3
(JCT percentiles), Fig 4 (utilization CDF), driven by
``repro_torch.eval``: the run x policy matrix fans out across a process
pool (spawned where the engine runs on the card), every run is
checkpointed, and the three tables are derived from one shared set of
per-run records.

    python3 benchmarks_torch/paper_eval.py [--runs 3] [--num-jobs 200]
        [--engine cuda] [--device cuda] [--workers N] [--fleet-size auto]

The engine is ``cuda`` on the card unless ``--engine``/``--device`` ask
for another (``--engine numpy`` runs on the host). Defaults are
CI-sized (runs=3, 200 jobs); pass --full for the paper's 100-run x
500-job averaging. An interrupted sweep resumes from --ckpt-dir
(default ``experiments/paper_eval_torch_ckpt``: fingerprints are equal
across the two packages, so a directory shared with ``repro`` would
resume from the reference's records and never run the port); pass
--fresh to discard checkpoints. Runner wall-clock stats land in
``experiments/paper_eval_torch_bench.json`` (--bench-out), never in
the committed BENCH_*.json snapshots. ``--scenario`` is refused: the
port has no chaos layer yet.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import sys
from pathlib import Path
from typing import Dict

ROOT = Path(__file__).resolve().parents[1]

# Policy matrix as evaluated by the paper.
TABLE1_CONFIGS = [
    ("FirstFit (16^3)", "firstfit", dict(dims=(16, 16, 16))),
    ("Folding (16^3)", "folding", dict(dims=(16, 16, 16))),
    ("Reconfig (8^3)", "reconfig", dict(num_xpus=4096, cube_n=8)),
    ("RFold (8^3)", "rfold", dict(num_xpus=4096, cube_n=8)),
    ("Reconfig (4^3)", "reconfig", dict(num_xpus=4096, cube_n=4)),
    ("RFold (4^3)", "rfold", dict(num_xpus=4096, cube_n=4)),
]

# Fig 3 compares JCT only where JCR == 100%; 4^3 overlaps Table 1,
# 2^3 is Fig-3-only.
FIG3_EXTRA_CONFIGS = [
    ("Reconfig (2^3)", "reconfig", dict(num_xpus=4096, cube_n=2)),
    ("RFold (2^3)", "rfold", dict(num_xpus=4096, cube_n=2)),
]
FIG3_LABELS = ["Reconfig (4^3)", "RFold (4^3)",
               "Reconfig (2^3)", "RFold (2^3)"]

DEFAULT_CKPT_DIR = os.path.join("experiments", "paper_eval_torch_ckpt")
DEFAULT_BENCH_OUT = os.path.join("experiments", "paper_eval_torch_bench.json")


def _configs_for(which: str):
    if which == "fig3":
        table1_43 = [c for c in TABLE1_CONFIGS if "4^3" in c[0]]
        return table1_43 + FIG3_EXTRA_CONFIGS
    if which in ("table1", "fig4"):
        return list(TABLE1_CONFIGS)
    return list(TABLE1_CONFIGS) + FIG3_EXTRA_CONFIGS


def _run_matrix(configs, runs: int, num_jobs: int, load: float,
                seed0: int, workers, ckpt_dir, emit=print,
                trace_kw: Dict = None, engine=None):
    from repro_torch.eval import EvalRunner, aggregate_by_label, make_tasks
    tasks = make_tasks(configs, runs, num_jobs, load, seed0,
                       trace_kw=trace_kw)
    runner = EvalRunner(checkpoint_dir=ckpt_dir, workers=workers,
                        emit=emit, engine=engine)
    records = runner.run(tasks)
    return aggregate_by_label(records), runner.last_stats, tasks


def _legacy_aggs(aggs: Dict[str, Dict]) -> Dict[str, Dict]:
    """{label: metric means} — the schema the pre-subsystem emitters
    and experiments/paper_eval.json consumers expect."""
    return {label: a["agg"] for label, a in aggs.items()}


def _emit_table1(t1: Dict[str, Dict], runs: int, emit=print) -> None:
    emit("# Table 1 — Job Completion Rate (avg over %d runs)" % runs)
    emit("policy,jcr_pct,paper_jcr_pct")
    for label, row in t1.items():
        emit("%s,%.2f,%.2f" % (label, row["jcr_pct"], row["paper_jcr_pct"]))


def _emit_fig3(f3: Dict, emit=print) -> None:
    emit("# Fig 3 — JCT p50/p90/p99 (policies with 100%% JCR)")
    emit("policy,jct_p50_s,jct_p90_s,jct_p99_s")
    for label in FIG3_LABELS:
        p = f3["percentiles"].get(label)
        if p:
            emit("%s,%.0f,%.0f,%.0f" % (label, p["p50"], p["p90"], p["p99"]))
    for n, r in f3["ratios"].items():
        emit("ratio Reconfig/RFold (%s): p50=%.1fx p90=%.1fx p99=%.1fx "
             "(paper 4^3: 11x/6x/2x, 2^3: <=1.3x)"
             % (n, r["p50"], r["p90"], r["p99"]))


def _emit_fig4(f4: Dict, emit=print) -> None:
    emit("# Fig 4 — cluster utilization (time-weighted)")
    emit("policy,util_mean,util_p50,util_p90")
    for label, _, _ in TABLE1_CONFIGS:
        a = f4["per_policy"].get(label)
        if a:
            a = a["agg"]
            emit("%s,%.3f,%.3f,%.3f" % (label, a["util_mean"],
                                        a["util_p50"], a["util_p90"]))
    for key, d in f4["deltas"].items():
        emit("%s = +%.1f pts absolute (paper: +%.0f)"
             % (key, d["ours_pts"], d["paper_pts"]))


# -- pre-subsystem API kept for callers/tests --------------------------

def table1_jcr(runs: int = 3, num_jobs: int = 200, load: float = 1.5,
               seed0: int = 100, emit=print, engine=None) -> Dict[str, Dict]:
    from repro_torch.eval import table1
    aggs, _, _ = _run_matrix(TABLE1_CONFIGS, runs, num_jobs, load, seed0,
                             workers=0, ckpt_dir=None, engine=engine)
    _emit_table1(table1(aggs), runs, emit)
    return _legacy_aggs(aggs)


def fig3_jct(runs: int = 3, num_jobs: int = 200, load: float = 1.5,
             seed0: int = 100, emit=print, engine=None) -> Dict[str, Dict]:
    from repro_torch.eval import fig3
    aggs, _, _ = _run_matrix(_configs_for("fig3"), runs, num_jobs, load,
                             seed0, workers=0, ckpt_dir=None, engine=engine)
    _emit_fig3(fig3(aggs), emit)
    return _legacy_aggs(aggs)


def fig4_utilization(runs: int = 3, num_jobs: int = 200, load: float = 1.5,
                     seed0: int = 100, emit=print,
                     engine=None) -> Dict[str, Dict]:
    from repro_torch.eval import fig4
    aggs, _, _ = _run_matrix(TABLE1_CONFIGS, runs, num_jobs, load, seed0,
                             workers=0, ckpt_dir=None, engine=engine)
    f4 = fig4(aggs)
    _emit_fig4(f4, emit)
    return {label: {"agg": a["agg"], "cdf": a["cdf"]}
            for label, a in f4["per_policy"].items()}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--num-jobs", type=int, default=200)
    ap.add_argument("--load", type=float, default=1.5)
    ap.add_argument("--seed0", type=int, default=100)
    ap.add_argument("--full", action="store_true",
                    help="paper-scale averaging (100 runs, 500 jobs)")
    ap.add_argument("--workers", type=int, default=None,
                    help="process-pool width (default: 0 for an engine "
                         "on the card, else os.cpu_count(); <=1 runs "
                         "inline)")
    ap.add_argument("--engine", type=str, default=None,
                    help="fitmask engine (default: the registry's, cuda)")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device of a tensor engine (default: the "
                         "card)")
    ap.add_argument("--fleet-size", type=str, default="auto",
                    help="simulators per in-process fleet (continuous "
                         "engine-call batching, repro_torch.sim.fleet). "
                         "'auto' (the default) fleets on a device engine, "
                         "sizing from the task backlog per worker, and "
                         "runs per task on numpy; an integer forces "
                         "fleets of that size; 0/1 selects the "
                         "sequential per-task oracle path")
    ap.add_argument("--ckpt-dir", type=str, default=DEFAULT_CKPT_DIR,
                    help="per-run checkpoint dir ('' disables)")
    ap.add_argument("--fresh", action="store_true",
                    help="ignore + remove existing checkpoints")
    ap.add_argument("--prune-ckpt", action="store_true",
                    help="after the run, drop checkpoints whose "
                         "fingerprint is not in this invocation's task "
                         "set (keeps the actions/cache store bounded)")
    ap.add_argument("--ckpt-max-mb", type=int, default=None,
                    help="with --prune-ckpt: also cap the surviving "
                         "store size, evicting oldest first")
    ap.add_argument("--out", type=str, default="")
    ap.add_argument("--bench-out", type=str, default=DEFAULT_BENCH_OUT,
                    help="runner wall-clock stats JSON ('' disables); "
                         "never a committed BENCH_*.json")
    ap.add_argument("--which", type=str, default="all",
                    choices=["all", "table1", "fig3", "fig4"])
    ap.add_argument("--trace-preset", type=str, default=None,
                    help="named TraceConfig calibration preset (e.g. "
                         "'philly'); expanded into concrete trace fields "
                         "so checkpoint fingerprints stay value-based")
    ap.add_argument("--scenario", type=str, default=None,
                    help="refused: the port has no chaos layer yet")
    args = ap.parse_args(argv)
    if args.scenario:
        ap.error("--scenario needs the chaos layer (sim/faults.py and "
                 "sim/scenarios.py), which repro_torch does not have yet")
    if args.bench_out and os.path.basename(args.bench_out).startswith(
            "BENCH_"):
        ap.error("the committed BENCH_*.json snapshots are the reference "
                 "package's; write the port's stats elsewhere")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core.engineconfig import EngineConfig
    from repro_torch.eval import PAPER_TABLE1, fig3, fig4, table1
    trace_kw = None
    if args.trace_preset:
        from repro_torch.traces.generator import TRACE_PRESETS
        if args.trace_preset not in TRACE_PRESETS:
            ap.error(f"unknown trace preset {args.trace_preset!r}; "
                     f"have {sorted(TRACE_PRESETS)}")
        trace_kw = dict(TRACE_PRESETS[args.trace_preset])
    runs, n = (100, 500) if args.full else (args.runs, args.num_jobs)
    fleet_size = args.fleet_size
    if fleet_size not in ("auto",):
        fleet_size = int(fleet_size)
    engine = EngineConfig(args.engine, device=args.device,
                          fleet_size=fleet_size)
    bench_out = args.bench_out
    ckpt_dir = args.ckpt_dir or None
    if args.fresh and ckpt_dir and os.path.isdir(ckpt_dir):
        from repro_torch.eval.runner import iter_checkpoints
        for path in iter_checkpoints(ckpt_dir):
            os.remove(path)

    t0 = time.time()
    aggs, stats, tasks = _run_matrix(_configs_for(args.which), runs, n,
                                     args.load, args.seed0, args.workers,
                                     ckpt_dir, trace_kw=trace_kw,
                                     engine=engine)
    if args.prune_ckpt and ckpt_dir and os.path.isdir(ckpt_dir):
        from repro_torch.eval import prune_checkpoints
        max_bytes = (args.ckpt_max_mb * 1024 * 1024
                     if args.ckpt_max_mb else None)
        pstats = prune_checkpoints(ckpt_dir, tasks, max_bytes=max_bytes)
        print(f"# checkpoint prune: {pstats}")
    results: Dict = {}
    if args.which in ("all", "table1"):
        t1 = table1(aggs)
        _emit_table1(t1, runs)
        results["table1"] = {label: aggs[label]["agg"] for label in t1}
        results["table1_deltas"] = t1
    if args.which in ("all", "fig3"):
        f3 = fig3(aggs)
        _emit_fig3(f3)
        results["fig3"] = {label: aggs[label]["agg"]
                           for label in FIG3_LABELS if label in aggs}
        results["fig3_ratios"] = f3["ratios"]
    if args.which in ("all", "fig4"):
        f4 = fig4({label: a for label, a in aggs.items()
                   if label in PAPER_TABLE1})
        _emit_fig4(f4)
        results["fig4"] = {label: {"agg": a["agg"], "cdf": a["cdf"]}
                           for label, a in f4["per_policy"].items()}
        results["fig4_deltas"] = f4["deltas"]
    wall = time.time() - t0
    print(f"# total {wall:.0f}s (pool: {stats})")
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1, default=float)
    if bench_out:
        bench = {
            "config": {"runs": runs, "num_jobs": n, "load": args.load,
                       "seed0": args.seed0, "which": args.which,
                       "full": args.full,
                       "scenario": args.scenario,
                       "trace_preset": args.trace_preset,
                       # the pool width the runner resolved
                       "workers": stats["workers"],
                       "fleet_size_arg": args.fleet_size,
                       # the resolved size actually used (None: the
                       # sequential per-task oracle path ran)
                       "fleet_size": stats.get("fleet", {}).get("size"),
                       "fitmask_engine": engine.resolve_name(),
                       "device": args.device},
            "pool": stats,
            "wall_s": round(wall, 3),
            "per_policy_sim_s": {label: a["sim_s_total"]
                                 for label, a in aggs.items()},
        }
        os.makedirs(os.path.dirname(bench_out) or ".", exist_ok=True)
        with open(bench_out, "w") as f:
            json.dump(bench, f, indent=1)


if __name__ == "__main__":
    main()
