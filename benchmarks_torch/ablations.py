"""Ablation sweeps from EXPERIMENTS.md on the port, driven by
``repro_torch.eval``: each arm is a run-matrix of seeded sims fanned
across the process pool (spawned where the engine runs on the card) on
paired traces. The engine is ``cuda`` on the card unless
``--engine``/``--device`` ask for another (``--engine numpy``: the
host). Checkpoints default to ``experiments/ablations_torch_ckpt``,
apart from the reference's: fingerprints are equal across the two
packages.

Arms:
  * dedicate_chained — strand the unused sub-blocks of chained cubes
    (DESIGN.md "Cube ownership") vs the default shared-ownership OCS.
  * backfill — aggressive backfilling vs the paper's FIFO head-of-line
    blocking (paper §5 invites revisiting admission).
  * scatter — best-effort scatter slowdown sweep around the paper's
    measured contention factors (1.35 / 1.5 / 1.95, §3.1).

  python3 benchmarks_torch/ablations.py --runs 10 --num-jobs 200
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

CUBE = dict(num_xpus=4096, cube_n=4)

ARMS = {
    "dedicate_chained": [
        ("Reconfig (4^3)", "reconfig", CUBE, {}),
        ("Reconfig (4^3) dedicated", "reconfig",
         {**CUBE, "dedicate_chained": True}, {}),
        ("RFold (4^3)", "rfold", CUBE, {}),
        ("RFold (4^3) dedicated", "rfold",
         {**CUBE, "dedicate_chained": True}, {}),
    ],
    "backfill": [
        ("RFold FIFO", "rfold", CUBE, {}),
        ("RFold backfill", "rfold", CUBE, {"backfill": True}),
    ],
    "scatter": [
        ("RFold (no scatter)", "rfold", CUBE, {}),
        ("RFold-BE 1.35", "rfold_be", {**CUBE, "scatter_slowdown": 1.35}, {}),
        ("RFold-BE 1.5", "rfold_be", {**CUBE, "scatter_slowdown": 1.5}, {}),
        ("RFold-BE 1.95", "rfold_be", {**CUBE, "scatter_slowdown": 1.95}, {}),
    ],
}

COLS = ("jcr", "jct_p50", "jct_p90", "jct_p99", "util_mean")


def run_arm(arm: str, runs: int, num_jobs: int, load: float, seed0: int,
            workers, ckpt_dir, engine=None) -> dict:
    from repro_torch.eval import EvalRunner, aggregate_by_label, make_tasks
    print(f"# ablation: {arm}")
    print("variant," + ",".join(COLS))
    # One pool over the whole arm's run matrix (variants only differ in
    # policy/sim kwargs, so their tasks are independent and can
    # interleave); aggregate_by_label splits the records back out.
    tasks = []
    for label, policy, pkw, skw in ARMS[arm]:
        tasks += make_tasks([(label, policy, pkw)], runs, num_jobs, load,
                            seed0, sim_kw=skw)
    runner = EvalRunner(checkpoint_dir=ckpt_dir, workers=workers,
                        engine=engine)
    aggs = aggregate_by_label(runner.run(tasks))
    out = {}
    for label, _, _, _ in ARMS[arm]:
        agg = aggs[label]["agg"]
        out[label] = agg
        print(label + "," + ",".join(
            f"{agg[c]:.3f}" if c in ("jcr", "util_mean") else f"{agg[c]:.0f}"
            for c in COLS))
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=10)
    ap.add_argument("--num-jobs", type=int, default=200)
    ap.add_argument("--load", type=float, default=1.5)
    ap.add_argument("--seed0", type=int, default=100)
    ap.add_argument("--workers", type=int, default=None)
    ap.add_argument("--ckpt-dir", type=str,
                    default=os.path.join("experiments",
                                         "ablations_torch_ckpt"))
    ap.add_argument("--engine", type=str, default=None,
                    help="fitmask engine (default: the registry's, cuda)")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device of a tensor engine (default: the "
                         "card)")
    ap.add_argument("--arm", default="all",
                    choices=["all"] + sorted(ARMS))
    ap.add_argument("--out", type=str, default="")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core.engineconfig import EngineConfig
    engine = EngineConfig(args.engine, device=args.device)
    results = {}
    for arm in (sorted(ARMS) if args.arm == "all" else [args.arm]):
        results[arm] = run_arm(arm, args.runs, args.num_jobs, args.load,
                               args.seed0, args.workers,
                               args.ckpt_dir or None, engine)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1, default=float)


if __name__ == "__main__":
    main()
