"""The control of a cell's comparison: the reference put in the
program's place with one guarantee of the configuration broken, judged
by the cell's own comparison, which has to find it not correct.

    python bench/control.py --workload rfold-4096-c4.sweep --seeds 1,2,3

The guarantee broken is FIFO admission with head-of-line blocking: the
control backfills, letting later jobs start past a blocked head. It
runs the first batch of the cell's traffic at full size, and the cell's
comparison replays every run of it. Each seed prints the compared
numbers with their limits. The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def sweep_control(cell, driver):
    """The verdict on one batch of control runs (backfill)."""
    from bench.compare import schedule_json
    from bench.reference.runs import reference_run
    batch = driver.batch_tasks(cell, 0)
    records, jobs = [], {}
    for task in batch:
        rec, done = reference_run(task.policy, task.policy_kw, task.seed,
                                  task.num_jobs, task.load,
                                  trace_kw=task.trace_kw,
                                  sim_kw={**task.sim_kw, "backfill": True},
                                  scenario=task.scenario)
        records.append({**rec, "fingerprint": task.fingerprint()})
        jobs[task.fingerprint()] = schedule_json(done)
    return driver.compare([{"tasks": batch, "records": records,
                            "jobs": jobs}], cell.traffic["num_jobs"],
                          len(batch), cell.seed)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)

    from bench import harness
    harness.quiet_threads()
    harness.pin_to_core()
    spec = harness.benchmark_spec()
    for seed in [int(s) for s in args.seeds.split(",")]:
        cell = harness.load_cell(spec, args.workload, seed, False)
        driver = harness.driver_module(cell)
        v = sweep_control(cell, driver)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": v.correct, "attempted": v.attempted,
                          "failed": v.failed,
                          "checks": {k: c.as_dict()
                                     for k, c in v.checks.items()}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
