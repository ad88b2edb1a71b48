"""The sweep driver: evaluation runs of one policy configuration through
``repro_torch.eval.EvalRunner`` on the card, batch after batch, until
the window closes; the batch running at the close finishes and counts.

Traffic keys: ``num_jobs`` and ``load`` (each run's trace),
``batch_runs`` (runs a batch), ``scenario`` (a chaos scenario or null),
``trace_kw`` and ``sim_kw``, ``warm_runs`` and ``warm_jobs`` (set-up's
untimed runs), ``checked_runs`` (how many of the window's runs the
reference replays).

The window's runs are those of one sweep rooted at ``--seed``: batch
``b`` holds runs ``b * batch_runs`` onwards, each on its own trace
(``derive_seed``), so every batch meets job shapes that no earlier one
did, as a real sweep does. Set-up runs ``warm_runs`` short traces of a
sweep rooted elsewhere (``WARM_ROOT``), disjoint from the window's: one
fleet's worth, so that the kernels are built and loaded and every code
path of the runner and broker has run once, and no more.

``correct``: every run of the window has to come back with all its
jobs, and a sample of ``checked_runs`` of them, drawn from ``--seed``,
is replayed by the reference and compared: its record (summary,
utilisation CDF, chaos block) and each job's schedule (start, finish,
dropped, slowdown, placement, evictions).
"""
from __future__ import annotations

import json
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List

import numpy as np

from bench import harness, kernels
from bench.compare import schedule_json, schedule_rows

# Added to ``--seed`` to root the warm-up's sweep: its runs never share
# a trace with the window's.
WARM_ROOT = 1 << 40
BROKER_SUMS = ("requests", "engine_calls", "grids", "park_s", "engine_s",
               "engine_failovers", "engine_retries")


@dataclass
class State:
    cell: harness.Cell
    runner: Any
    batches: List[Dict[str, Any]] = field(default_factory=list)
    layers: Dict[str, Any] = field(default_factory=dict)
    window_launches: Dict[str, int] = field(default_factory=dict)


class _Capture:
    """Keeps each simulator run's finished jobs, keyed by the task's
    fingerprint: ``run_task`` is wrapped to name the running task on its
    thread, and ``Simulator.run`` to keep its result's jobs."""

    def __init__(self):
        self.local = threading.local()
        self.jobs: Dict[str, List[Any]] = {}
        self.lock = threading.Lock()

    def install(self) -> None:
        from repro_torch.eval import runner
        from repro_torch.sim import simulator
        if getattr(runner.run_task, "_bench_capture", False):
            return
        run_task, run = runner.run_task, simulator.Simulator.run
        cap = self

        def run_task_named(task, *args, **kw):
            cap.local.fp = task.fingerprint()
            return run_task(task, *args, **kw)

        def run_kept(sim):
            res = run(sim)
            with cap.lock:
                cap.jobs[cap.local.fp] = res.jobs
            return res

        run_task_named._bench_capture = True
        runner.run_task = run_task_named
        simulator.Simulator.run = run_kept


CAPTURE = _Capture()


def tasks(config: Dict, traffic: Dict, seed0: int, first: int,
          runs: int, num_jobs: int) -> List[Any]:
    """Runs ``first .. first+runs-1`` of the sweep rooted at ``seed0``."""
    from repro_torch.eval import make_tasks
    return make_tasks([(config["name"], config["policy"],
                        config["policy_kw"])], first + runs, num_jobs,
                      traffic["load"], seed0,
                      trace_kw=traffic.get("trace_kw"),
                      sim_kw=traffic.get("sim_kw"),
                      scenario=traffic.get("scenario"))[first:]


def batch_tasks(cell: harness.Cell, b: int) -> List[Any]:
    n = cell.traffic["batch_runs"]
    return tasks(cell.config, cell.traffic, cell.seed, b * n, n,
                 cell.traffic["num_jobs"])


def make_runner(cell: harness.Cell):
    from repro_torch.core.engineconfig import EngineConfig
    from repro_torch.eval import EvalRunner
    engine = EngineConfig(cell.config["engine"], device=cell.device)
    return EvalRunner(checkpoint_dir=None, workers=0, engine=engine)


def prepare(cell: harness.Cell) -> State:
    CAPTURE.install()
    runner = make_runner(cell)
    traffic = cell.traffic
    runner.run(tasks(cell.config, traffic, cell.seed + WARM_ROOT, 0,
                     traffic["warm_runs"], traffic["warm_jobs"]))
    CAPTURE.jobs.clear()
    return State(cell=cell, runner=runner)


def measure(state: State, seconds: float) -> Dict[str, float]:
    on_card = state.cell.device is None
    before = kernels.launch_counts()
    t0 = time.perf_counter()
    while True:
        CAPTURE.jobs.clear()
        t_batch = time.perf_counter()
        batch = batch_tasks(state.cell, len(state.batches))
        records = state.runner.run(batch)
        # Each run's schedule is kept as one string: thousands of live
        # job objects would add to every later garbage collection of
        # the program in the window.
        jobs = {fp: schedule_json(js) for fp, js in CAPTURE.jobs.items()}
        CAPTURE.jobs.clear()
        state.batches.append({"tasks": batch, "records": records,
                              "jobs": jobs,
                              "stats": state.runner.last_stats,
                              "wall_s": time.perf_counter() - t_batch})
        if time.perf_counter() - t0 >= seconds:
            break
    if on_card:
        import torch
        torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    state.window_launches = kernels.delta(before, kernels.launch_counts())
    n_jobs = sum(len(b["records"]) for b in state.batches) \
        * state.cell.traffic["num_jobs"]
    broker = {k: 0.0 for k in BROKER_SUMS}
    for b in state.batches:
        fleet = b["stats"].get("fleet", {}).get("broker", {})
        for k in BROKER_SUMS:
            broker[k] += fleet.get(k, 0) or 0
    state.layers.update({
        "cell": state.cell.name, "window_s": elapsed, "jobs": n_jobs,
        "sim_s": sum(r["sim_s"] for b in state.batches
                     for r in b["records"]),
        "broker": broker, "launches": state.window_launches,
        "fleets": [b["stats"].get("fleet") for b in state.batches]})
    return {"jobs_per_s": n_jobs / elapsed}


def compare(batches: List[Dict[str, Any]], num_jobs: int, checked: int,
            seed: int) -> harness.Verdict:
    """Every run of every batch has to have come back with its record and
    all ``num_jobs`` jobs; ``checked`` of them, drawn from ``seed``, are
    replayed by the reference and compared record and job by job."""
    from bench.reference.runs import reference_run
    runs = []
    for b in batches:
        by_fp = {r["fingerprint"]: r for r in b.get("records") or []}
        for task in b["tasks"]:
            fp = task.fingerprint()
            runs.append((task, by_fp.get(fp), b["jobs"].get(fp)))
    missing = {i for i, (_, rec, jobs) in enumerate(runs)
               if rec is None or jobs is None
               or len(json.loads(jobs)) != num_jobs}
    pick = np.random.default_rng(seed).permutation(len(runs))[:checked]
    differing_runs, differing_jobs = set(), 0
    for i in sorted(int(i) for i in pick):
        task, rec, jobs = runs[i]
        ref_rec, ref_jobs = reference_run(
            task.policy, task.policy_kw, task.seed, task.num_jobs, task.load,
            trace_kw=task.trace_kw, sim_kw=task.sim_kw,
            scenario=task.scenario)
        ref_rows = schedule_rows(ref_jobs)
        if rec is None or jobs is None:
            differing_runs.add(i)
            differing_jobs += len(ref_rows)
            continue
        rows = [tuple(r) for r in json.loads(jobs)]
        bad = sum(a != r for a, r in zip(rows, ref_rows)) \
            + abs(len(rows) - len(ref_rows))
        same_rec = all(
            json.dumps(rec.get(k), sort_keys=True)
            == json.dumps(ref_rec.get(k), sort_keys=True)
            for k in ("summary", "cdf_levels", "cdf", "chaos"))
        differing_jobs += bad
        if bad or not same_rec:
            differing_runs.add(i)
    v = harness.Verdict(attempted=len(runs),
                        failed=len(missing | differing_runs))
    v.checks["runs_missing"] = harness.Check(len(missing), 0)
    v.checks["runs_differing"] = harness.Check(len(differing_runs), 0)
    v.checks["jobs_differing"] = harness.Check(differing_jobs, 0)
    return v


def check(state: State) -> harness.Verdict:
    traffic = state.cell.traffic
    v = compare(state.batches, traffic["num_jobs"], traffic["checked_runs"],
                state.cell.seed)
    v.checks["broker_failovers"] = harness.Check(
        state.layers["broker"]["engine_failovers"], 0)
    if state.cell.require_card:
        for k in state.cell.config["kernels_required"]:
            v.checks[f"{k}_launches"] = harness.Check(
                kernels.launches_of(state.window_launches, k), 1,
                at_most=False)
    walls = ", ".join(f"{b['wall_s']:.3f}" for b in state.batches)
    v.notes.append(f"{len(state.batches)} batches of "
                   f"{traffic['batch_runs']} runs x {traffic['num_jobs']} "
                   f"jobs, traces of seeds {state.cell.seed} onwards; batch "
                   f"walls {walls} s")
    return v
