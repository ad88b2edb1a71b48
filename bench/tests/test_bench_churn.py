"""The churn deployment (``rfold-4096-c4-churn.churn``) on the CPU, cut
by ``small_cell``'s one rule to 512 XPUs: the cell runs correct traced,
``chaos.ms_per_event`` reads its chaos spans there and nothing in a
healthy cell, a seeded run of the cut cell both migrates and re-queues
its victims and equals the reference's replay job by job, and the
configuration's ``faults`` block states the regime its traffic runs.

The runs skip the look for a card and run the ``cuda`` engine on
``device="cpu"`` (the kernels' plain versions).
"""
from __future__ import annotations

import dataclasses
import inspect
import json
import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from bench import harness  # noqa: E402
from bench.compare import schedule_rows  # noqa: E402
from bench.reference.runs import reference_run  # noqa: E402

from bench_test_cells import SPEC, small_cell  # noqa: E402

torch.set_num_threads(1)
BENCH = ROOT / "bench"
CELL = "rfold-4096-c4-churn.churn"
HEALTHY = "rfold-4096-c4.sweep"
METRIC = "chaos.ms_per_event"
read = harness.load_module(BENCH / "metrics" / f"{METRIC}.py").read


def traced_run(name, monkeypatch):
    """A traced CPU run of cell ``name``: its result and the context its
    readers were given."""
    kept = {}
    read_layers = harness.read_layers

    def keep(spec, cell, ctx, bench=harness.BENCH):
        kept["ctx"] = ctx
        return read_layers(spec, cell, ctx, bench)

    monkeypatch.setattr(harness, "read_layers", keep)
    cell = small_cell(SPEC, name, trace=True, num_jobs=40)
    result, verdict = harness.run_cell(SPEC, cell, 1.0, time.perf_counter())
    assert verdict.correct, result["checks"]
    return result, kept["ctx"]


def test_churn_cell_runs_correct_traced(monkeypatch, restore_program):
    result, ctx = traced_run(CELL, monkeypatch)
    assert result["correct"] is True
    assert result["checks"]["runs_differing"]["value"] == 0
    assert result["checks"]["jobs_differing"]["value"] == 0
    assert result["metrics"][METRIC]["value"] > 0
    events = sum(f["trace"]["counters"]["chaos.events"]
                 for f in ctx["fleets"])
    assert events > 0 and events % 2 == 0   # each fault is repaired
    assert sum(f["trace"]["counters"].get("chaos.evicted", 0)
               for f in ctx["fleets"]) > 0
    # Without the program's traces, or with no fleet, nothing is read.
    assert read(dict(ctx, fleets=[{k: v for k, v in f.items()
                                   if k != "trace"}
                                  for f in ctx["fleets"]])) is None
    assert read(dict(ctx, fleets=[None])) is None
    assert read(dict(ctx, fleets=[])) is None


def test_healthy_cell_reads_no_chaos(monkeypatch, restore_program):
    result, ctx = traced_run(HEALTHY, monkeypatch)
    assert METRIC not in result["metrics"]
    assert read(ctx) is None


def _cell_run(cell, seed):
    """Run 0 of the cut cell's sweep rooted at ``seed``, through the
    sweep driver's tasks and the port's ``cuda`` engine on the CPU: its
    record and its simulator's jobs."""
    from repro_torch.core.engineconfig import EngineConfig
    from repro_torch.eval import run_task
    from repro_torch.sim import simulator
    driver = harness.driver_module(cell)
    task = driver.tasks(cell.config, cell.traffic, seed, 0, 1,
                        cell.traffic["num_jobs"])[0]
    kept = []
    run = simulator.Simulator.run

    def keep(sim):
        res = run(sim)
        kept.append(res.jobs)
        return res

    simulator.Simulator.run = keep
    try:
        rec = run_task(task, engine=EngineConfig("cuda", device="cpu"))
    finally:
        simulator.Simulator.run = run
    return task, rec, kept[0]


@pytest.mark.parametrize("seed", [2**31 + 11, 987_654_321_098])
def test_cut_cell_migrates_and_requeues(seed, restore_program):
    cell = small_cell(SPEC, CELL, num_jobs=60)
    task, rec, jobs = _cell_run(cell, seed)
    chaos = rec["chaos"]
    assert chaos["faults"] == chaos["repairs"] == 6
    assert chaos["victims"] > 0
    assert chaos["migrated"] > 0 and chaos["preempted"] > 0
    assert chaos["victims"] == chaos["migrated"] + chaos["preempted"]
    assert sum(j.migrations for j in jobs) == chaos["migrated"]
    assert sum(j.preemptions for j in jobs) == chaos["preempted"]
    ref, ref_jobs = reference_run(task.policy, task.policy_kw, task.seed,
                                  task.num_jobs, task.load,
                                  trace_kw=task.trace_kw, sim_kw=task.sim_kw,
                                  scenario=task.scenario)
    for key in ("summary", "cdf_levels", "cdf", "chaos"):
        assert json.dumps(rec.get(key), sort_keys=True) == \
            json.dumps(ref.get(key), sort_keys=True), key
    assert schedule_rows(jobs) == schedule_rows(ref_jobs)


def _faults_of(scenarios, faults, simulator, name, sim_kw):
    """The regime that scenario ``name`` runs, in the shape of a
    configuration's ``faults`` block."""
    sc = scenarios.SCENARIOS[name]
    cfg = dataclasses.asdict(faults.FaultConfig(**sc.fault_kw))
    cfg.pop("seed")
    cfg["window"] = list(cfg["window"])
    mode = inspect.signature(simulator.Simulator).parameters["fault_mode"]
    kw = {**(sim_kw or {}), **sc.sim_kw}
    return {"scenario": name, **cfg,
            "fault_mode": kw.get("fault_mode", mode.default)}


def _faulted_workloads():
    out = []
    for w in SPEC["workloads"]:
        cell = harness.load_cell(SPEC, w["name"], 0, False)
        if "faults" in cell.config:
            out.append((w["name"], cell))
    return out


def test_the_churn_cell_declares_its_faults():
    assert [n for n, _ in _faulted_workloads()] == [CELL]


@pytest.mark.parametrize("side", ["program", "reference"])
def test_declared_faults_are_the_traffics(side):
    """A configuration that declares ``faults.scenario`` is run only by
    traffic with that scenario, and its numbers are the scenario's
    ``FaultConfig`` fields (the seed aside) and fault mode, in the port
    and in the benchmark's reference alike."""
    if side == "program":
        from repro_torch.sim import faults, scenarios, simulator
    else:
        from bench.reference import faults, scenarios, simulator
    for name, cell in _faulted_workloads():
        declared = cell.config["faults"]
        assert cell.traffic["scenario"] == declared["scenario"], name
        assert declared == _faults_of(scenarios, faults, simulator,
                                      declared["scenario"],
                                      cell.traffic.get("sim_kw")), name
