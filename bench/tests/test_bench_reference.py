"""The benchmark's frozen reference against the port's host path.

The reference (``bench/reference``) is a copy of the scheduler's host
code that the benchmark judges the card's runs by. These tests hold it
to the port's ``numpy`` engine at small sizes, for each configuration's
policy, healthy and under node churn.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from bench.compare import schedule_rows  # noqa: E402
from bench.reference.runs import reference_run  # noqa: E402

torch.set_num_threads(1)

POLICIES = [("rfold", {"num_xpus": 512, "cube_n": 4}),
            ("folding", {"dims": [8, 8, 8]})]
TRACE_KW = {"cluster_xpus": 512}


def _program_run(policy, kw, seed, scenario):
    """The port's eval task on ``numpy``, with its simulator's jobs."""
    from repro_torch.core.engineconfig import EngineConfig
    from repro_torch.eval import make_tasks, run_task
    from repro_torch.sim import simulator

    kept = []
    run = simulator.Simulator.run

    def keep(sim):
        res = run(sim)
        kept.append(res.jobs)
        return res

    task = make_tasks([(policy, policy, kw)], 1, 60, 1.5, seed,
                      trace_kw=TRACE_KW, scenario=scenario)[0]
    simulator.Simulator.run = keep
    try:
        rec = run_task(task, engine=EngineConfig("numpy"))
    finally:
        simulator.Simulator.run = run
    return rec, kept[0]


@pytest.mark.parametrize("policy,kw", POLICIES, ids=["rfold", "folding"])
@pytest.mark.parametrize("scenario", [None, "node_churn"],
                         ids=["healthy", "node_churn"])
@pytest.mark.parametrize("seed", [0, 7])
def test_reference_run_equals_port_numpy(policy, kw, scenario, seed):
    rec, jobs = _program_run(policy, kw, seed, scenario)
    ref, ref_jobs = reference_run(policy, kw, seed, 60, 1.5,
                                  trace_kw=TRACE_KW, scenario=scenario)
    for key in ("summary", "cdf_levels", "cdf", "chaos"):
        assert json.dumps(rec.get(key), sort_keys=True) == \
            json.dumps(ref.get(key), sort_keys=True), key
    assert schedule_rows(jobs) == schedule_rows(ref_jobs)
