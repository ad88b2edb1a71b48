"""A new deployment enters the benchmark through new files and appended
entries alone: a copy of ``bench/`` and ``BENCHMARK.json`` gains a
configuration or traffic file and one entry at the end of ``configs``
and ``workloads``; nothing that was there changes, and the new cell runs
correct on the CPU and reports the benchmark's end-to-end metrics.

The runs skip the look for a card and run the ``cuda`` engine on
``device="cpu"`` (the kernels' plain versions).
"""
from __future__ import annotations

import copy
import json
import shutil
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

from bench_test_cells import SMALL_TRACE, SPEC, small_cell  # noqa: E402

torch.set_num_threads(1)
BENCH = ROOT / "bench"
RFOLD = harness.load_json(BENCH / "configs" / "rfold-4096-c4.json")
SWEEP = harness.load_json(BENCH / "traffic" / "sweep.json")


def _config(name, **changes):
    return {**RFOLD, "name": name, **changes}


# Each case: the workload's name, a new configuration file or the name
# of one that is there, a new traffic file or the name of one that is
# there, and the cut the CPU run must give its policy and its traces.
CASES = {
    "reconfig": (
        "reconfig-4096-c4.sweep",
        _config("reconfig-4096-c4", policy="reconfig",
                policy_kw={"num_xpus": 4096, "cube_n": 4}),
        "sweep",
        {"num_xpus": 512, "cube_n": 4}, SMALL_TRACE),
    "node_churn": (
        "rfold-4096-c4.churn",
        "rfold-4096-c4",
        {**SWEEP, "name": "churn", "scenario": "node_churn"},
        {"num_xpus": 512, "cube_n": 4}, SMALL_TRACE),
    "cube_n_8": (
        "rfold-4096-c8.sweep",
        _config("rfold-4096-c8",
                cluster={**RFOLD["cluster"], "cube": [8, 8, 8], "cubes": 8},
                policy_kw={"num_xpus": 4096, "cube_n": 8}),
        "sweep",
        {"num_xpus": 512, "cube_n": 8}, SMALL_TRACE),
    "own_trace_kw": (
        "folding-4096-static.corr",
        "folding-4096-static",
        {**SWEEP, "name": "corr", "trace_kw": {"size_duration_corr": 0.5}},
        {"dims": [8, 8, 8]}, {"size_duration_corr": 0.5, **SMALL_TRACE}),
}


def add_cell(tmp: Path, workload: str, config, traffic):
    """Copy the benchmark to ``tmp``, write the case's new files and
    append its entries; returns the spec before and after."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = harness.benchmark_spec(tmp)
    before = copy.deepcopy(spec)
    if isinstance(config, dict):
        path = tmp / "bench" / "configs" / f"{config['name']}.json"
        assert not path.exists()
        path.write_text(json.dumps(config))
        spec["configs"].append({
            "name": config["name"], "source": config["source"],
            "file": f"bench/configs/{config['name']}.json", "reduced": [],
            "why": f"{config['policy']} on {config['policy_kw']}"})
        config = config["name"]
    if isinstance(traffic, dict):
        path = tmp / "bench" / "traffic" / f"{traffic['name']}.json"
        assert not path.exists()
        path.write_text(json.dumps(traffic))
        traffic = traffic["name"]
    spec["workloads"].append({"name": workload, "config": config,
                              "traffic": traffic, "chips": 1,
                              "why": "a cell added by data alone"})
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec, indent=2))
    return before, harness.benchmark_spec(tmp)


@pytest.mark.parametrize("case", list(CASES))
def test_cell_from_new_files_and_appended_entries(case, tmp_path,
                                                  restore_program):
    workload, config, traffic, policy_kw, trace_kw = CASES[case]
    before, spec = add_cell(tmp_path, workload, config, traffic)
    for key, value in before.items():
        if isinstance(value, list):
            assert spec[key][:len(value)] == value
        else:
            assert spec[key] == value
    assert len(spec["workloads"]) == len(before["workloads"]) + 1

    cell = small_cell(spec, workload, num_jobs=40, bench=tmp_path / "bench")
    assert cell.config["policy_kw"] == policy_kw
    assert cell.traffic["trace_kw"] == trace_kw
    result, verdict = harness.run_cell(spec, cell, 1.0, time.perf_counter(),
                                       bench=tmp_path / "bench")
    assert verdict.correct, result["checks"]
    assert result["correct"] is True and result["attempted"] > 0
    assert set(result["metrics"]) == {"jobs_per_s", "setup_s"}
    assert all(v["value"] > 0 for v in result["metrics"].values())


@pytest.mark.parametrize("name, policy_kw", [
    ("rfold-4096-c4.sweep", {"num_xpus": 512, "cube_n": 4}),
    ("folding-4096-static.sweep", {"dims": [8, 8, 8]}),
])
def test_existing_cells_keep_their_cut(name, policy_kw):
    cell = small_cell(SPEC, name, num_jobs=40)
    assert cell.config["policy_kw"] == policy_kw
    assert cell.traffic["trace_kw"] == SMALL_TRACE
    assert (cell.traffic["num_jobs"], cell.traffic["load"],
            cell.traffic["warm_jobs"]) == (40, 2.0, 20)

