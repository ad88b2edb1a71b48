"""The benchmark's harness: cells found by name from files alone, the
cells of ``BENCHMARK.json`` run end to end on the CPU at small sizes,
the import rules, and the refusals (no card, only the benchmark's own
files).

The CPU runs skip the look for a card and run the ``cuda`` engine on
``device="cpu"`` (the kernels' plain versions), so they prove the
control flow and the comparison, not a speed.
"""
from __future__ import annotations

import ast
import json
import os
import shutil
import subprocess
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

from bench_test_cells import SPEC as FULL  # noqa: E402
from bench_test_cells import small_cell  # noqa: E402

torch.set_num_threads(1)
BENCH = ROOT / "bench"


@pytest.mark.parametrize("name", [w["name"] for w in FULL["workloads"]])
def test_cell_runs_correct_on_cpu(name, restore_program):
    cell = small_cell(FULL, name, num_jobs=40)
    result, verdict = harness.run_cell(FULL, cell, 1.0, time.perf_counter())
    assert verdict.correct, result["checks"]
    assert result["correct"] is True and result["attempted"] > 0
    want = {m["name"] for m in harness.metrics_for(FULL, "end_to_end", name)}
    assert set(result["metrics"]) == want
    assert all(v["value"] > 0 for v in result["metrics"].values())
    assert list(result)[-1] == "checks"
    assert all(c["value"] <= c["limit"] for c in result["checks"].values())


@pytest.mark.parametrize("name", [w["name"] for w in FULL["workloads"]])
def test_traced_run_reads_host_layers(name, restore_program):
    """On the CPU the profiler records no device: the device metrics find
    nothing and are left out; the program's counters are read."""
    cell = small_cell(FULL, name, trace=True, num_jobs=40)
    result, verdict = harness.run_cell(FULL, cell, 1.0, time.perf_counter())
    assert verdict.correct
    names = {m["name"] for m in harness.metrics_for(FULL, "per_layer", name)}
    got = set(result["metrics"])
    assert got <= names
    assert not any(n.startswith(("device_idle", "fitmask.")) for n in got)
    host = {n for n in names if not n.startswith(("device_idle", "fitmask."))}
    assert host <= got
    assert result["device"]["window_s"] > 0
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("name", [w["name"] for w in FULL["workloads"]])
def test_sweep_batches_run_fresh_traces_of_the_seed(name):
    """Batch after batch runs the next traces of the sweep rooted at
    ``--seed``; the warm-up's traces are none of them."""
    cell = small_cell(FULL, name, seed=2**31 + 11)
    sweep = harness.driver_module(cell)
    n = cell.traffic["batch_runs"]
    seeds = [t.seed for b in range(3) for t in sweep.batch_tasks(cell, b)]
    assert seeds == list(range(cell.seed, cell.seed + 3 * n))
    warm = sweep.tasks(cell.config, cell.traffic,
                       cell.seed + sweep.WARM_ROOT, 0,
                       cell.traffic["warm_runs"], cell.traffic["warm_jobs"])
    assert not {t.seed for t in warm} & set(seeds)
    assert all(t.num_jobs == cell.traffic["warm_jobs"] for t in warm)


TOY_DRIVER = '''
from dataclasses import dataclass, field
from bench import harness


@dataclass
class State:
    n: int
    layers: dict = field(default_factory=dict)


def prepare(cell):
    return State(n=cell.traffic["count"] * cell.config["scale"])


def measure(state, seconds):
    state.layers["widgets"] = state.n
    return {"widgets_per_s": state.n / max(seconds, 1e-9)}


def check(state):
    v = harness.Verdict(attempted=state.n, failed=0)
    v.checks["widgets_wrong"] = harness.Check(0, 0)
    return v
'''


def test_new_cell_from_new_files_only(tmp_path):
    """A configuration, a traffic mix, a driver and a per-layer metric,
    each a new file, run as a cell without any file of the harness
    changed."""
    bench = tmp_path / "bench"
    for sub in ("configs", "traffic", "drivers", "metrics"):
        (bench / sub).mkdir(parents=True)
    (bench / "configs" / "toy-cfg.json").write_text(json.dumps({"scale": 3}))
    (bench / "traffic" / "toymix.json").write_text(
        json.dumps({"driver": "toy", "count": 5}))
    (bench / "drivers" / "toy.py").write_text(TOY_DRIVER)
    (bench / "metrics" / "widgets.count.py").write_text(
        "def read(ctx):\n    return ctx.get('widgets')\n")
    spec = {
        "configs": [{"name": "toy-cfg"}],
        "workloads": [{"name": "toy-cfg.toymix", "config": "toy-cfg",
                       "traffic": "toymix", "chips": 1}],
        "end_to_end": [
            {"name": "widgets_per_s", "unit": "widgets/s",
             "workloads": ["toy-cfg.toymix"]},
            {"name": "setup_s", "unit": "s"}],
        "per_layer": [{"name": "widgets.count", "unit": "widgets",
                       "workloads": ["toy-cfg.toymix"]},
                      {"name": "absent.metric", "unit": "s",
                       "workloads": ["other.cell"]}]}
    for trace in (False, True):
        cell = harness.load_cell(spec, "toy-cfg.toymix", 1, trace,
                                 bench=bench)
        cell.device, cell.require_card = "cpu", False
        cell.forbid_modules = False
        result, verdict = harness.run_cell(spec, cell, 0.5,
                                           time.perf_counter(), bench=bench)
        assert verdict.correct
        if trace:
            assert result["metrics"] == {
                "widgets.count": {"value": 15, "unit": "widgets"}}
        else:
            assert set(result["metrics"]) == {"widgets_per_s", "setup_s"}
            assert result["metrics"]["widgets_per_s"]["value"] == 30


FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_module_imports_jax_or_the_jax_package():
    files = [p for p in BENCH.rglob("*.py")]
    assert files
    for path in files:
        bad = set(_imports(path)) & FORBIDDEN
        assert not bad, f"{path} imports {bad}"


def test_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").rglob("*.py"):
        mods = set(_imports(path))
        assert not mods & ({"repro_torch", "torch", "bench"} | FORBIDDEN), \
            f"{path} imports {mods}"


def test_forbidden_modules_compared_by_whole_name(monkeypatch):
    """``repro_torch`` begins with ``repro`` and is allowed; ``repro``,
    ``jax`` and their submodules are not."""
    for name in [m for m in sys.modules
                 if m.split(".")[0] in FORBIDDEN]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "repro_torch_extra", object())
    assert "repro_torch" in sys.modules
    assert harness.forbidden_loaded() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    monkeypatch.setitem(sys.modules, "repro.core", object())
    assert harness.forbidden_loaded() == ["jax", "repro"]


def _run_py(cwd: Path, extra_env=None):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(extra_env or {})
    return subprocess.run(
        [sys.executable, "bench/run.py", "--workload",
         "rfold-4096-c4.sweep", "--seed", "3", "--seconds", "1",
         "--trace", "0"], cwd=cwd, env=env, capture_output=True, text=True,
        timeout=120)


def test_run_without_a_card_fails_with_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the run would measure")
    proc = _run_py(ROOT)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "no CUDA card" in proc.stderr


def test_run_with_only_the_benchmark_files_fails(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = _run_py(tmp_path, {"CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
