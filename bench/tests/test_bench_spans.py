"""The readers of the program's spans and counters (``bench/metrics/``:
``reconfig.search_ms_per_job``, ``torus.box_ms_per_job``,
``folding.fold_ms_per_job``, ``folding.miss_share``,
``fitmask.host_us_per_launch``, ``host.gc_share``) on a traced CPU run of
each cell: a number where the window's fleets carry the program's
spans, ``None`` where they carry none (a program without them), and the
launch-based reader ``None`` where no kernel was launched (the CPU)."""
from __future__ import annotations

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

from bench_test_cells import SPEC  # noqa: E402
from bench_test_cells import small_cell  # noqa: E402

torch.set_num_threads(1)
BENCH = ROOT / "bench"
SPAN_METRICS = ("reconfig.search_ms_per_job", "torus.box_ms_per_job",
                "folding.fold_ms_per_job", "folding.miss_share",
                "fitmask.host_us_per_launch", "host.gc_share")
LAYER = {"reconfig.search_ms_per_job": "reconfig.",
         "torus.box_ms_per_job": "torus."}


def reader(name):
    return harness.load_module(BENCH / "metrics" / f"{name}.py").read


@pytest.fixture
def traced_ctx(monkeypatch):
    """Runs a traced CPU cell through ``harness.run_cell`` and keeps the
    context its readers were given."""
    from repro_torch.eval import runner
    from repro_torch.sim import simulator
    saved = runner.run_task, simulator.Simulator.run
    kept = {}
    read_layers = harness.read_layers

    def keep(spec, cell, ctx, bench=BENCH):
        kept["ctx"] = ctx
        return read_layers(spec, cell, ctx, bench)

    monkeypatch.setattr(harness, "read_layers", keep)

    def run(name):
        cell = small_cell(SPEC, name, trace=True, num_jobs=40)
        result, verdict = harness.run_cell(SPEC, cell, 1.0,
                                           time.perf_counter())
        assert verdict.correct, result["checks"]
        return result, kept["ctx"]
    yield run
    runner.run_task, simulator.Simulator.run = saved


@pytest.mark.parametrize("name", [w["name"] for w in SPEC["workloads"]])
def test_span_readers_on_a_traced_cpu_run(name, traced_ctx):
    result, ctx = traced_ctx(name)
    listed = {m["name"] for m in harness.metrics_for(SPEC, "per_layer", name)}
    for metric in set(SPAN_METRICS) & listed:
        if metric == "fitmask.host_us_per_launch":
            # No kernel runs on the CPU: nothing to divide by.
            assert metric not in result["metrics"]
            continue
        value = result["metrics"][metric]["value"]
        assert value >= 0, metric
        if metric in LAYER:
            assert value > 0, metric
    assert 0 <= result["metrics"]["folding.miss_share"]["value"] <= 1
    assert result["metrics"]["host.gc_share"]["value"] < 1
    # The cell's own layer: RFold has no static torus, Folding no cubes.
    other = ("torus.box_ms_per_job" if name.startswith("rfold")
             else "reconfig.search_ms_per_job")
    assert other not in listed
    assert reader(other)(ctx) == 0.0


@pytest.mark.parametrize("name", [w["name"] for w in SPEC["workloads"]])
def test_fitmask_host_reader_divides_by_launches(name, traced_ctx):
    _, ctx = traced_ctx(name)
    assert not sum(ctx["launches"].values())
    assert reader("fitmask.host_us_per_launch")(ctx) is None
    fitmask_s = sum(s["self_s"] for f in ctx["fleets"]
                    for n, s in f["trace"]["spans"].items()
                    if n.startswith("fitmask."))
    assert fitmask_s > 0
    launched = dict(ctx, launches={"fitmask_multibox_bucketed": 250})
    got = reader("fitmask.host_us_per_launch")(launched)
    assert got == pytest.approx(fitmask_s / 250 * 1e6)


@pytest.mark.parametrize("name", [w["name"] for w in SPEC["workloads"]])
def test_span_readers_find_nothing_without_the_programs_spans(
        name, traced_ctx):
    """A program whose fleets carry no ``trace`` (one without the spans)
    gives every span reader nothing to read, and the readers do not
    raise."""
    _, ctx = traced_ctx(name)
    bare = dict(ctx, fleets=[{k: v for k, v in f.items() if k != "trace"}
                             for f in ctx["fleets"]],
                launches={"fitmask_multibox_bucketed": 250})
    for metric in SPAN_METRICS:
        assert reader(metric)(bare) is None, metric
    assert reader("host.gc_share")(dict(bare, fleets=[])) is None
