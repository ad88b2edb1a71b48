"""The reader of the cube search's fused refreshes
(``bench/metrics/reconfig.fused_share.py``) on traced CPU runs: near 1
in RFold, where every refresh after a torus's first asks for its stacked
masks first and the broker answers the free counts from its cache;
nothing in Folding, which asks for no free counts, nor from fleets that
carry no broker counts."""
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
METRIC = "reconfig.fused_share"
read = harness.load_module(ROOT / "bench" / "metrics"
                           / f"{METRIC}.py").read


def traced_run(name, monkeypatch):
    """A traced CPU run of cell ``name``: its result and the context its
    readers were given."""
    from repro_torch.eval import runner
    from repro_torch.sim import simulator
    monkeypatch.setattr(runner, "run_task", runner.run_task)
    monkeypatch.setattr(simulator.Simulator, "run", simulator.Simulator.run)
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


def test_fused_share_listed_for_rfold_alone():
    listed = {w["name"] for w in SPEC["workloads"]
              if METRIC in {m["name"] for m in
                            harness.metrics_for(SPEC, "per_layer",
                                                w["name"])}}
    assert listed == {"rfold-4096-c4.sweep"}


@pytest.mark.parametrize("name", [w["name"] for w in SPEC["workloads"]])
def test_fused_share_on_a_traced_cpu_run(name, monkeypatch):
    result, ctx = traced_run(name, monkeypatch)
    if name.startswith("rfold"):
        # A torus's first refresh has no stacked mask: its counts miss
        # the broker's cache.
        assert 0.9 <= result["metrics"][METRIC]["value"] < 1
    else:
        assert METRIC not in result["metrics"]
        assert read(ctx) is None
    # Fleets without the broker's count-cache counters, or without
    # broker stats at all, read as nothing and do not raise.
    bare = dict(ctx, fleets=[
        dict(f, broker={k: v for k, v in f["broker"].items()
                        if not k.startswith("fc_cache")})
        for f in ctx["fleets"]])
    assert read(bare) is None
    assert read(dict(ctx, fleets=[{k: v for k, v in f.items()
                                   if k != "broker"}
                                  for f in ctx["fleets"]])) is None
    assert read(dict(ctx, fleets=[None])) is None
