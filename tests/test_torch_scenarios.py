"""Port parity for the named chaos scenarios, mirroring
``tests/test_scenarios.py``, and for the chaos bench's matrix.

Each record of ``repro_torch.sim.scenarios.run_scenario`` is
``json.dumps(..., sort_keys=True)``-equal to ``repro``'s for the same
cell: every scenario x the five policies at 512 XPUs, on the ``numpy``
engine and on the ``cuda`` and ``torch`` engines on the CPU. The
reference test's guarantees are held on the port's records: byte
determinism, each scenario doing what its name promises, and consistent
degradation metrics.
"""
import importlib.util
import json
import math
import os

import pytest
import torch

from repro.sim import scenarios as ref_scenarios
from repro_torch.core.engineconfig import EngineConfig
from repro_torch.sim.scenarios import (SCENARIOS, Scenario, _fault_seed,
                                       fault_schedule, run_scenario)
from repro_torch.traces.generator import TraceConfig, generate_trace

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

ENGINES = {
    "numpy": EngineConfig("numpy"),
    "cuda-on-cpu": EngineConfig("cuda", device="cpu"),
    "torch-on-cpu": EngineConfig("torch", device="cpu"),
}
RFOLD_4096 = dict(num_xpus=4096, cube_n=4)


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


chaos_bench = _load(os.path.join(ROOT, "benchmarks_torch", "chaos_bench.py"),
                    "torch_chaos_bench")


def dumps(rec):
    return json.dumps(rec, sort_keys=True)


def _record(name, engine="cuda-on-cpu", policy="rfold", policy_kw=None,
            **kw):
    """The reference test's record: 60 jobs, seed 0, RFold at 4096 XPUs
    unless ``policy_kw`` says otherwise, on ``engine``."""
    policy_kw = dict(policy_kw or RFOLD_4096, engine=ENGINES[engine])
    return run_scenario(SCENARIOS[name], policy=policy, policy_kw=policy_kw,
                        num_jobs=60, seed=0, **kw)


@pytest.fixture(scope="module")
def reference_records():
    """``repro``'s record of each scenario x policy cell of the chaos
    bench at 512 XPUs, 60 jobs, seed 0."""
    return {(sc, key): ref_scenarios.run_scenario(
        sc, policy=policy, policy_kw=dict(kw, engine="numpy"), num_jobs=60,
        seed=0, trace_kw=dict(chaos_bench.TRACE_KW))
        for sc in sorted(SCENARIOS)
        for key, _, policy, kw in chaos_bench.POLICY_CONFIGS}


def test_catalog_has_the_five_named_scenarios():
    assert sorted(SCENARIOS) == ["bursty", "healthy", "multi_tenant",
                                 "node_churn", "ocs_degraded"]
    for name, sc in SCENARIOS.items():
        assert isinstance(sc, Scenario) and sc.name == name
        assert sc.description
        ref = ref_scenarios.SCENARIOS[name]
        assert (sc.description, sc.trace_kw, sc.fault_kw, sc.sim_kw) == \
            (ref.description, ref.trace_kw, ref.fault_kw, ref.sim_kw)


@pytest.mark.parametrize("engine", sorted(ENGINES))
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_matrix_records_equal_the_references(reference_records, name,
                                             engine):
    """Every policy of the chaos bench under ``name`` at 512 XPUs: the
    port's record is the reference's, byte for byte."""
    for key, _, policy, kw in chaos_bench.POLICY_CONFIGS:
        got = run_scenario(name, policy=policy,
                           policy_kw=dict(kw, engine=ENGINES[engine]),
                           num_jobs=60, seed=0,
                           trace_kw=dict(chaos_bench.TRACE_KW))
        assert dumps(got) == dumps(reference_records[(name, key)]), key


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_records_byte_deterministic(name):
    a = dumps(_record(name))
    b = dumps(_record(name))
    assert a == b
    assert a == dumps(ref_scenarios.run_scenario(
        name, policy_kw=dict(RFOLD_4096, engine="numpy"), num_jobs=60,
        seed=0))


def test_fault_schedules_and_seeds_equal_the_references():
    """The same (scenario, seed) fails the same cells at the same times
    in both packages, on the static and the reconfigurable model."""
    from repro.core.allocator import make_policy as ref_make_policy
    from repro_torch.core.allocator import make_policy
    jobs = generate_trace(TraceConfig(num_jobs=60, seed=5))
    for name in sorted(SCENARIOS):
        assert _fault_seed(5, name) == ref_scenarios._fault_seed(5, name)
        for policy, kw in (("folding", dict(dims=(16, 16, 16))),
                           ("rfold", RFOLD_4096)):
            pol = make_policy(policy, engine="numpy", **kw)
            ref = ref_make_policy(policy, engine="numpy", **kw)
            got = fault_schedule(name, getattr(pol, "cluster", None)
                                 or pol.torus, jobs, 5)
            want = ref_scenarios.fault_schedule(
                name, getattr(ref, "cluster", None) or ref.torus, jobs, 5)
            assert [e.to_wire() for e in got] == \
                [e.to_wire() for e in want]
            assert bool(got) == bool(SCENARIOS[name].fault_kw)


def test_healthy_scenario_has_no_faults():
    rec = _record("healthy")
    assert rec["num_faults"] == 0
    ch = rec["chaos"]
    assert ch["faults"] == ch["victims"] == ch["preempted"] == 0
    assert ch["dip_depth"] == 0.0


def test_node_churn_evicts_and_accounts_every_victim():
    rec = _record("node_churn")
    assert rec["num_faults"] > 0
    ch = rec["chaos"]
    assert ch["faults"] > 0 and ch["repairs"] == ch["faults"]
    assert ch["victims"] == ch["preempted"] + ch["migrated"]
    assert ch["killed"] == 0


def test_ocs_degraded_is_fabric_only():
    sc = SCENARIOS["ocs_degraded"]
    assert sc.fault_kw.get("num_fabric_faults", 0) > 0
    assert sc.fault_kw.get("num_node_faults", 0) == 0
    rec = _record("ocs_degraded")
    assert rec["num_faults"] > 0
    assert rec["chaos"]["faults"] > 0


def test_multi_tenant_exercises_priority_preemption():
    ch = _record("multi_tenant")["chaos"]
    assert ch["preempted"] + ch["migrated"] > ch["victims"]


def test_bursty_raises_arrival_cv_but_keeps_mean():
    burstiness = SCENARIOS["bursty"].trace_kw["arrival_burstiness"]
    assert burstiness > 0
    kw = dict(num_jobs=400, seed=0, cluster_xpus=512, size_max=512)
    smooth = generate_trace(TraceConfig(**kw))
    spiky = generate_trace(TraceConfig(arrival_burstiness=burstiness, **kw))

    def gaps(jobs):
        a = sorted(j.arrival for j in jobs)
        return [a[i + 1] - a[i] for i in range(len(a) - 1)]

    def cv(xs):
        mu = sum(xs) / len(xs)
        return math.sqrt(sum((x - mu) ** 2 for x in xs) / len(xs)) / mu

    gs, gb = gaps(smooth), gaps(spiky)
    assert sum(gb) / len(gb) == pytest.approx(sum(gs) / len(gs), rel=0.15)
    assert cv(gb) > cv(gs) + 0.2


def test_scenario_summary_and_chaos_metrics_consistent():
    for name in sorted(SCENARIOS):
        rec = _record(name)
        assert rec["scenario"] == name and rec["policy"] == "rfold"
        s, ch = rec["summary"], rec["chaos"]
        assert 0.0 <= ch["util_overall"] <= 1.0
        assert 0.0 <= s["jcr"] <= 1.0
        assert ch["dip_depth"] >= 0.0
        if ch["faults"] == 0:
            assert ch["util_pre_fault"] == pytest.approx(
                ch["util_overall"])
            assert ch["util_dip_min"] is None
        if ch["recovered"]:
            assert ch["time_to_recover"] >= 0.0


def test_policies_comparable_within_scenario():
    """Different policies in one scenario face the same fault timeline."""
    a = _record("node_churn", policy="rfold",
                policy_kw=dict(num_xpus=512, cube_n=4))
    b = _record("node_churn", policy="firstfit",
                policy_kw=dict(dims=(8, 8, 8)))
    assert a["num_faults"] == b["num_faults"]
    assert a["chaos"]["faults"] == b["chaos"]["faults"]


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_keep_result_returns_full_simulation(engine):
    """``keep_result=True`` adds the run's ``SimResult`` under
    ``"_result"`` and leaves the rest of the record as it was, and as
    the reference's is."""
    kw = dict(policy_kw=dict(num_xpus=512, cube_n=4))
    rec = _record("node_churn", engine, keep_result=True, **kw)
    result = rec.pop("_result")
    assert dumps(rec) == dumps(_record("node_churn", engine, **kw))
    assert result.chaos is not None and result.chaos == rec["chaos"]
    assert len(result.jobs) == rec["num_jobs"] == 60
    evicted = sum(j.preemptions + j.migrations for j in result.jobs)
    assert evicted >= rec["chaos"]["victims"] > 0
    want = ref_scenarios.run_scenario(
        "node_churn", policy="rfold",
        policy_kw=dict(kw["policy_kw"], engine="numpy"), num_jobs=60,
        seed=0, keep_result=True)
    want_result = want.pop("_result")
    assert dumps(rec) == dumps(want)
    assert [(j.job_id, j.start, j.finish, j.dropped, j.killed,
             j.preemptions, j.migrations) for j in result.jobs] == \
        [(j.job_id, j.start, j.finish, j.dropped, j.killed,
          j.preemptions, j.migrations) for j in want_result.jobs]
    assert result.utilization_samples == want_result.utilization_samples


def test_default_engine_raises_without_a_card(monkeypatch):
    """No engine asked for means the card; with none, a scenario run
    raises instead of carrying on on the CPU."""
    from repro_torch.kernels.fitmask import ops
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(ops, "_INSTANCES", {})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_scenario("node_churn", policy_kw=dict(num_xpus=512, cube_n=4),
                     num_jobs=20)


def test_chaos_bench_matrix_equals_the_references():
    """``benchmarks_torch/chaos_bench.py``'s matrix (60-job cells, every
    cell twice) on the ``cuda`` engine on the CPU: deterministic, the
    node_churn headline holds, and every cell (``cell_s`` aside) equals
    ``benchmarks/chaos_bench.py``'s."""
    ref_bench = _load(os.path.join(ROOT, "benchmarks", "chaos_bench.py"),
                      "ref_chaos_bench")
    scenarios = sorted(SCENARIOS)
    got = chaos_bench.run_matrix(scenarios, 60, 0,
                                 ENGINES["cuda-on-cpu"], emit=lambda _: None)
    want = ref_bench.run_matrix(scenarios, 60, 0)

    def strip(matrix):
        return dumps({sc: {k: {f: v for f, v in cell.items()
                               if f != "cell_s"}
                           for k, cell in cells.items()}
                      for sc, cells in matrix.items()})

    assert strip(got) == strip(want)
    head = chaos_bench.headline_from(got, 0.02)
    assert head["deterministic"] and head["pass"]
    assert head == ref_bench.headline_from(want, 0.02)
