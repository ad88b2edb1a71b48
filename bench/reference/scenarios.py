"""Named chaos scenarios: paper-eval configs for the degraded cluster.

Each scenario bundles the three chaos axes — trace shape
(:class:`~repro_torch.traces.generator.TraceConfig` overrides), fault
schedule (:class:`~repro_torch.sim.faults.FaultConfig` overrides) and
simulator semantics (priority preemption etc.) — into one named,
seeded, fully deterministic config. :func:`run_scenario` is the single
entry point: it answers "how does policy X degrade and recover under
scenario Y?" with a JSON-able record whose bytes depend only on
(scenario, policy, sizes, seed) — the determinism
``benchmarks_torch/chaos_bench.py`` asserts by running every cell
twice. Records are byte-identical to ``repro.sim.scenarios``' for the
same cell, on every fitmask engine.

The five named scenarios:

* ``healthy``      — the paper's baseline: no faults, Poisson arrivals.
* ``node_churn``   — repeated multi-node failures with repair; the
  chaos-bench headline compares recovered utilization across policies
  here.
* ``ocs_degraded`` — OCS-port failures (reconfig clusters) / link cuts
  (static clusters): the fabric shrinks, not the machines.
* ``bursty``       — no faults, but hyperexponential arrival clumps
  and size-duration-correlated sampling stress queue depth.
* ``multi_tenant`` — three priority tiers with preemption enabled,
  plus light node churn.
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass, field
from typing import Dict, Optional

from .allocator import make_policy
from .faults import ChaosObserver, FaultConfig, FaultGenerator
from .metrics import summarize
from .simulator import SimResult, Simulator
from .generator import TraceConfig, generate_trace


@dataclass(frozen=True)
class Scenario:
    name: str
    description: str
    trace_kw: dict = field(default_factory=dict)
    fault_kw: dict = field(default_factory=dict)
    sim_kw: dict = field(default_factory=dict)


SCENARIOS: Dict[str, Scenario] = {
    s.name: s for s in [
        Scenario(
            "healthy",
            "Paper baseline: healthy fabric, Poisson arrivals."),
        Scenario(
            "node_churn",
            "Repeated multi-node failures with repair (rack blast "
            "radius); victims migrate or re-queue at the head.",
            fault_kw=dict(num_node_faults=6, nodes_per_fault=8,
                          mttr_frac=0.15)),
        Scenario(
            "ocs_degraded",
            "Fabric faults: OCS ports die on reconfig clusters, links "
            "are cut on static tori; machines stay up.",
            fault_kw=dict(num_fabric_faults=4, mttr_frac=0.3)),
        Scenario(
            "bursty",
            "Hyperexponential arrival clumps + size-duration-"
            "correlated sampling; no faults.",
            trace_kw=dict(arrival_burstiness=0.7,
                          size_duration_corr=0.5)),
        Scenario(
            "multi_tenant",
            "Three priority tiers with preemption; light node churn.",
            trace_kw=dict(priority_levels=3),
            fault_kw=dict(num_node_faults=2, nodes_per_fault=4,
                          mttr_frac=0.2),
            sim_kw=dict(priority_preemption=True)),
    ]
}


def _fault_seed(seed: int, name: str) -> int:
    """Stable per-(seed, scenario) fault-stream seed (crc32 is
    content-defined, so it never drifts across processes/runs)."""
    return (int(seed) * 1000003 + zlib.crc32(name.encode())) % (2 ** 31)


def fault_schedule(scenario, model, jobs, seed: int) -> list:
    """The deterministic fault list for one (scenario, seed) against
    ``model`` (a cluster/torus): what :func:`run_scenario` injects, and
    what the eval runner injects when an :class:`~repro_torch.eval.runner.
    EvalTask` carries a ``scenario`` — same seed derivation, so a
    paper-eval record and a ``run_scenario`` record of the same cell
    see byte-identical fault streams."""
    sc: Scenario = (SCENARIOS[scenario] if isinstance(scenario, str)
                    else scenario)
    horizon = max((j.arrival for j in jobs), default=0.0)
    cfg = FaultConfig(seed=_fault_seed(seed, sc.name), **sc.fault_kw)
    return FaultGenerator(cfg).generate(model, horizon)


def run_scenario(scenario, policy: str = "rfold",
                 policy_kw: Optional[dict] = None,
                 num_jobs: int = 120, seed: int = 0,
                 trace_kw: Optional[dict] = None,
                 keep_result: bool = False) -> dict:
    """Run one (scenario, policy) cell and return its deterministic
    record: trace/fault provenance, the paper summary metrics, and the
    chaos observer's degradation/recovery block.

    ``policy_kw``/``trace_kw`` size the cluster and trace (CI uses 512
    XPUs, the paper eval 4096); scenario-level overrides win over the
    caller's ``trace_kw`` for the knobs the scenario *is* (burstiness,
    correlation, priorities). ``keep_result=True`` attaches the raw
    :class:`SimResult` under the non-JSON key ``"_result"``."""
    sc: Scenario = (SCENARIOS[scenario] if isinstance(scenario, str)
                    else scenario)
    cfg = TraceConfig(**{"num_jobs": num_jobs, "seed": seed,
                         **(trace_kw or {}), **sc.trace_kw})
    jobs = generate_trace(cfg)
    pol = make_policy(policy, **(policy_kw or {}))
    injector_model = getattr(pol, "cluster", None)
    if injector_model is None:
        injector_model = pol.torus
    faults = fault_schedule(sc, injector_model, jobs, seed)
    observer = ChaosObserver()
    sim = Simulator(pol, jobs, faults=faults, observer=observer,
                    **sc.sim_kw)
    result: SimResult = sim.run()
    record = {
        "scenario": sc.name,
        "policy": getattr(pol, "name", policy),
        "seed": seed,
        "num_jobs": num_jobs,
        "num_faults": sum(1 for f in faults if f.action == "fault"),
        "summary": summarize(result),
        "chaos": result.chaos,
    }
    if keep_result:
        record["_result"] = result
    return record
