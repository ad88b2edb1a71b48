"""One seeded simulator run in the reference: the same steps as the
program's eval task (trace, policy, the scenario's fault stream and
chaos observer, simulator, summary, utilisation CDF), returning the
record and the finished job list."""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from .allocator import make_policy
from .faults import ChaosObserver
from .generator import TraceConfig, generate_trace
from .job import Job
from .metrics import summarize, utilization_cdf
from .scenarios import SCENARIOS, fault_schedule
from .simulator import Simulator


def reference_run(policy: str, policy_kw: Dict, seed: int, num_jobs: int,
                  load: float, trace_kw: Optional[Dict] = None,
                  sim_kw: Optional[Dict] = None,
                  scenario: Optional[str] = None) -> Tuple[Dict, List[Job]]:
    sc = SCENARIOS[scenario] if scenario is not None else None
    cfg = TraceConfig(num_jobs=num_jobs, seed=seed, target_load=load,
                      **{**(trace_kw or {}), **(sc.trace_kw if sc else {})})
    jobs = generate_trace(cfg)
    pol = make_policy(policy, **dict(policy_kw))
    kw = dict(sim_kw or {})
    if sc is not None:
        model = getattr(pol, "cluster", None)
        if model is None:
            model = pol.torus
        kw.update(sc.sim_kw)
        kw["faults"] = fault_schedule(sc, model, jobs, seed)
        kw["observer"] = ChaosObserver()
    res = Simulator(pol, jobs, **kw).run()
    levels, cdf = utilization_cdf(res)
    rec = {"seed": seed, "summary": summarize(res),
           "cdf_levels": [float(x) for x in levels],
           "cdf": [float(x) for x in cdf]}
    if sc is not None:
        rec["scenario"] = sc.name
        rec["chaos"] = res.chaos
    return rec, res.jobs

