"""The public API of the PyTorch/CUDA port.

One import surface for everything downstream code needs — examples,
``benchmarks_torch/``, notebooks — so callers stop reaching into
``repro_torch.core``/``repro_torch.sim`` internals:

    from repro_torch import api

    with api.Scheduler(policy="rfold") as sched:     # live service
        r = sched.submit((4, 4, 4))
        for ev in sched.events(max_wait=0.1):
            ...

    jobs = api.generate_trace(api.TraceConfig(num_jobs=100))
    result = api.Simulator(api.make_policy("rfold"), jobs).run()

Every entry point places on the ``cuda`` fitmask kernels on the card
unless its engine says otherwise (``engine="numpy"`` for the host,
``EngineConfig("cuda", device="cpu")`` for the kernels' plain versions
on CPU tensors); with no card the default raises.

Module-level :func:`submit` / :func:`events` operate on a default
process-wide scheduler (started on first use, configurable via
:func:`start_scheduler`) for scripts that just want a live allocator
without managing lifecycles.

Everything re-exported here is covered by the parity and round-trip
tests; internals not listed in ``__all__`` may move without notice.
"""
from __future__ import annotations

import atexit
import threading
from typing import Any, Dict, List, Optional

# Engine selection (the one resolution point for fitmask engines) and
# the runtime failover chain the fleet broker degrades down.
from repro_torch.core.engineconfig import (FAILOVER_CHAIN, EngineConfig,
                                           default_engine_name,
                                           failover_candidates,
                                           set_default_engine)
# Placement policies + geometry.
from repro_torch.core.allocator import (POLICIES, Placement,
                                        PlacementPolicy, make_policy)
from repro_torch.core.events import EventLog, TopologyEvent
from repro_torch.core.geometry import JobShape
# Discrete-event simulation + traces + metrics.
from repro_torch.sim.job import Job
from repro_torch.sim.metrics import summarize, utilization_cdf
from repro_torch.sim.simulator import SimResult, Simulator
from repro_torch.traces.generator import (TraceConfig, generate_trace,
                                          generate_traces)
# Chaos layer: fault injection, degraded-fabric scenarios.
from repro_torch.sim.faults import (ChaosObserver, FaultConfig, FaultEvent,
                                    FaultGenerator, FaultInjector)
from repro_torch.sim.scenarios import (SCENARIOS, Scenario, fault_schedule,
                                       run_scenario)
# Paper-scale evaluation.
from repro_torch.eval import (PAPER_FIG3_RATIOS, PAPER_FIG4_DELTAS,
                              PAPER_TABLE1, EvalRunner, EvalTask,
                              aggregate_by_label, fig3, fig4, make_tasks,
                              table1)
# The allocator service (+ replication/fencing constants).
from repro_torch.serve.scheduler import (NOT_LEADER, ROLE_PRIMARY,
                                         ROLE_STANDBY, RemotePolicy,
                                         Scheduler, SchedulerClient,
                                         SchedulerConfig)

__all__ = [
    # service
    "Scheduler", "SchedulerConfig", "SchedulerClient", "RemotePolicy",
    "submit", "events", "start_scheduler", "stop_scheduler",
    "NOT_LEADER", "ROLE_PRIMARY", "ROLE_STANDBY",
    # engine selection + runtime failover
    "EngineConfig", "set_default_engine", "default_engine_name",
    "FAILOVER_CHAIN", "failover_candidates",
    # placement
    "POLICIES", "make_policy", "PlacementPolicy", "Placement", "JobShape",
    "TopologyEvent", "EventLog",
    # simulation
    "Simulator", "SimResult", "Job", "summarize", "utilization_cdf",
    "TraceConfig", "generate_trace", "generate_traces",
    # chaos layer
    "FaultConfig", "FaultEvent", "FaultGenerator", "FaultInjector",
    "ChaosObserver", "Scenario", "SCENARIOS", "run_scenario",
    "fault_schedule",
    # evaluation
    "EvalRunner", "EvalTask", "make_tasks", "aggregate_by_label",
    "table1", "fig3", "fig4",
    "PAPER_TABLE1", "PAPER_FIG3_RATIOS", "PAPER_FIG4_DELTAS",
]

# -- default process-wide scheduler ------------------------------------

_default_lock = threading.Lock()
_default_scheduler: Optional[Scheduler] = None


def start_scheduler(config: Optional[SchedulerConfig] = None,
                    **config_kw) -> Scheduler:
    """Start (or return) the process-wide default scheduler used by
    module-level :func:`submit`/:func:`events`. Explicit config is only
    honoured on first start — stop the old one to reconfigure."""
    global _default_scheduler
    with _default_lock:
        if _default_scheduler is None:
            _default_scheduler = Scheduler(config, **config_kw).start()
            atexit.register(stop_scheduler)
        elif config is not None or config_kw:
            raise RuntimeError(
                "default scheduler already running; stop_scheduler() "
                "before starting one with a different config")
        return _default_scheduler


def stop_scheduler() -> None:
    """Gracefully stop the default scheduler (idempotent)."""
    global _default_scheduler
    with _default_lock:
        if _default_scheduler is not None:
            _default_scheduler.stop()
            _default_scheduler = None


def submit(shape, job_id: Optional[int] = None) -> Dict[str, Any]:
    """Submit a job shape to the default scheduler (started on first
    use with default config: RFold on the paper's 4096-XPU cluster, on
    the ``cuda`` engine)."""
    return start_scheduler().submit(shape, job_id=job_id)


def events(max_wait: float = 0.0) -> List[Dict[str, Any]]:
    """Drain pushed SETUP/RECONFIG/RELEASE events from the default
    scheduler."""
    return start_scheduler().events(max_wait=max_wait)
