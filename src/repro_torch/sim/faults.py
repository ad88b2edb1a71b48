"""Chaos layer: seeded fault generation, injection, and observation.

The paper evaluates RFold on a *healthy* 4096-node torus; this module
opens the axis the eval was missing — how each policy degrades and
recovers when the fabric is not healthy. Three roles, split like an
orchestrator/evaluator pair:

* :class:`FaultGenerator` — turns a seeded :class:`FaultConfig` into a
  deterministic timeline of :class:`FaultEvent`\\ s (node failures,
  link cuts, OCS-port failures, each optionally followed by a repair).
  Targets are drawn as *flat node indices* and concretized per cluster
  model, so the same seed fails the same physical machines under every
  policy — the cross-policy comparison is apples to apples.

* **Injection** (:class:`FaultInjector`) — translates events into
  model operations: compute victims, let the caller evict them, apply
  the fault. The models emit ``fault``/``repair``
  :class:`~repro_torch.core.events.TopologyEvent`\\ s on the same listener
  plumbing a scheduler service uses for SETUP/RELEASE, and refuse
  (``FaultConflictError``) to fail a resource that still hosts a job —
  eviction-before-fault is enforced, never assumed.

* :class:`ChaosObserver` — records degradation and recovery per run:
  utilization dip depth, re-queue depth, time-to-recover, jobs killed
  vs migrated. Pure observation: it never mutates simulator state, so
  attaching one cannot change a schedule (parity-tested).

Event flow (see DESIGN.md §Chaos layer for the full diagram)::

    FaultGenerator --(FaultEvent timeline)--> Simulator event heap
        Simulator --victims?--> FaultInjector --> model.jobs_on/...
        Simulator --evict victims--> policy.release (+ bookkeeping)
        Simulator --> FaultInjector.apply --> model.fail_* (TopologyEvent)
        Simulator --replan victims--> policy.try_place
            placed   -> migrated   (new completion, work preserved)
            unplaced -> preempted  (re-queued at the head)
            infeasible -> killed   (dropped)
        ChaosObserver <-- on_fault/on_repair/on_preempt/... hooks
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch import obs
from repro_torch.core.reconfig import ReconfigTorus
from repro_torch.core.torus import StaticTorus

NODE, LINK, OCS_PORT = "node", "link", "ocs_port"
FAULT, REPAIR = "fault", "repair"


def _detuple(x):
    """Recursively listify -> tuple-ize (JSON round-trip normalizer)."""
    if isinstance(x, (list, tuple)):
        return tuple(_detuple(v) for v in x)
    return int(x) if isinstance(x, (bool, np.integer)) else x


@dataclass(frozen=True)
class FaultEvent:
    """One injected fabric transition.

    ``action``  — ``"fault"`` | ``"repair"``.
    ``kind``    — ``"node"`` | ``"link"`` | ``"ocs_port"``.
    ``targets`` — canonical tuples: 3-coords (static nodes), 4-cells
                  (reconfig nodes, ``(cube, x, y, z)``), ``(u, v)``
                  coordinate pairs (links), or cube ids (OCS ports).
    """

    time: float
    action: str
    kind: str
    targets: Tuple = ()

    def to_wire(self) -> dict:
        """JSON-lines-protocol payload (tuples become lists)."""
        return {"time": self.time, "action": self.action,
                "kind": self.kind, "targets": list(self.targets)}

    @staticmethod
    def from_wire(d: dict) -> "FaultEvent":
        return FaultEvent(time=float(d["time"]), action=str(d["action"]),
                          kind=str(d["kind"]),
                          targets=_detuple(d.get("targets", ())))


@dataclass(frozen=True)
class FaultConfig:
    """Seeded chaos schedule. Counts are *events*, not nodes: one node
    fault takes down ``nodes_per_fault`` machines at once (a rack/PSU
    blast radius). ``mttr_frac`` is the repair delay as a fraction of
    the trace horizon; ``window`` bounds fault times to the middle of
    the trace so degradation and recovery are both observable."""

    seed: int = 0
    num_node_faults: int = 0
    nodes_per_fault: int = 4
    num_fabric_faults: int = 0       # OCS ports (reconfig) / link cuts (static)
    mttr_frac: float = 0.25
    window: Tuple[float, float] = (0.05, 0.6)
    repair: bool = True

    @property
    def total_events(self) -> int:
        return self.num_node_faults + self.num_fabric_faults


class FaultGenerator:
    """Deterministic fault-timeline sampler.

    The draw sequence is fixed (times, then targets, per event in
    order), so a (config, cluster geometry, horizon) triple always
    yields the identical timeline — the reproducibility the scenario
    determinism asserts in CI rest on."""

    def __init__(self, config: FaultConfig):
        self.config = config

    # -- target concretization -----------------------------------------
    @staticmethod
    def _node_targets(model, idxs: np.ndarray) -> Tuple:
        if isinstance(model, StaticTorus):
            return tuple(
                tuple(int(v) for v in np.unravel_index(int(i), model.dims))
                for i in idxs)
        n3 = model.cube_n ** 3
        return tuple(
            (int(i) // n3,) + tuple(
                int(v) for v in np.unravel_index(int(i) % n3,
                                                 (model.cube_n,) * 3))
            for i in idxs)

    @staticmethod
    def _link_target(model: StaticTorus, idx: int, axis: int) -> Tuple:
        u = tuple(int(v) for v in np.unravel_index(idx, model.dims))
        v = list(u)
        v[axis] = (v[axis] + 1) % model.dims[axis]
        return (u, tuple(v))

    def generate(self, model, horizon: float) -> List[FaultEvent]:
        """Timeline for one cluster model over ``[0, horizon]``,
        time-sorted with a stable draw-order tiebreak."""
        cfg = self.config
        if cfg.total_events == 0 or horizon <= 0:
            return []
        rng = np.random.default_rng(cfg.seed)
        lo, hi = cfg.window
        mttr = cfg.mttr_frac * horizon
        events: List[FaultEvent] = []
        num = model.num_xpus
        for _ in range(cfg.num_node_faults):
            t = float(horizon * rng.uniform(lo, hi))
            k = min(cfg.nodes_per_fault, num)
            idxs = np.sort(rng.choice(num, size=k, replace=False))
            targets = self._node_targets(model, idxs)
            events.append(FaultEvent(t, FAULT, NODE, targets))
            if cfg.repair:
                events.append(FaultEvent(t + mttr, REPAIR, NODE, targets))
        for _ in range(cfg.num_fabric_faults):
            t = float(horizon * rng.uniform(lo, hi))
            if isinstance(model, ReconfigTorus):
                cube = int(rng.integers(model.num_cubes))
                ev = FaultEvent(t, FAULT, OCS_PORT, (cube,))
            else:
                idx = int(rng.integers(num))
                axis = int(rng.integers(3))
                ev = FaultEvent(t, FAULT, LINK,
                                (self._link_target(model, idx, axis),))
            events.append(ev)
            if cfg.repair:
                events.append(replace(ev, time=t + mttr, action=REPAIR))
        order = sorted(range(len(events)),
                       key=lambda i: (events[i].time, i))
        return [events[i] for i in order]


class FaultInjector:
    """Model-side half of fault application: victim discovery and the
    actual state transition. The *caller* (simulator / scheduler core)
    owns eviction and replanning — this class never touches jobs."""

    def __init__(self, policy):
        self.policy = policy
        model = getattr(policy, "cluster", None)
        if model is None:
            model = getattr(policy, "torus", None)
        if model is None:
            raise TypeError(f"policy {policy!r} exposes no cluster model")
        self.model = model

    @obs.span("chaos.victims")
    def victims(self, ev: FaultEvent) -> List[int]:
        """Job ids that must be evicted before ``ev`` can apply
        (sorted; empty for repairs)."""
        if ev.action != FAULT:
            return []
        m = self.model
        if ev.kind == NODE:
            return m.jobs_on(ev.targets)
        if ev.kind == LINK:
            return m.link_jobs([tuple(t) for t in ev.targets])
        if ev.kind == OCS_PORT:
            return m.jobs_using_ocs(ev.targets)
        raise ValueError(f"unknown fault kind {ev.kind!r}")

    def apply(self, ev: FaultEvent) -> List:
        """Apply the transition; returns the targets actually changed
        (idempotent: already-failed targets and never-failed repairs
        are skipped)."""
        m = self.model
        if ev.kind == NODE:
            if isinstance(m, StaticTorus):
                op = m.fail_nodes if ev.action == FAULT else m.repair_nodes
            else:
                op = m.fail_cells if ev.action == FAULT else m.repair_cells
            return op(ev.targets)
        if ev.kind == LINK:
            op = m.cut_link if ev.action == FAULT else m.repair_link
            return [t for t in ev.targets if op(tuple(t[0]), tuple(t[1]))]
        if ev.kind == OCS_PORT:
            op = (m.fail_ocs_port if ev.action == FAULT
                  else m.repair_ocs_port)
            return op(ev.targets)
        raise ValueError(f"unknown fault kind {ev.kind!r}")


@dataclass
class ChaosObserver:
    """Degradation/recovery recorder (pure observation).

    ``recovery_tolerance`` defines "recovered": utilization back within
    this absolute distance of the pre-fault time-weighted mean."""

    recovery_tolerance: float = 0.05

    faults: int = 0
    repairs: int = 0
    victims: int = 0
    preempted: int = 0
    migrated: int = 0
    killed: int = 0
    first_fault_t: Optional[float] = None
    last_fault_t: Optional[float] = None
    last_repair_t: Optional[float] = None
    max_queue_depth: int = 0
    requeue_depth_max: int = 0   # max queue depth while degraded
    _samples: List[Tuple[float, float, int]] = field(default_factory=list)

    # -- simulator hooks -----------------------------------------------
    def on_fault(self, t: float, ev: FaultEvent,
                 victims: Sequence[int]) -> None:
        self.faults += 1
        self.victims += len(victims)
        if self.first_fault_t is None:
            self.first_fault_t = t
        self.last_fault_t = t

    def on_repair(self, t: float, ev: FaultEvent, applied) -> None:
        self.repairs += 1
        self.last_repair_t = t

    def on_preempt(self, t: float, job) -> None:
        self.preempted += 1

    def on_migrate(self, t: float, job) -> None:
        self.migrated += 1

    def on_kill(self, t: float, job) -> None:
        self.killed += 1

    def on_sample(self, t: float, util: float, queue_depth: int) -> None:
        self._samples.append((t, util, queue_depth))
        self.max_queue_depth = max(self.max_queue_depth, queue_depth)
        if self.first_fault_t is not None and (
                self.last_repair_t is None or t <= self.last_repair_t):
            self.requeue_depth_max = max(self.requeue_depth_max,
                                         queue_depth)

    # -- metrics ---------------------------------------------------------
    @staticmethod
    def _tw_mean(samples: List[Tuple[float, float]]) -> Optional[float]:
        """Time-weighted mean of a step function given as (t, value)
        breakpoints."""
        if len(samples) < 2:
            return samples[0][1] if samples else None
        total = w = 0.0
        for (t0, u0), (t1, _) in zip(samples, samples[1:]):
            dt = t1 - t0
            total += u0 * dt
            w += dt
        return total / w if w > 0 else samples[0][1]

    def finalize(self, end_time: float) -> Dict:
        """Deterministic JSON-able degradation/recovery record."""
        us = [(t, u) for t, u, _ in self._samples]
        overall = self._tw_mean(us)
        out: Dict = {
            "faults": self.faults, "repairs": self.repairs,
            "victims": self.victims, "preempted": self.preempted,
            "migrated": self.migrated, "killed": self.killed,
            "max_queue_depth": self.max_queue_depth,
            "requeue_depth_max": self.requeue_depth_max,
            "util_overall": overall,
        }
        if self.first_fault_t is None:
            out.update({"util_pre_fault": overall, "util_dip_min": None,
                        "dip_depth": 0.0, "recovered_util": overall,
                        "time_to_recover": 0.0, "recovered": True})
            return out
        tf = self.first_fault_t
        # Recovery starts when the fabric is whole again (last repair),
        # or never does under a permanent fault — then the tail after
        # the last fault is what "recovered" means for that policy.
        t_rec = self.last_repair_t if self.last_repair_t is not None \
            else self.last_fault_t
        pre_samples = [(t, u) for t, u in us if t < tf]
        if pre_samples:
            pre_samples.append((tf, pre_samples[-1][1]))
        pre = self._tw_mean(pre_samples)
        pre = 0.0 if pre is None else pre
        degraded = [u for t, u in us if tf <= t <= t_rec]
        dip = min(degraded) if degraded else None
        tail = [(t, u) for t, u in us if t >= t_rec]
        if tail and end_time > tail[-1][0]:
            tail.append((end_time, tail[-1][1]))
        recovered_util = self._tw_mean(tail)
        if recovered_util is None:
            recovered_util = us[-1][1] if us else 0.0
        ttr = None
        thresh = pre - self.recovery_tolerance
        for t, u in tail:
            if u >= thresh:
                ttr = t - t_rec
                break
        out.update({
            "util_pre_fault": pre,
            "util_dip_min": dip,
            "dip_depth": max(0.0, pre - dip) if dip is not None else 0.0,
            "recovered_util": recovered_util,
            "time_to_recover": ttr,
            "recovered": ttr is not None,
        })
        return out
