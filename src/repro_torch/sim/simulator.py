"""Topology-aware, job-level discrete-event simulator (paper §4).

Admission is fixed to FIFO with head-of-line blocking, exactly as in the
paper: an unschedulable-but-compatible job blocks all later jobs until
resources free up; a job whose *shape* is incompatible with the cluster
(cannot be placed even when empty) is removed from the system and the
scheduler proceeds.

Jobs occupy exclusive XPUs/links by construction (the policies enforce
shapes), so runtime is contention-free; placements whose rings cannot
close (no wrap-around available) run with a configurable slowdown,
defaulting to the 17 % penalty the paper measured for non-ideal
placements on TPU v2 (§3.1).

Chaos extensions (see ``repro_torch.sim.faults``): a seeded fault timeline
rides the same event heap (``CHAOS`` events). A fault on resources
hosting jobs evicts the victims *before* the model transitions (the
models enforce this), preserves their remaining work (checkpoint-resume
assumption), and replans each through the policy: re-placed now →
**migrated**; re-queued at the head → **preempted**; in
``fault_mode="kill"`` victims are fail-stopped instead (**killed**).
``priority_preemption`` adds multi-tenant semantics: the queue orders
by priority and a blocked high-priority head may evict lower-priority
running jobs. All of it is pay-for-play — with no faults, no observer
and no priorities, schedules are byte-identical to the paper baseline
(parity-tested).
"""
from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

from repro_torch import obs
from repro_torch.core.allocator import PlacementPolicy, shape_key
from repro_torch.core.geometry import Dims
from .job import Job

ARRIVAL, COMPLETION, CHAOS = 0, 1, 2


@dataclass
class SimResult:
    jobs: List[Job]
    utilization_samples: List[Tuple[float, float]]  # (time, utilization)
    policy_name: str
    # Degradation/recovery record (ChaosObserver.finalize) when the run
    # carried an observer; None for plain paper-baseline runs.
    chaos: Optional[dict] = field(default=None)

    @property
    def completed(self) -> List[Job]:
        return [j for j in self.jobs if j.finish is not None]

    @property
    def dropped(self) -> List[Job]:
        return [j for j in self.jobs if j.dropped]

    @property
    def jcr(self) -> float:
        """Job completion rate: scheduled / total (paper Table 1)."""
        if not self.jobs:
            return 1.0
        return sum(1 for j in self.jobs if j.scheduled) / len(self.jobs)


class Simulator:
    """``backfill=True`` enables aggressive backfilling (beyond-paper,
    §5 of the paper invites revisiting admission): jobs behind a blocked
    head may start if they fit now. The paper's FIFO head-of-line
    blocking is the default.

    ``faults`` is a time-sorted :class:`~repro_torch.sim.faults.FaultEvent`
    sequence (see :class:`~repro_torch.sim.faults.FaultGenerator`);
    ``observer`` a :class:`~repro_torch.sim.faults.ChaosObserver` (or
    anything with its hooks); ``fault_mode`` picks eviction semantics
    (``"migrate"``: work-preserving replan; ``"kill"``: fail-stop);
    ``priority_preemption`` orders the queue by ``Job.priority`` and
    lets a blocked head evict lower-priority running jobs."""

    def __init__(self, policy: PlacementPolicy, jobs: Sequence[Job],
                 broken_ring_slowdown: float = 1.17,
                 backfill: bool = False, gated: bool = True,
                 faults: Sequence = (), observer=None,
                 fault_mode: str = "migrate",
                 priority_preemption: bool = False):
        if fault_mode not in ("migrate", "kill"):
            raise ValueError(f"unknown fault_mode {fault_mode!r}")
        self.policy = policy
        self.jobs = sorted(jobs, key=lambda j: j.arrival)
        self.broken_ring_slowdown = broken_ring_slowdown
        self.backfill = backfill
        # Event-driven drain watermark: a head job that failed to place
        # can only be unblocked by a COMPLETION (arrivals never free
        # capacity under FIFO), so arrival events behind a blocked head
        # skip the placement retry entirely. Backfill mode gets the
        # per-shape analogue: a shape that failed to place stays
        # infeasible until the next completion (placements only consume
        # capacity, rotations share feasibility), so queued jobs whose
        # canonical shape already failed skip the retry. ``gated=False``
        # restores the naive retry-on-every-event behaviour (parity
        # oracle). Chaos events (faults, repairs, preemptions) all
        # reset the watermark: they change capacity in both directions.
        self.gated = gated
        self.faults = list(faults)
        self.observer = observer
        self.fault_mode = fault_mode
        self.priority_preemption = bool(priority_preemption)
        self._injector = None
        if self.faults:
            from .faults import FaultInjector
            self._injector = FaultInjector(policy)
        self._head_blocked = False
        self._infeasible_shapes: Set[Dims] = set()
        self.queue: List[Job] = []
        self.events: List[Tuple[float, int, int, object, int]] = []
        self._seq = itertools.count()
        # Completion generations: an eviction bumps the job's
        # generation so its stale COMPLETION event (still in the heap)
        # is discarded when popped.
        self._gen: Dict[int, int] = {}
        self._running: Dict[int, Job] = {}
        # Priority mode: stable enqueue sequence (first-arrival order)
        # so a preempted job resumes ahead of later equals.
        self._qseq: Dict[int, int] = {}
        self._qcount = itertools.count()
        self.util_samples: List[Tuple[float, float]] = []

    def _push(self, t: float, kind: int, payload, gen: int = 0) -> None:
        heapq.heappush(self.events,
                       (t, kind, next(self._seq), payload, gen))

    def _sample(self, t: float) -> None:
        u = self.policy.utilization()
        self.util_samples.append((t, u))
        if self.observer is not None:
            self.observer.on_sample(t, u, len(self.queue))

    def _enqueue(self, job: Job) -> None:
        if job.job_id not in self._qseq:
            self._qseq[job.job_id] = next(self._qcount)
        self.queue.append(job)
        if self.priority_preemption:
            self.queue.sort(
                key=lambda j: (-j.priority, self._qseq[j.job_id]))

    def _start(self, job: Job, now: float, placement) -> None:
        if job.start is None:
            job.start = now
        job.placement_meta = placement.meta
        job.slowdown = placement.meta.get("slowdown_factor") or (
            self.broken_ring_slowdown if placement.broken_rings else 1.0)
        work = job.remaining if job.remaining is not None else job.duration
        job.finish = now + work * job.slowdown
        gen = self._gen.get(job.job_id, 0) + 1
        self._gen[job.job_id] = gen
        self._running[job.job_id] = job
        self._push(job.finish, COMPLETION, job, gen)

    def _evict(self, job: Job, now: float) -> None:
        """Release a running job preserving its remaining ideal work
        (checkpoint-resume assumption) and invalidate its pending
        COMPLETION."""
        job.remaining = max(0.0, (job.finish - now) / job.slowdown)
        job.finish = None
        self.policy.release(job.job_id)
        self._running.pop(job.job_id, None)
        self._gen[job.job_id] = self._gen.get(job.job_id, 0) + 1

    # -- chaos ----------------------------------------------------------
    def _apply_fault(self, t: float, ev) -> None:
        obs.count("chaos.events")
        with obs.span("chaos.repair" if ev.action == "repair"
                      else "chaos.fault"):
            self._apply_event(t, ev)

    def _apply_event(self, t: float, ev) -> None:
        inj = self._injector
        if ev.action == "repair":
            applied = inj.apply(ev)
            if self.observer is not None:
                self.observer.on_repair(t, ev, applied)
            # Capacity came back: every shape may be feasible again.
            self._infeasible_shapes.clear()
            return
        victims = [self._running[jid] for jid in inj.victims(ev)
                   if jid in self._running]
        obs.count("chaos.evicted", len(victims))
        for job in victims:
            self._evict(job, t)
        inj.apply(ev)
        if self.observer is not None:
            self.observer.on_fault(t, ev, [j.job_id for j in victims])
        requeue: List[Job] = []
        for job in victims:
            if self.fault_mode == "kill":
                job.dropped = True
                job.killed = True
                if self.observer is not None:
                    self.observer.on_kill(t, job)
                continue
            placement = self.policy.try_place(job.job_id, job.shape)
            if placement is not None:
                job.migrations += 1
                self._start(job, t, placement)
                if self.observer is not None:
                    self.observer.on_migrate(t, job)
            else:
                job.preemptions += 1
                requeue.append(job)
                if self.observer is not None:
                    self.observer.on_preempt(t, job)
        if requeue:
            # Evicted jobs go back to the *head* (they were already
            # admitted — FIFO order is by first admission).
            if self.priority_preemption:
                for job in requeue:
                    self._enqueue(job)
            else:
                self.queue[0:0] = requeue
        self._infeasible_shapes.clear()

    def _try_preempt_place(self, job: Job, now: float):
        """Multi-tenant preemption: evict lower-priority running jobs
        (lowest priority first, youngest first within a priority) until
        ``job`` places. Evicted jobs are re-planned like fault victims:
        re-placed immediately if the hole allows, else re-queued."""
        cands = sorted(
            (r for r in self._running.values()
             if r.priority < job.priority),
            key=lambda r: (r.priority, -r.job_id))
        free = self.policy.num_xpus - self.policy.busy_xpus
        if not cands or free + sum(r.size for r in cands) < job.size:
            return None
        placement = None
        evicted: List[Job] = []
        for r in cands:
            self._evict(r, now)
            r.preemptions += 1
            evicted.append(r)
            if self.observer is not None:
                self.observer.on_preempt(now, r)
            placement = self.policy.try_place(job.job_id, job.shape)
            if placement is not None:
                break
        for r in evicted:
            if placement is None:
                # The evictions were in vain: put the victim straight
                # back if its own hole still fits it.
                back = self.policy.try_place(r.job_id, r.shape)
                if back is not None:
                    self._start(r, now, back)
                    continue
            self._enqueue(r)
        self._infeasible_shapes.clear()
        return placement

    # -- scheduling -----------------------------------------------------
    def _drain_queue(self, now: float) -> None:
        """FIFO with head-of-line blocking + incompatible-shape removal
        (paper behaviour); with backfill, later jobs may start when the
        head is blocked; with priority preemption, a blocked head may
        evict lower-priority running jobs."""
        self._head_blocked = False
        i = 0
        while i < len(self.queue):
            job = self.queue[i]
            if not self.policy.can_ever_place(job.shape):
                job.dropped = True
                self.queue.pop(i)
                continue
            key = shape_key(job.shape)
            if (self.gated and self.backfill
                    and key in self._infeasible_shapes):
                i += 1  # same shape already failed since the last free
                continue
            placement = self.policy.try_place(job.job_id, job.shape)
            if placement is None and self.priority_preemption and i == 0:
                placement = self._try_preempt_place(job, now)
            if placement is None:
                if not self.backfill:
                    self._head_blocked = True
                    return  # head blocks
                self._infeasible_shapes.add(key)
                i += 1
                continue
            self.queue.pop(i)
            self._start(job, now, placement)

    def run(self) -> SimResult:
        for j in self.jobs:
            self._push(j.arrival, ARRIVAL, j)
        for f in self.faults:
            self._push(f.time, CHAOS, f)
        while self.events:
            t, kind, _, payload, gen = heapq.heappop(self.events)
            if kind == ARRIVAL:
                self._enqueue(payload)
                # A blocked head stays blocked across arrivals: cluster
                # state is unchanged, so the retry would fail again and
                # the new arrival cannot start ahead of it under FIFO.
                # (Priority mode excepted: a high-priority arrival may
                # preempt its way in.)
                if (self.gated and not self.backfill
                        and not self.priority_preemption
                        and self._head_blocked and len(self.queue) > 1):
                    self._sample(t)
                    continue
            elif kind == COMPLETION:
                job = payload
                if gen != self._gen.get(job.job_id, 0):
                    continue  # stale: the job was evicted after this push
                self.policy.release(job.job_id)
                self._running.pop(job.job_id, None)
                # Freed capacity may unblock any shape: reset the
                # backfill feasibility watermark.
                self._infeasible_shapes.clear()
            else:
                self._apply_fault(t, payload)
            self._drain_queue(t)
            self._sample(t)
        result = SimResult(self.jobs, self.util_samples,
                           getattr(self.policy, "name", "policy"))
        if self.observer is not None:
            end = self.util_samples[-1][0] if self.util_samples else 0.0
            result.chaos = self.observer.finalize(end)
        return result
