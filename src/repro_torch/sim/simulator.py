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
"""
from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass
from typing import List, Sequence, Set, Tuple

from repro_torch.core.allocator import PlacementPolicy, shape_key
from repro_torch.core.geometry import Dims
from .job import Job

ARRIVAL, COMPLETION = 0, 1


@dataclass
class SimResult:
    jobs: List[Job]
    utilization_samples: List[Tuple[float, float]]  # (time, utilization)
    policy_name: str

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
    blocking is the default."""

    def __init__(self, policy: PlacementPolicy, jobs: Sequence[Job],
                 broken_ring_slowdown: float = 1.17,
                 backfill: bool = False, gated: bool = True):
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
        # oracle).
        self.gated = gated
        self._head_blocked = False
        self._infeasible_shapes: Set[Dims] = set()
        self.queue: List[Job] = []
        self.events: List[Tuple[float, int, int, object]] = []
        self._seq = itertools.count()
        self.util_samples: List[Tuple[float, float]] = []

    def _push(self, t: float, kind: int, payload) -> None:
        heapq.heappush(self.events, (t, kind, next(self._seq), payload))

    def _sample(self, t: float) -> None:
        self.util_samples.append((t, self.policy.utilization()))

    def _start(self, job: Job, now: float, placement) -> None:
        job.start = now
        job.placement_meta = placement.meta
        job.slowdown = placement.meta.get("slowdown_factor") or (
            self.broken_ring_slowdown if placement.broken_rings else 1.0)
        job.finish = now + job.duration * job.slowdown
        self._push(job.finish, COMPLETION, job)

    # -- scheduling -----------------------------------------------------
    def _drain_queue(self, now: float) -> None:
        """FIFO with head-of-line blocking + incompatible-shape removal
        (paper behaviour); with backfill, later jobs may start when the
        head is blocked."""
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
        while self.events:
            t, kind, _, payload = heapq.heappop(self.events)
            if kind == ARRIVAL:
                self.queue.append(payload)
                # A blocked head stays blocked across arrivals: cluster
                # state is unchanged, so the retry would fail again and
                # the new arrival cannot start ahead of it under FIFO.
                if (self.gated and not self.backfill
                        and self._head_blocked and len(self.queue) > 1):
                    self._sample(t)
                    continue
            else:
                self.policy.release(payload.job_id)
                # Freed capacity may unblock any shape: reset the
                # backfill feasibility watermark.
                self._infeasible_shapes.clear()
            self._drain_queue(t)
            self._sample(t)
        return SimResult(self.jobs, self.util_samples,
                         getattr(self.policy, "name", "policy"))
