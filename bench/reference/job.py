"""Job records for the discrete-event simulator."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from .geometry import JobShape


@dataclass
class Job:
    job_id: int
    arrival: float
    duration: float           # ideal contention-free runtime (seconds)
    shape: JobShape

    # Multi-tenant priority (chaos layer): larger = more important;
    # only consulted when the simulator runs with priority preemption.
    priority: int = 0

    # -- filled by the simulator --
    start: Optional[float] = None
    finish: Optional[float] = None
    dropped: bool = False
    slowdown: float = 1.0
    placement_meta: dict = field(default_factory=dict)
    # -- chaos bookkeeping (fault injection / preemption) --
    preemptions: int = 0      # evicted and re-queued
    migrations: int = 0       # evicted and immediately re-placed
    killed: bool = False      # evicted with no feasible home (dropped)
    remaining: Optional[float] = None  # ideal work left after eviction

    @property
    def size(self) -> int:
        return self.shape.size

    @property
    def scheduled(self) -> bool:
        return self.start is not None

    @property
    def jct(self) -> Optional[float]:
        """Completion time = queueing delay + (slowed) runtime."""
        if self.finish is None:
            return None
        return self.finish - self.arrival

    @property
    def queue_delay(self) -> Optional[float]:
        if self.start is None:
            return None
        return self.start - self.arrival


def jobs_from_numpy(ids, arrivals, durations, dims,
                    priorities=None) -> List[Job]:
    """Build a job list from plain arrays: ``ids`` (n,), ``arrivals``
    and ``durations`` (n,) float, ``dims`` (n, 3) shape dims,
    ``priorities`` (n,) int or None for all zero. The inverse of
    reading the same fields off another trace's jobs, so two
    simulators can be fed one identical trace."""
    ids = np.asarray(ids, dtype=np.int64)
    arrivals = np.asarray(arrivals, dtype=np.float64)
    durations = np.asarray(durations, dtype=np.float64)
    dims = np.asarray(dims, dtype=np.int64).reshape(len(ids), 3)
    if priorities is None:
        priorities = np.zeros(len(ids), dtype=np.int64)
    priorities = np.asarray(priorities, dtype=np.int64)
    return [Job(job_id=int(i), arrival=float(a), duration=float(d),
                shape=JobShape(tuple(int(v) for v in s)), priority=int(p))
            for i, a, d, s, p in zip(ids, arrivals, durations, dims,
                                     priorities)]
