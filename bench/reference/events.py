"""Structured topology events emitted by the cluster models.

The paper frames RFold as a *runtime* co-adapter: a job does not just
get XPUs, it gets a virtual topology (fold embedding + OCS wiring)
that the cluster sets up for it and tears down after it — and other
jobs' wiring can be affected when the OCS layer is re-chained. The
cluster models used to mutate silently, which was fine for batch
simulation but leaves a service nothing to push to connected clients.

``StaticTorus`` and ``ReconfigTorus`` now emit a
:class:`TopologyEvent` to registered listeners on every commit and
release. Emission is pure notification — listeners observe state, they
never change it — and costs one ``if`` when nobody listens, so the
batch-simulation hot path is untouched (parity-tested).

``reconfigured`` is the paper-relevant bit: True when the commit or
release changed OCS wiring (a multi-cube chain or a wrap-ring closure
through the switch layer), i.e. when a real deployment would push
``RECONFIG`` to affected jobs rather than just ``SETUP`` to the new
one. A static torus is hardwired, so it never sets it.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List

Listener = Callable[["TopologyEvent"], None]


@dataclass(frozen=True)
class TopologyEvent:
    """One committed topology change.

    ``kind``          — ``"setup"`` | ``"release"`` | ``"fault"`` |
                        ``"repair"``. The fault/repair kinds are emitted
                        by the chaos layer (``repro_torch.sim.faults``)
                        when nodes, links or OCS ports fail or come
                        back; their ``job_id`` is ``-1`` (no owning job)
                        and ``detail`` carries the fault kind and targets.
    ``job_id``        — the job whose allocation changed.
    ``topology``      — ``"static"`` | ``"reconfig"``.
    ``reconfigured``  — OCS wiring changed (multi-cube chain or wrap
                        closure); always False on a static torus.
    ``detail``        — model-specific provenance (fold, box, cubes,
                        ocs_links, ...) — JSON-serializable scalars,
                        tuples and lists only.
    """

    kind: str
    job_id: int
    topology: str
    reconfigured: bool = False
    detail: Dict[str, Any] = field(default_factory=dict)


class EventLog:
    """Minimal listener: append every event (tests and debugging)."""

    def __init__(self) -> None:
        self.events: List[TopologyEvent] = []

    def __call__(self, ev: TopologyEvent) -> None:
        self.events.append(ev)


def emit(listeners: List[Listener], ev: TopologyEvent) -> None:
    """Deliver ``ev`` to every listener (exceptions propagate: a
    listener that throws is a programming error, not a condition the
    allocator should paper over)."""
    for fn in listeners:
        fn(ev)
