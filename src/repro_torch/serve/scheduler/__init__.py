"""Allocator-as-a-service: long-lived scheduling daemon + clients.

Layers (each importable on its own):

  * :mod:`.protocol` — JSON-lines wire format and outcome constants.
  * :mod:`.core`     — :class:`SchedulerConfig` + :class:`AllocatorCore`
                       (policy, FIFO queue, admission, op journal,
                       checkpoint recovery via the eval store).
  * :mod:`.daemon`   — :class:`SchedulerDaemon`, the asyncio server.
  * :mod:`.client`   — :class:`SchedulerClient` (blocking socket) and
                       :class:`RemotePolicy` (simulator adapter).
  * :mod:`.service`  — :class:`Scheduler`, the thread-hosted facade.

Most callers want :class:`Scheduler` via :mod:`repro_torch.api`.
"""
from __future__ import annotations

from .client import RemotePolicy, SchedulerClient, jittered_interval
from .core import AllocatorCore, SchedulerConfig
from .daemon import SchedulerDaemon
from .protocol import (DROPPED, EV_FAULT, EV_MIGRATE, EV_PREEMPT,
                       EV_RECONFIG, EV_RELEASE, EV_REPAIR, EV_SETUP,
                       MIGRATED, NOT_LEADER, PLACED, PREEMPTED, QUEUED,
                       REJECTED, ROLE_PRIMARY, ROLE_STANDBY)
from .service import HEARTBEAT_JITTER, Scheduler

__all__ = [
    "HEARTBEAT_JITTER",
    "NOT_LEADER",
    "ROLE_PRIMARY",
    "ROLE_STANDBY",
    "jittered_interval",
    "AllocatorCore",
    "RemotePolicy",
    "Scheduler",
    "SchedulerClient",
    "SchedulerConfig",
    "SchedulerDaemon",
    "PLACED",
    "QUEUED",
    "DROPPED",
    "REJECTED",
    "PREEMPTED",
    "MIGRATED",
    "EV_SETUP",
    "EV_RECONFIG",
    "EV_RELEASE",
    "EV_FAULT",
    "EV_REPAIR",
    "EV_PREEMPT",
    "EV_MIGRATE",
]
