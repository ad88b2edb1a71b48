"""Thread-hosted allocator service: daemon + client in one handle.

:class:`Scheduler` runs a :class:`SchedulerDaemon` on a private asyncio
loop in a background thread and keeps one subscribed
:class:`SchedulerClient` for the caller — so synchronous code (the
public ``repro_torch.api`` facade, tests, benchmarks) gets submit/done/events
without touching asyncio. It is also the crash-recovery harness:
:meth:`kill` tears the daemon down *without* a final checkpoint, and a
new ``Scheduler`` on the same ``checkpoint_dir`` recovers by journal
replay.

Replication: construct with ``role="standby"`` and
``replicate_from=primary.address`` for a warm standby that tails the
primary's journal; :meth:`promote` makes it the fenced leader. The
facade's auto-heartbeat is jittered (``HEARTBEAT_JITTER``) so a fleet
of facade clients that reconnect together after a failover spreads
its renewals instead of hitting the new leader in lockstep.
"""
from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional

from .client import RemotePolicy, SchedulerClient
from .core import SchedulerConfig
from .daemon import SchedulerDaemon

# Fractional spread of the auto-heartbeat interval (see
# SchedulerClient.start_heartbeat): each wait is drawn uniformly from
# interval * [1-J, 1+J]. 0.25 keeps the shortest wait well above the
# lease-renewal deadline (interval is lease_timeout / 3).
HEARTBEAT_JITTER = 0.25


class Scheduler:
    """Start a daemon, talk to it, stop (or crash) it."""

    def __init__(self, config: Optional[SchedulerConfig] = None,
                 mask_client=None, recover: bool = True, **config_kw):
        if config is None:
            config = SchedulerConfig(**config_kw)
        elif config_kw:
            raise TypeError("pass either a SchedulerConfig or kwargs, "
                            "not both")
        self.config = config
        self._mask_client = mask_client
        self._recover = recover
        self._daemon: Optional[SchedulerDaemon] = None
        self._loop = None
        self._thread: Optional[threading.Thread] = None
        self._ready = threading.Event()
        self._boot_error: Optional[BaseException] = None
        self._client: Optional[SchedulerClient] = None
        self.address: Optional[tuple] = None

    # -- lifecycle -----------------------------------------------------
    def start(self) -> "Scheduler":
        if self._thread is not None:
            raise RuntimeError("scheduler already started")
        self._thread = threading.Thread(target=self._run,
                                        name="repro-scheduler", daemon=True)
        self._thread.start()
        if not self._ready.wait(timeout=30.0):
            raise RuntimeError("scheduler daemon failed to come up")
        if self._boot_error is not None:
            raise self._boot_error
        self._client = SchedulerClient(self.address, subscribe=True)
        self._auto_heartbeat(self._client)
        return self

    def _auto_heartbeat(self, client: SchedulerClient) -> None:
        """With leases on, every facade-owned client heartbeats at a
        third of the lease timeout — an idle handle must not lose its
        jobs to the expiry loop."""
        if self.config.lease_timeout:
            client.start_heartbeat(self.config.lease_timeout / 3.0,
                                   jitter=HEARTBEAT_JITTER)

    def _run(self) -> None:
        import asyncio

        async def main() -> None:
            try:
                # Recovery and the engine's resolution happen here: a
                # daemon that cannot place (the default ``cuda`` engine
                # with no card) makes ``start`` raise, not hang.
                self._daemon = SchedulerDaemon(self.config,
                                               self._mask_client,
                                               recover=self._recover)
                self.address = await self._daemon.start()
            except BaseException as e:
                self._boot_error = e
                self._ready.set()
                return
            self._loop = asyncio.get_running_loop()
            self._ready.set()
            await self._daemon.wait_closed()

        asyncio.run(main())

    def _shut(self, crash: bool) -> None:
        if self._thread is None:
            return
        if self._client is not None:
            self._client.stop_heartbeat()
            try:
                if crash:
                    self._client.close()
                else:
                    self._client.shutdown()
            except (RuntimeError, ConnectionError, OSError,
                    TimeoutError):
                pass
            if crash:
                self._client = None
        if self._loop is not None and self._daemon is not None:
            target = self._daemon.kill if crash else self._daemon.stop
            try:
                self._loop.call_soon_threadsafe(target)
            except RuntimeError:
                pass  # loop already gone
        self._thread.join(timeout=30.0)
        self._thread = None
        if self._client is not None:
            self._client.close()
            self._client = None

    def stop(self) -> None:
        """Graceful shutdown: daemon writes a final checkpoint."""
        self._shut(crash=False)

    def kill(self) -> None:
        """Simulated crash: NO final checkpoint — the next Scheduler on
        this checkpoint_dir must recover from the last periodic one."""
        self._shut(crash=True)

    def __enter__(self) -> "Scheduler":
        return self.start() if self._thread is None else self

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- client surface ------------------------------------------------
    @property
    def client(self) -> SchedulerClient:
        if self._client is None:
            raise RuntimeError("scheduler not started")
        return self._client

    def new_client(self, subscribe: bool = False) -> SchedulerClient:
        """An independent connection (e.g. to drive a Simulator via
        RemotePolicy while this handle watches events)."""
        if self.address is None:
            raise RuntimeError("scheduler not started")
        client = SchedulerClient(self.address, subscribe=subscribe)
        self._auto_heartbeat(client)
        return client

    def remote_policy(self) -> RemotePolicy:
        """A PlacementPolicy adapter over a fresh connection."""
        return RemotePolicy(self.new_client())

    def submit(self, shape, job_id: Optional[int] = None) -> Dict[str, Any]:
        return self.client.submit(shape, job_id=job_id)

    def done(self, job_id: int) -> Dict[str, Any]:
        return self.client.done(job_id)

    def preempt(self, job_id: int) -> Dict[str, Any]:
        return self.client.preempt(job_id)

    def migrate(self, job_id: int) -> Dict[str, Any]:
        return self.client.migrate(job_id)

    def fault(self, kind: str, targets) -> Dict[str, Any]:
        return self.client.fault(kind, targets)

    def repair(self, kind: str, targets) -> Dict[str, Any]:
        return self.client.repair(kind, targets)

    def events(self, max_wait: float = 0.0) -> List[Dict[str, Any]]:
        return self.client.events(max_wait=max_wait)

    def status(self) -> Dict[str, Any]:
        return self.client.status()

    def sync(self) -> Dict[str, Any]:
        return self.client.sync()

    def promote(self) -> Dict[str, Any]:
        """Make this daemon the leader: stop tailing (if a standby),
        mint + journal a new fencing epoch, start expiring leases."""
        return self.client.call("promote")
