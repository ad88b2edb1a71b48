"""Blocking client for the allocator daemon + the simulator adapter.

:class:`SchedulerClient` is a plain-socket JSON-lines client: requests
are seq-tagged, replies matched by seq, and pushed events (``SETUP``/
``RECONFIG``/``RELEASE``) encountered while waiting are buffered for
:meth:`events`. One client = one connection; it is thread-safe for
request/reply (a lock serializes calls) and reconnectable — daemon
state is server-side, so a reconnected client resumes where it left
off.

Retries are **idempotent**: every request carries a
client-generated ``request_id`` (``"<client-id>:<seq>"``) which the
daemon dedups against its journal-backed cache, so a resent op after
a connection drop or timeout is applied exactly once. On a broken
socket or per-op timeout, :meth:`_request` reconnects with
exponential backoff + jitter and resends the *same* request_id up to
``max_retries`` times. The read buffer is cleared on every reconnect
— a half-received pre-reconnect line must never be parsed against
the new connection's stream (stale complete replies are additionally
dropped by seq). ``op_timeout`` bounds each attempt; exhausting all
attempts raises ``TimeoutError``/``ConnectionError``.

With ``lease_timeout`` configured daemon-side, call
:meth:`start_heartbeat` (the :class:`Scheduler` facade does this
automatically) so an idle client keeps its lease over submitted jobs.
Pass ``jitter`` to desynchronize a fleet of heartbeaters — after a
failover every surviving client reconnects at once, and identical
intervals would keep hammering the new leader in lockstep forever.

Failover: the constructor accepts a single ``(host, port)``
or a *list* of servers. A connection failure rotates to the next
server; a ``NOT_LEADER`` refusal follows the reply's ``leader``
redirect when present. Every reply carries the leader's fencing
``epoch``: the client keeps the highest epoch it has witnessed,
stamps it on every request (which force-fences any stale primary it
reaches), and *discards* replies carrying a lower epoch — an ack
from a superseded leader must never be surfaced as success. Combined
with idempotent request_ids, an in-flight op rides out a leader kill
exactly-once: the resend lands on the new leader, which either
applies it fresh or serves the reply its replicated dedup cache
already holds.

:class:`RemotePolicy` adapts the client to the
:class:`~repro_torch.core.allocator.PlacementPolicy` surface, which is what
rewires the discrete-event simulator as the service's first client:
``Simulator(RemotePolicy(client), jobs)`` runs the identical FIFO
discipline against the daemon-side allocator, and produces
byte-identical schedules to the in-process path (the daemon applies
the same deterministic ops in the same order — parity-tested and
asserted in CI).
"""
from __future__ import annotations

import random
import socket
import threading
import time
import uuid
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.core.allocator import Placement, PlacementPolicy
from repro_torch.core.geometry import JobShape

from . import protocol


def jittered_interval(interval: float, jitter: float, u: float) -> float:
    """Scale ``interval`` into ``[1-jitter, 1+jitter]`` of itself,
    driven by a uniform draw ``u`` in [0, 1). Pure so the bounds are
    unit-testable; the heartbeat thread feeds it fresh draws."""
    jitter = max(0.0, min(1.0, jitter))
    return interval * (1.0 + jitter * (2.0 * u - 1.0))


def _server_list(address) -> List[Tuple[str, int]]:
    """Accept one ``(host, port)`` or a list of them."""
    if not address:
        raise ValueError("need at least one scheduler address")
    if isinstance(address[0], str):
        return [(address[0], int(address[1]))]
    return [(a[0], int(a[1])) for a in address]


class SchedulerClient:
    """JSON-lines request/reply + event stream over one TCP socket."""

    def __init__(self, address, subscribe: bool = False,
                 connect_timeout: float = 5.0,
                 op_timeout: Optional[float] = 30.0,
                 max_retries: int = 4, backoff: float = 0.05,
                 client_id: Optional[str] = None):
        # Failover: one address or a preference-ordered server list;
        # ``self.address`` is whichever server we are dialed into.
        self.servers = _server_list(address)
        self._si = 0
        self.address = self.servers[0]
        self._want_subscribe = subscribe
        self._connect_timeout = connect_timeout
        self.op_timeout = op_timeout
        self.max_retries = max(0, int(max_retries))
        self.backoff = backoff
        # Stable identity: the daemon keys leases and idempotency on
        # it. Survives reconnects by construction.
        self.client_id = client_id or uuid.uuid4().hex[:12]
        self._lock = threading.Lock()
        self._seq = 0
        self._buf = bytearray()
        self._events: List[Dict[str, Any]] = []
        self._sock: Optional[socket.socket] = None
        self.retries = 0          # resend attempts that reconnected
        # Fencing watermark: highest epoch seen in any reply. Stamped
        # on every request; replies below it are discarded.
        self.epoch_seen = 0
        self.redirects = 0        # NOT_LEADER redirects followed
        self.stale_rejections = 0  # replies dropped for a stale epoch
        self._hb_stop: Optional[threading.Event] = None
        self._hb_thread: Optional[threading.Thread] = None
        self.connect()

    # -- connection ----------------------------------------------------
    def connect(self) -> None:
        """Dial (or re-dial) a daemon. Retries briefly so a client
        racing the daemon's bind — or reconnecting across a daemon
        restart — just works; each failed dial rotates to the next
        server in the list (failover). The read buffer is cleared:
        bytes of a half-received line from the old connection must
        never prefix the new stream (regression-tested)."""
        self.close()
        deadline = time.monotonic() + self._connect_timeout
        last: Optional[Exception] = None
        while time.monotonic() < deadline:
            self.address = self.servers[self._si % len(self.servers)]
            try:
                self._sock = socket.create_connection(self.address,
                                                      timeout=2.0)
                self._sock.settimeout(None)
                break
            except OSError as e:
                last = e
                self._si += 1
                time.sleep(0.02)
        else:
            raise ConnectionError(
                f"cannot reach scheduler at any of {self.servers}: {last}")
        self._buf = bytearray()
        if self._want_subscribe:
            self._send_one("subscribe")

    def _set_leader(self, leader: Tuple[str, int]) -> None:
        """Follow a NOT_LEADER redirect: make ``leader`` the current
        (and preferred) server, learning it if it wasn't listed."""
        leader = (leader[0], int(leader[1]))
        if leader not in self.servers:
            self.servers.append(leader)
        self._si = self.servers.index(leader)

    def close(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def stop_heartbeat(self) -> None:
        if self._hb_stop is not None:
            self._hb_stop.set()
            self._hb_stop = None
            self._hb_thread = None

    def start_heartbeat(self, interval: float,
                        jitter: float = 0.0) -> None:
        """Renew this client's lease every ``interval`` seconds from a
        daemon thread (any request renews too — the thread only
        matters while the client is otherwise idle). Errors are
        swallowed: a dead daemon fails the next real request.

        ``jitter`` (0..1) spreads each wait uniformly over
        ``interval * [1-jitter, 1+jitter]``: a fleet of clients that
        all reconnected at a failover would otherwise renew in
        lockstep against the new leader indefinitely."""
        self.stop_heartbeat()
        stop = self._hb_stop = threading.Event()
        rng = random.Random()   # per-thread phase, urandom-seeded

        def beat() -> None:
            while not stop.wait(jittered_interval(interval, jitter,
                                                  rng.random())):
                try:
                    self.heartbeat()
                except (ConnectionError, TimeoutError, OSError,
                        RuntimeError):
                    pass

        self._hb_thread = threading.Thread(
            target=beat, name="repro-scheduler-heartbeat", daemon=True)
        self._hb_thread.start()

    # -- line transport ------------------------------------------------
    def _readline(self, timeout: Optional[float]) -> Optional[bytes]:
        """One protocol line, or None on timeout. Manual buffering so
        socket timeouts never corrupt a buffered reader."""
        assert self._sock is not None
        while True:
            nl = self._buf.find(b"\n")
            if nl >= 0:
                line = bytes(self._buf[:nl + 1])
                del self._buf[:nl + 1]
                return line
            self._sock.settimeout(timeout)
            try:
                chunk = self._sock.recv(65536)
            except socket.timeout:
                return None
            finally:
                self._sock.settimeout(None)
            if not chunk:
                raise ConnectionError("scheduler closed the connection")
            self._buf.extend(chunk)

    def _await_reply(self, seq: int,
                     timeout: Optional[float]) -> Dict[str, Any]:
        """Read until the reply tagged ``seq`` arrives: pushed events
        are buffered, stale pre-reconnect replies dropped by seq."""
        deadline = (time.monotonic() + timeout
                    if timeout is not None else None)
        while True:
            remaining = None
            if deadline is not None:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError(
                        f"no reply from {self.address} within "
                        f"{self.op_timeout}s")
            line = self._readline(remaining)
            if line is None:
                raise TimeoutError(
                    f"no reply from {self.address} within "
                    f"{self.op_timeout}s")
            resp = protocol.decode(line)
            if "event" in resp:
                self._events.append(resp)
                continue
            if resp.get("seq") == seq:
                return resp
            # Stale reply from a pre-reconnect request: drop it.

    def _send_one(self, op: str, **fields) -> Dict[str, Any]:
        """One-shot request on the current socket — no retry loop.
        Used inside :meth:`connect` (re-subscribing a fresh
        connection), where the reconnect machinery must not recurse."""
        self._seq += 1
        seq = self._seq
        msg = {"op": op, "seq": seq, "client": self.client_id, **fields}
        assert self._sock is not None, "client is closed"
        self._sock.sendall(protocol.encode(msg))
        return self._await_reply(seq, self.op_timeout)

    def _request(self, op: str, _retries: Optional[int] = None,
                 **fields) -> Dict[str, Any]:
        """Send one op; on a broken connection or per-op timeout,
        reconnect (exponential backoff + jitter) and resend the same
        ``request_id`` — the daemon's dedup cache makes the retry
        exactly-once for journaled ops. ``_retries`` overrides
        ``max_retries`` for ops where retrying is pointless
        (``shutdown`` of a daemon that already went away).

        Failover semantics on top: a ``NOT_LEADER`` refusal
        follows the reply's ``leader`` redirect (or rotates to the
        next server) and counts as a retry; a reply whose ``epoch``
        is *below* our watermark is discarded as if the connection
        had failed — a superseded leader's ack is not an ack. Each
        attempt re-stamps the request with the current watermark, so
        any stale primary we do reach fences itself on receipt."""
        retries = self.max_retries if _retries is None else _retries
        with self._lock:
            self._seq += 1
            seq = self._seq
            msg = {"op": op, "seq": seq, "client": self.client_id,
                   "request_id": f"{self.client_id}:{seq}", **fields}
            last: Optional[Exception] = None
            for attempt in range(retries + 1):
                if attempt:
                    self.retries += 1
                    delay = min(2.0, self.backoff * (2 ** (attempt - 1)))
                    time.sleep(delay * (0.5 + random.random()))
                if self.epoch_seen:
                    msg["epoch"] = self.epoch_seen
                try:
                    if self._sock is None:
                        self.connect()
                    self._sock.sendall(protocol.encode(msg))
                    resp = self._await_reply(seq, self.op_timeout)
                except (ConnectionError, TimeoutError, OSError) as e:
                    last = e
                    self.close()
                    if len(self.servers) > 1:
                        self._si += 1   # try the next server first
                    continue
                ep = resp.get("epoch")
                if ep is not None:
                    if int(ep) < self.epoch_seen:
                        self.stale_rejections += 1
                        last = ConnectionError(
                            f"discarded reply from {self.address}: "
                            f"epoch {ep} < watermark {self.epoch_seen}")
                        self.close()
                        if len(self.servers) > 1:
                            self._si += 1
                        continue
                    self.epoch_seen = int(ep)
                if resp.get("not_leader") \
                        or resp.get("error") == protocol.NOT_LEADER:
                    self.redirects += 1
                    last = ConnectionError(
                        f"{self.address} is not the leader")
                    self.close()
                    leader = resp.get("leader")
                    if leader and (leader[0], int(leader[1])) \
                            != self.address:
                        self._set_leader((leader[0], leader[1]))
                    elif len(self.servers) > 1:
                        self._si += 1
                    continue
                return resp
            assert last is not None
            raise last

    def call(self, op: str, **fields) -> Dict[str, Any]:
        """Raw op; raises on protocol-level errors."""
        resp = self._request(op, **fields)
        if not resp.get("ok", False):
            raise RuntimeError(f"scheduler {op} failed: "
                               f"{resp.get('error', resp)}")
        return resp

    def heartbeat(self) -> Dict[str, Any]:
        """Renew this client's lease (any request renews; this one
        exists for otherwise-idle clients)."""
        return self.call("heartbeat")

    # -- service surface -----------------------------------------------
    def submit(self, shape, job_id: Optional[int] = None) -> Dict[str, Any]:
        dims = list(shape.dims) if hasattr(shape, "dims") else list(shape)
        fields: Dict[str, Any] = {"shape": dims}
        if job_id is not None:
            fields["job_id"] = job_id
        return self.call("submit", **fields)

    def done(self, job_id: int) -> Dict[str, Any]:
        return self.call("done", job_id=job_id)

    def preempt(self, job_id: int) -> Dict[str, Any]:
        """Evict a running job back to the queue head."""
        return self.call("preempt", job_id=job_id)

    def migrate(self, job_id: int) -> Dict[str, Any]:
        """Evict + replan a running job; ``outcome`` is ``migrated``
        (with the new placement) or ``preempted`` (queued at head)."""
        return self.call("migrate", job_id=job_id)

    def fault(self, kind: str, targets) -> Dict[str, Any]:
        """Inject a fabric fault (kind = node|link|ocs_port); the
        reply lists each victim's disposition."""
        return self.call("fault", kind=kind, targets=list(targets))

    def repair(self, kind: str, targets) -> Dict[str, Any]:
        """Undo a fault; no-op for targets that never failed."""
        return self.call("repair", kind=kind, targets=list(targets))

    def status(self) -> Dict[str, Any]:
        return self.call("status")

    def sync(self) -> Dict[str, Any]:
        return self.call("sync")

    def shutdown(self) -> Dict[str, Any]:
        # No retries: re-dialing a daemon that is already gone only
        # stalls the caller's teardown path.
        resp = self._request("shutdown", _retries=0)
        if not resp.get("ok", False):
            raise RuntimeError(f"scheduler shutdown failed: "
                               f"{resp.get('error', resp)}")
        return resp

    def events(self, max_wait: float = 0.0) -> List[Dict[str, Any]]:
        """Drain pushed events: everything buffered, plus whatever
        arrives within ``max_wait`` seconds (0 = only what is already
        here or in the socket buffer)."""
        out, self._events = self._events, []
        deadline = time.monotonic() + max_wait
        with self._lock:
            while True:
                remaining = deadline - time.monotonic()
                timeout = max(0.0, remaining) if max_wait else 0.0
                try:
                    line = self._readline(timeout or 0.000001)
                except ConnectionError:
                    break
                if line is None:
                    if remaining <= 0:
                        break
                    continue
                resp = protocol.decode(line)
                if "event" in resp:
                    out.append(resp)
        return out

    # -- raw policy ops ------------------------------------------------
    def try_place(self, job_id: int, shape) -> Dict[str, Any]:
        dims = list(shape.dims) if hasattr(shape, "dims") else list(shape)
        return self.call("try_place", job_id=job_id, shape=dims)

    def release(self, job_id: int) -> Dict[str, Any]:
        return self.call("release", job_id=job_id)

    def can_ever_place(self, shape) -> bool:
        dims = list(shape.dims) if hasattr(shape, "dims") else list(shape)
        return bool(self.call("can_ever_place", shape=dims)["feasible"])


class RemotePolicy(PlacementPolicy):
    """The in-process policy surface, served remotely.

    Plugs straight into :class:`repro_torch.sim.simulator.Simulator` — the
    simulator becomes a client of the daemon and cannot tell the
    difference: ops arrive at the daemon in the simulator's own call
    order, the daemon-side policy is deterministic in op order, and
    placement metadata round-trips losslessly (tuples restored), so
    schedules and metrics are byte-identical to in-process runs.
    ``can_ever_place`` feasibility is cached per canonical shape by
    the base class, exactly like an in-process policy — the daemon's
    own cache makes the extra RPC cheap either way."""

    def __init__(self, client: SchedulerClient):
        super().__init__()
        self.client = client
        st = client.status()
        self.name = st["policy"]
        self._num_xpus = int(st["num_xpus"])

    @property
    def num_xpus(self) -> int:
        return self._num_xpus

    @property
    def busy_xpus(self) -> int:
        return int(self.client.status()["busy_xpus"])

    def utilization(self) -> float:
        st = self.client.status()
        return int(st["busy_xpus"]) / int(st["num_xpus"])

    def try_place(self, job_id: int, shape: JobShape) -> Optional[Placement]:
        resp = self.client.try_place(job_id, shape)
        if resp["outcome"] != protocol.PLACED:
            return None
        p = resp["placement"]
        return Placement(
            job_id=int(p["job_id"]),
            shape=JobShape(tuple(int(v) for v in p["shape"])),
            broken_rings=tuple(int(v) for v in p["broken_rings"]),
            meta=protocol.detuple(p["meta"]))

    def release(self, job_id: int) -> None:
        self.client.release(job_id)

    def _can_ever_place(self, shape: JobShape) -> bool:
        return self.client.can_ever_place(shape)
