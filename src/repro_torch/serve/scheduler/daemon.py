"""Asyncio allocator daemon: the long-lived scheduling service.

One :class:`AllocatorCore` behind an asyncio TCP server speaking the
JSON-lines protocol (``protocol.py``). Connections are cheap
line-loops; ops are applied on the event loop — the core is
single-threaded by construction, so op order (the thing the journal
persists) is exactly the order requests hit the loop.

The daemon can share a fleet :class:`~repro_torch.sim.fleet.QueryBroker` as
its mask client: it registers itself like any simulator stepper, so
its placement queries coalesce into the same batched engine calls as
concurrently running simulations — serving and simulation share one
engine.

Liveness: every request carrying a ``client`` id renews that
client's wall-clock lease; with ``lease_timeout`` configured, an
expiry loop journals a ``lease_expire`` op (resolved action included,
so replay is policy-independent) for clients that went silent, and
their jobs are requeued or released per ``lease_policy``. Pushed
events ride **bounded** per-subscriber queues drained by a writer
task each — a subscriber that stops reading is marked lagged and
dropped (connection closed) instead of buffering without bound or
stalling the dispatch path behind its dead socket.

Crash semantics: :meth:`kill` drops the server and every connection
without a final checkpoint (the crash the recovery tests simulate);
graceful ``shutdown`` (op or :meth:`stop`) writes the journal first.
Either way the WAL (``journal.py``) already holds every acknowledged
op, so even a kill loses nothing.

Replication & fencing: a ``role="standby"`` daemon runs a
replication task that long-polls the primary's ``repl_pull`` op and
applies every framed record to its shadow core, so its state digest
tracks the primary record-for-record; until promoted it refuses
state-changing client ops with ``NOT_LEADER`` (redirecting to the
primary it tails). ``promote`` stops the tail, journals a new fencing
epoch and starts the lease loop — the standby *is* now the primary.
A superseded primary fences itself the moment it sees a higher epoch
(stamped on any request, or via an explicit ``fence`` op) and refuses
every write thereafter: nothing a stale leader acks can reach its
journal. In ``ack_mode="sync"`` the primary holds each journaled-op
reply until the standby's piggybacked ``acked`` cursor covers the
record (bounded by ``sync_timeout``), so an acked op survives even
primary disk loss.
"""
from __future__ import annotations

import asyncio
import base64
import time
from typing import Dict, List, Optional, Set, Tuple

from . import protocol
from .core import AllocatorCore, SchedulerConfig
from .journal import decode_frames


class _Subscriber:
    """One event-stream consumer: its bounded queue and pump task."""

    __slots__ = ("writer", "queue", "task", "lagged")

    def __init__(self, writer: asyncio.StreamWriter, depth: int):
        self.writer = writer
        self.queue: "asyncio.Queue[dict]" = asyncio.Queue(
            maxsize=max(1, depth))
        self.task: Optional[asyncio.Task] = None
        self.lagged = False


class SchedulerDaemon:
    """Owns the core, the server socket and the subscriber set."""

    def __init__(self, config: SchedulerConfig, mask_client=None,
                 recover: bool = True):
        self.config = config
        self.mask_client = mask_client
        self.core = (AllocatorCore.recover(config, mask_client)
                     if recover else AllocatorCore(config, mask_client))
        self._server: Optional[asyncio.base_events.Server] = None
        self._subscribers: Dict[asyncio.StreamWriter, _Subscriber] = {}
        self._writers: Set[asyncio.StreamWriter] = set()
        self._closing = asyncio.Event()
        self._killed = False
        self.address: Optional[tuple] = None
        # Liveness: client id -> monotonic lease deadline.
        self._leases: Dict[str, float] = {}
        self._lease_task: Optional[asyncio.Task] = None
        self.subscribers_dropped = 0
        # Replication & fencing.
        self.role = config.role
        self.fenced = False
        # Best leader hint for NOT_LEADER redirects: a standby knows
        # the primary it tails; a fenced primary learns it from the
        # fence op (if sent) and otherwise redirects blind.
        self.known_leader: Optional[Tuple[str, int]] = config.replicate_from
        self.fenced_rejections = 0
        self.sync_timeouts = 0
        self.repl_lag = 0                 # standby: leader len - local len
        self.last_repl_error: Optional[str] = None
        self._repl_task: Optional[asyncio.Task] = None
        self._new_record = asyncio.Event()   # wakes repl_pull long-polls
        self._follower_acked = 0             # highest standby-durable len
        self._last_pull: Optional[float] = None   # follower liveness
        self._ack_waiters: List[Tuple[int, asyncio.Future]] = []

    # -- lifecycle -----------------------------------------------------
    async def start(self) -> tuple:
        """Bind and serve; returns the (host, port) actually bound
        (``port=0`` requests an ephemeral port)."""
        self._server = await asyncio.start_server(
            self._handle, self.config.host, self.config.port)
        self.address = self._server.sockets[0].getsockname()[:2]
        if self.mask_client is not None \
                and hasattr(self.mask_client, "register"):
            # The daemon is one more live client of the shared broker.
            self.mask_client.register()
        if self.config.lease_timeout and self.role == protocol.ROLE_PRIMARY:
            # A standby must not expire leases: expiries are journaled
            # ops, and only the leader writes. Started at promotion.
            self._lease_task = asyncio.get_running_loop().create_task(
                self._lease_loop())
        if self.role == protocol.ROLE_STANDBY:
            self._repl_task = asyncio.get_running_loop().create_task(
                self._replicate_loop())
        return self.address

    async def wait_closed(self) -> None:
        """Block until shutdown is requested, then tear down: stop
        listening, drop every connection, then wait for the server.
        The connections go first because ``Server.wait_closed`` waits
        for every one of them to close (Python 3.12): a client that
        never hangs up would otherwise keep a killed daemon serving its
        requests."""
        await self._closing.wait()
        if self._server is not None:
            self._server.close()
        if self._lease_task is not None:
            self._lease_task.cancel()
        if self._repl_task is not None:
            self._repl_task.cancel()
        for sub in list(self._subscribers.values()):
            if sub.task is not None:
                sub.task.cancel()
        for w in list(self._writers):
            w.close()
        if self._server is not None:
            await self._server.wait_closed()
        if self.mask_client is not None \
                and hasattr(self.mask_client, "deactivate"):
            self.mask_client.deactivate()
        if not self._killed:
            self.core.sync_checkpoint()

    def stop(self) -> None:
        """Graceful stop (final checkpoint)."""
        self._closing.set()

    def kill(self) -> None:
        """Simulated crash: stop serving with NO final checkpoint —
        recovery must work from the last snapshot + the WAL tail."""
        self._killed = True
        self._closing.set()

    # -- liveness ------------------------------------------------------
    def _touch_lease(self, msg: dict) -> None:
        cid = msg.get("client")
        if cid is not None and self.config.lease_timeout:
            self._leases[str(cid)] = (time.monotonic()
                                      + self.config.lease_timeout)

    async def _lease_loop(self) -> None:
        """Expire clients that stopped sending. The expiry op is
        applied through the core exactly like a wire request — it
        journals the resolved action, so a recovered daemon replays
        the identical disposition."""
        period = max(0.01, self.config.lease_timeout / 4.0)
        while not self._closing.is_set():
            await asyncio.sleep(period)
            now = time.monotonic()
            expired = [cid for cid, dl in self._leases.items()
                       if dl <= now]
            for cid in expired:
                self._leases.pop(cid, None)
                before = len(self.core.journal)
                reply, events = self.core.apply(
                    {"op": "lease_expire", "client": cid,
                     "action": self.config.lease_policy})
                if len(self.core.journal) > before:
                    self._wake_repl()
                if events:
                    self._broadcast(events)

    # -- connection handling -------------------------------------------
    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        self._writers.add(writer)
        try:
            while True:
                line = await reader.readline()
                if not line:
                    break
                try:
                    msg = protocol.decode(line)
                except ValueError:
                    writer.write(protocol.encode(
                        {"ok": False, "error": "bad json"}))
                    await writer.drain()
                    continue
                await self._dispatch(msg, writer)
                if self._closing.is_set():
                    break
        except (ConnectionResetError, asyncio.IncompleteReadError):
            pass
        finally:
            self._writers.discard(writer)
            self._drop_subscriber(writer, lagged=False)
            writer.close()

    # Ops that journal — exactly what a non-leader must refuse. The
    # ``promote`` op is deliberately absent: it is how a standby
    # *becomes* the leader.
    _WRITE_OPS = frozenset(AllocatorCore.JOURNALED) - {"promote"}

    async def _dispatch(self, msg: dict,
                        writer: asyncio.StreamWriter) -> None:
        op = msg.get("op")
        self._touch_lease(msg)
        # Fencing: a request stamped with a higher epoch than ours is
        # proof a new leader was promoted while we were paused, dead
        # or partitioned — fence permanently before even looking at
        # the op.
        req_epoch = msg.get("epoch")
        if req_epoch is not None and int(req_epoch) > self.core.epoch:
            self.fenced = True
        if op == "subscribe":
            self._add_subscriber(writer)
            reply, events = {"ok": True, "subscribed": True}, []
        elif op == "shutdown":
            reply, events = {"ok": True, "shutdown": True}, []
        elif op == "promote":
            reply, events = await self._promote(msg)
        elif op == "fence":
            reply, events = self._fence(msg), []
        elif op == "repl_pull":
            reply, events = await self._repl_pull(msg), []
        elif op in self._WRITE_OPS and (
                self.fenced or self.role != protocol.ROLE_PRIMARY):
            # Journal-side fencing: nothing a stale or standby daemon
            # acks may reach its journal.
            self.fenced_rejections += 1
            reply, events = {"ok": False, "error": protocol.NOT_LEADER,
                             "not_leader": True, "role": self.role}, []
            if self.known_leader is not None:
                reply["leader"] = list(self.known_leader)
        else:
            before = len(self.core.journal)
            reply, events = self.core.apply(msg)
            if len(self.core.journal) > before:
                self._wake_repl()
                if self.config.ack_mode == "sync":
                    # Hold the ack until the standby has fsynced the
                    # record (or sync_timeout passes: availability
                    # over replication when the standby is down).
                    reply["replicated"] = await self._await_replicated(
                        len(self.core.journal))
            if op == "status" and reply.get("ok"):
                # Daemon-side liveness/backpressure/replication
                # counters piggyback on the core's snapshot.
                reply["leases"] = len(self._leases)
                reply["subscribers"] = len(self._subscribers)
                reply["subscribers_dropped"] = self.subscribers_dropped
                reply["role"] = self.role
                reply["fenced"] = self.fenced
                reply["repl"] = {
                    "lag": self.repl_lag,
                    "follower_acked": self._follower_acked,
                    "follower_live": self._last_pull is not None,
                    "fenced_rejections": self.fenced_rejections,
                    "sync_timeouts": self.sync_timeouts,
                    "ack_mode": self.config.ack_mode,
                    "last_error": self.last_repl_error,
                }
        # Every reply carries the fencing token: clients keep a
        # high-water mark and discard replies from superseded leaders.
        reply.setdefault("epoch", self.core.epoch)
        if "seq" in msg:
            reply["seq"] = msg["seq"]
        writer.write(protocol.encode(reply))
        await writer.drain()
        if events:
            self._broadcast(events)
        if op == "shutdown":
            self.stop()

    # -- replication & fencing -----------------------------------------
    def _wake_repl(self) -> None:
        """New journal record: release every long-polling repl_pull."""
        ev, self._new_record = self._new_record, asyncio.Event()
        ev.set()

    def _note_acked(self, acked: int) -> None:
        """The follower's pull piggybacked its durable length; resolve
        any sync-mode acks now covered."""
        if acked <= self._follower_acked:
            return
        self._follower_acked = acked
        for target, fut in self._ack_waiters:
            if target <= acked and not fut.done():
                fut.set_result(True)
        self._ack_waiters = [(t, f) for t, f in self._ack_waiters
                             if not f.done()]

    async def _await_replicated(self, target: int) -> bool:
        """Sync ack mode: block until the standby has fsynced journal
        length ``target``, or sync_timeout (degraded ack). With no
        live follower (none ever pulled, or silent for longer than
        sync_timeout — e.g. right after a promotion) degrade
        immediately: availability over a wait nobody will satisfy."""
        if self._follower_acked >= target:
            return True
        if (self._last_pull is None
                or time.monotonic() - self._last_pull
                > self.config.sync_timeout):
            self.sync_timeouts += 1
            return False
        fut = asyncio.get_running_loop().create_future()
        self._ack_waiters.append((target, fut))
        try:
            await asyncio.wait_for(fut, self.config.sync_timeout)
            return True
        except asyncio.TimeoutError:
            self.sync_timeouts += 1
            return False

    async def _promote(self, msg: dict):
        """Become the leader: stop tailing, mint + journal a new
        fencing epoch, start expiring leases. Idempotent on a daemon
        that already leads (the core refuses a stale epoch)."""
        if self._repl_task is not None:
            self._repl_task.cancel()
            try:
                await self._repl_task
            except asyncio.CancelledError:
                pass
            self._repl_task = None
        self.role = protocol.ROLE_PRIMARY
        self.fenced = False
        reply, events = self.core.apply(
            {"op": "promote",
             **{k: msg[k] for k in ("epoch", "request_id", "client")
                if k in msg}})
        if reply.get("promoted"):
            self._wake_repl()
        # Our old follower-liveness state described the *previous*
        # leader's replication session, not ours.
        self._follower_acked = 0
        self._last_pull = None
        self.known_leader = tuple(self.address) if self.address else None
        if self.config.lease_timeout and self._lease_task is None:
            self._lease_task = asyncio.get_running_loop().create_task(
                self._lease_loop())
        reply["role"] = self.role
        return reply, events

    def _fence(self, msg: dict) -> dict:
        """Best-effort notice that a higher epoch exists. The stamped
        request already fenced us in _dispatch; this records the new
        leader's address for redirects."""
        if msg.get("leader"):
            h, p = msg["leader"]
            self.known_leader = (str(h), int(p))
        return {"ok": True, "fenced": self.fenced,
                "role": self.role}

    async def _repl_pull(self, msg: dict) -> dict:
        """Serve the replication stream: WAL-framed records from the
        follower's journal-index cursor. ``wait`` long-polls until a
        record lands (bounded by repl_poll); ``acked`` piggybacks the
        follower's durable length for sync ack mode."""
        fp = self.core.config.fingerprint()
        if msg.get("fingerprint") not in (None, fp):
            return {"ok": False, "error": "fingerprint mismatch",
                    "fingerprint": fp}
        self._last_pull = time.monotonic()
        if msg.get("acked") is not None:
            self._note_acked(int(msg["acked"]))
        index = int(msg.get("index", 0))
        if index > len(self.core.journal):
            # A follower ahead of us is tailing someone else's log
            # (or ours from a previous life): refuse, never rewind it.
            return {"ok": False, "error": "cursor past journal end",
                    "journal_len": len(self.core.journal)}
        if msg.get("wait") and index >= len(self.core.journal):
            ev = self._new_record
            try:
                await asyncio.wait_for(ev.wait(), self.config.repl_poll)
            except asyncio.TimeoutError:
                pass
        frames, nxt = self.core.journal_frames(index)
        return {"ok": True, "fingerprint": fp, "index": index,
                "next": nxt, "journal_len": len(self.core.journal),
                "role": self.role,
                "frames": base64.b64encode(frames).decode("ascii")}

    async def _replicate_loop(self) -> None:
        """Standby: tail the primary record-for-record. Long-polls
        ``repl_pull`` with our journal length as both cursor and
        durable-ack (our core fsyncs each applied record to its own
        WAL before the next pull), applies every intact frame, and
        reconnects with backoff across primary restarts — a dead
        primary leaves the standby warm and promotable, not crashed."""
        host, port = self.config.replicate_from
        fp = self.core.config.fingerprint()
        backoff = 0.05
        seq = 0
        read_timeout = self.config.repl_poll + 5.0
        while not self._closing.is_set():
            try:
                reader, writer = await asyncio.open_connection(host, port)
            except OSError as e:
                self.last_repl_error = f"{type(e).__name__}: {e}"
                await asyncio.sleep(backoff)
                backoff = min(1.0, backoff * 2)
                continue
            backoff = 0.05
            try:
                while not self._closing.is_set():
                    seq += 1
                    writer.write(protocol.encode(
                        {"op": "repl_pull", "seq": seq,
                         "fingerprint": fp,
                         "index": len(self.core.journal),
                         "acked": len(self.core.journal),
                         "wait": True}))
                    await writer.drain()
                    line = await asyncio.wait_for(reader.readline(),
                                                  read_timeout)
                    if not line:
                        break
                    resp = protocol.decode(line)
                    if not resp.get("ok"):
                        self.last_repl_error = str(resp.get("error"))
                        break
                    blob = base64.b64decode(resp.get("frames", ""))
                    records, torn = decode_frames(blob)
                    if torn:
                        self.last_repl_error = "torn frame in pull reply"
                        break   # reconnect and re-pull from our cursor
                    for rec in records:
                        if rec.get("i") != len(self.core.journal):
                            break   # gap/overlap: re-pull from cursor
                        self.core.apply_replicated(rec)
                    self.repl_lag = max(
                        0, int(resp.get("journal_len", 0))
                        - len(self.core.journal))
            except (OSError, ValueError, ConnectionResetError,
                    asyncio.TimeoutError, asyncio.IncompleteReadError) as e:
                self.last_repl_error = f"{type(e).__name__}: {e}"
            finally:
                writer.close()
            await asyncio.sleep(0.01)

    # -- subscribers (bounded queues, lagged-drop) ---------------------
    def _add_subscriber(self, writer: asyncio.StreamWriter) -> None:
        if writer in self._subscribers:
            return
        sub = _Subscriber(writer, self.config.subscriber_queue)
        sub.task = asyncio.get_running_loop().create_task(
            self._pump(sub))
        self._subscribers[writer] = sub

    async def _pump(self, sub: _Subscriber) -> None:
        """Per-subscriber writer: drains the bounded queue to the
        socket. Slow consumers exert backpressure *here* (the drain
        blocks this task only), never on the dispatch path."""
        try:
            while True:
                ev = await sub.queue.get()
                sub.writer.write(protocol.encode(ev))
                await sub.writer.drain()
        except (ConnectionResetError, RuntimeError, OSError,
                asyncio.CancelledError):
            pass

    def _offer(self, sub: _Subscriber, events) -> bool:
        """Enqueue events for one subscriber without ever blocking
        dispatch. Returns False when its queue overflowed — the
        subscriber is lagged and must be dropped (the alternative is
        unbounded buffering for a consumer that stopped reading)."""
        for ev in events:
            try:
                sub.queue.put_nowait(ev)
            except asyncio.QueueFull:
                sub.lagged = True
                return False
        return True

    def _broadcast(self, events) -> None:
        for writer, sub in list(self._subscribers.items()):
            if not self._offer(sub, events):
                self._drop_subscriber(writer, lagged=True)

    def _drop_subscriber(self, writer: asyncio.StreamWriter,
                         lagged: bool) -> None:
        sub = self._subscribers.pop(writer, None)
        if sub is None:
            return
        if lagged:
            self.subscribers_dropped += 1
            if sub.task is not None:
                sub.task.cancel()
            self._writers.discard(writer)
            writer.close()

    # -- convenience ---------------------------------------------------
    async def serve_forever(self) -> None:
        await self.start()
        await self.wait_closed()
