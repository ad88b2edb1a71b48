"""The allocator state machine behind the scheduler daemon.

:class:`AllocatorCore` owns one placement policy and gives it service
semantics: streaming submissions with FIFO queueing (head-of-line
blocking, optionally backfill — the simulator's admission discipline,
shared by construction), admission control under overload
(``max_queue``), pushed topology events, and crash recovery.

Placement runs on ``config.engine``: by default the ``cuda`` fitmask
kernels on the card (K1/K2 for the reconfigurable tori, K3 for the
static ones), which raise without a card — the core never falls back
to the host. Every reply and event holds host values only (ints,
floats, strings, lists), so it encodes whatever engine placed the job;
the occupancy and fault state that :meth:`AllocatorCore.state_digest`
hashes are the model's numpy arrays on every engine.

Persistence is **journal replay** over the fingerprinted checkpoint
store from ``repro_torch.eval.runner``: placement is a deterministic
function of the op order (the same property that makes the fleet
broker bit-exact), so the durable state is simply the ordered list of
state-changing ops. :class:`SchedulerConfig` implements the
``fingerprint()``/``checkpoint_name()`` duck-type the store keys on,
which buys atomic tmp+rename writes, fingerprint-prefix sharding and
``prune_checkpoints`` compatibility for free — and means a daemon
restarted with a *different* config refuses to resume a stale journal
(the fingerprint gates the load, exactly as eval resume does).

Durability is snapshot + write-ahead tail: every journaled op
is appended to a CRC32+length-framed WAL (``journal.py``) and fsynced
**before** the reply is sent, so recovery is ``snapshot ⊕ WAL tail``
— a crash between snapshots loses nothing acknowledged, and a torn
trailing record is truncated away instead of poisoning recovery.
Requests may carry a client-generated ``request_id``; replies to
journaled ops are remembered in a bounded dedup cache (persisted via
the journal itself — replay regenerates the identical replies), so a
retried op after a reconnect is applied exactly once. Ops may also
carry a ``client`` id, which makes the submitting client the job's
*lease holder*: ``op_lease_expire`` (journaled with its resolved
action, so replay never depends on current config) requeues or
releases a dead client's jobs.

Replication: the in-memory journal doubles as the replication
log — a standby's cursor is just a journal index, served as WAL-framed
bytes by :meth:`AllocatorCore.journal_frames` and applied on the
standby via :meth:`AllocatorCore.apply_replicated` (replay-mode apply
+ append to the standby's *own* WAL, so a promoted standby recovers
like any primary). Leadership is fenced by a monotonic ``epoch``
stamped on every journal record (``"e"``): promotion journals a
``promote`` op carrying the new epoch, so the fencing token survives
recovery and replication by the same mechanism as everything else.
The epoch is deliberately excluded from :meth:`state_digest` — an
uninterrupted control run and a failover run must digest-identically.
"""
from __future__ import annotations

import hashlib
import json
import os
from collections import OrderedDict
from dataclasses import dataclass, field, fields
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.core.allocator import make_policy
from repro_torch.core.engineconfig import EngineConfig
from repro_torch.core.events import TopologyEvent
from repro_torch.core.geometry import JobShape
from repro_torch.eval.runner import save_checkpoint, shard_dir, verify_record
from repro_torch.sim.faults import FaultEvent, FaultInjector

from . import protocol
from .journal import JournalWriter, encode_frames, recover_journal


@dataclass
class SchedulerConfig:
    """Everything that determines the daemon's behaviour (and hence
    its checkpoint identity)."""

    policy: str = "rfold"
    policy_kw: Dict[str, Any] = field(default_factory=dict)
    backfill: bool = False
    # Admission: queue depth cap; None = queue without bound. A submit
    # arriving at a full queue is REJECTED (stateless — not journaled).
    max_queue: Optional[int] = None
    engine: EngineConfig = field(default_factory=EngineConfig)
    # Persistence: None disables checkpointing entirely.
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 64       # journaled ops between snapshots
    # fsync every WAL append (durability); False trades the last few
    # acknowledged ops for latency, crash *consistency* is unaffected.
    fsync: bool = True
    # Liveness: a client that stops heartbeating for lease_timeout
    # seconds loses its lease; its jobs are requeued (work-preserving)
    # or released, per lease_policy. None disables leases entirely.
    lease_timeout: Optional[float] = None
    lease_policy: str = "requeue"    # "requeue" | "release"
    # Idempotency: replies to journaled ops are remembered per
    # request_id so a retried op is applied exactly once. 0 disables.
    dedup_cache: int = 1024
    # Backpressure: per-subscriber pushed-event queue depth; a
    # subscriber whose queue overflows is marked lagged and dropped.
    subscriber_queue: int = 1024
    # Daemon bind address; port 0 = ephemeral (read it back after start).
    host: str = "127.0.0.1"
    port: int = 0
    # Replication. A "standby" daemon tails the primary at
    # ``replicate_from`` = (host, port), refuses client writes with
    # NOT_LEADER until promoted, and keeps a shadow core whose digest
    # tracks the primary record-for-record.
    role: str = "primary"            # "primary" | "standby"
    replicate_from: Optional[Tuple[str, int]] = None
    # Ack mode of a *primary*: "sync" holds each journaled-op reply
    # until the standby has fsynced the record (bounded by
    # sync_timeout, after which the op acks degraded — availability
    # over replication when the standby is down); "async" acks after
    # the local fsync only.
    ack_mode: str = "async"          # "async" | "sync"
    sync_timeout: float = 2.0
    # Long-poll window (seconds) for follower repl_pull waits.
    repl_poll: float = 0.5

    def __post_init__(self):
        self.engine = EngineConfig.coerce(self.engine)
        if self.lease_policy not in ("requeue", "release"):
            raise ValueError("lease_policy must be 'requeue' or "
                             f"'release', got {self.lease_policy!r}")
        if self.role not in ("primary", "standby"):
            raise ValueError("role must be 'primary' or 'standby', "
                             f"got {self.role!r}")
        if self.ack_mode not in ("async", "sync"):
            raise ValueError("ack_mode must be 'async' or 'sync', "
                             f"got {self.ack_mode!r}")
        if self.role == "standby" and self.replicate_from is None:
            raise ValueError("a standby needs replicate_from=(host, "
                             "port) of the primary to tail")
        if self.replicate_from is not None:
            h, p = self.replicate_from
            self.replicate_from = (str(h), int(p))

    # -- checkpoint-store duck-type (repro_torch.eval.runner) ----------
    def fingerprint(self) -> str:
        """Hash of every field that affects placement outcomes. The
        transport fields (host/port), checkpoint cadence and the
        resilience knobs (fsync, leases, dedup, backpressure,
        role/replication/ack mode) are excluded: moving the daemon,
        retuning snapshot frequency or lease policy, or promoting a
        standby must not orphan its journal — lease expiries are
        journaled with their *resolved* action, so replay never
        consults the current lease_policy, and a primary and its
        standby share one fingerprint (the replication stream id).

        The engine's ``device`` is left out for the same reason: every
        engine places bit-exactly on every device, and a ``torch.device``
        would hash as ``cuda`` or ``cuda:0`` by its spelling. The other
        engine fields are hashed as the reference package hashes its
        own, so a config on ``engine="numpy"`` has the reference's
        fingerprint and checkpoint name."""
        engine = {f.name: getattr(self.engine, f.name)
                  for f in fields(self.engine) if f.name != "device"}
        blob = json.dumps({"policy": self.policy,
                           "policy_kw": self.policy_kw,
                           "backfill": self.backfill,
                           "max_queue": self.max_queue,
                           "engine": engine},
                          sort_keys=True, default=str)
        return hashlib.sha256(blob.encode()).hexdigest()[:16]

    def checkpoint_name(self) -> str:
        return f"scheduler_{self.policy}__r0__{self.fingerprint()}.json"


class AllocatorCore:
    """Single-threaded allocator behind the daemon (the event loop
    serializes ops, so no locking here). Every public op returns
    ``(reply, events)``: the tagged reply for the requester and the
    untagged event dicts to broadcast to subscribers."""

    JOURNALED = ("submit", "done", "try_place", "release",
                 "preempt", "migrate", "fault", "repair",
                 "lease_expire", "promote")

    def __init__(self, config: SchedulerConfig, mask_client=None):
        self.config = config
        # Resolve the engine now: a core whose engine cannot run (the
        # default ``cuda`` with no card) fails here, before it binds a
        # socket or journals an op, instead of on its first placement.
        config.engine.get_engine()
        self.policy = make_policy(config.policy,
                                  mask_client=mask_client,
                                  engine=config.engine,
                                  **config.policy_kw)
        self.model = (getattr(self.policy, "torus", None)
                      or getattr(self.policy, "cluster", None))
        self.model.listeners.append(self._on_topology)
        # FIFO queue of (job_id, shape-dims); mirrors the simulator's
        # head-of-line blocking (backfill optional).
        self.queue: List[Tuple[int, Tuple[int, int, int]]] = []
        # Shapes of *allocated* jobs — what preempt/migrate/fault
        # replanning re-places. Rebuilt by journal replay like every
        # other piece of state.
        self.shapes: Dict[int, Tuple[int, int, int]] = {}
        self._injector: Optional[FaultInjector] = None
        self.next_id = 0
        # Durable state: the ordered journal of state-changing ops.
        self.journal: List[Dict[str, Any]] = []
        self._ops_since_sync = 0
        self._replaying = False
        self._pending_topo: List[TopologyEvent] = []
        self.recovered_ops = 0
        # Lease ownership: job_id -> client id, rebuilt by replay from
        # the ``client`` field journaled ops carry.
        self.owners: Dict[int, str] = {}
        # Idempotency: request_id -> reply for journaled ops (bounded
        # LRU; replay regenerates identical entries from the journal).
        self._dedup: "OrderedDict[str, Dict[str, Any]]" = OrderedDict()
        self._current_rid: Optional[str] = None
        self._current_client: Optional[str] = None
        self._wal: Optional[JournalWriter] = None
        # Fencing token: monotonic leadership epoch. Stamped as "e" on
        # every journal record; promotion journals a bump, so the
        # epoch recovers and replicates like all other state. NOT part
        # of state_digest (a failover run must digest-match its
        # uninterrupted control).
        self.epoch = 1
        self.counters: Dict[str, int] = {
            "dedup_hits": 0, "lease_expiries": 0,
            "wal_tail_ops": 0, "wal_truncated": 0,
            "repl_applied": 0, "promotions": 0,
        }

    # -- topology listener --------------------------------------------
    def _on_topology(self, ev: TopologyEvent) -> None:
        if not self._replaying:
            self._pending_topo.append(ev)

    def _drain_topo(self) -> List[Dict[str, Any]]:
        """Convert buffered TopologyEvents into wire event dicts.
        A setup that changed OCS wiring pushes RECONFIG alongside
        SETUP (clients that only care about their own placement read
        SETUP; clients tracking the switch layer read RECONFIG)."""
        out: List[Dict[str, Any]] = []
        for ev in self._pending_topo:
            if ev.kind == "setup":
                out.append({"event": protocol.EV_SETUP,
                            "job_id": ev.job_id, "detail": ev.detail})
                if ev.reconfigured:
                    out.append({"event": protocol.EV_RECONFIG,
                                "job_id": ev.job_id,
                                "topology": ev.topology,
                                "detail": ev.detail})
            elif ev.kind in ("fault", "repair"):
                out.append({"event": (protocol.EV_FAULT
                                      if ev.kind == "fault"
                                      else protocol.EV_REPAIR),
                            "topology": ev.topology,
                            "detail": ev.detail})
            else:
                out.append({"event": protocol.EV_RELEASE,
                            "job_id": ev.job_id,
                            "reconfigured": ev.reconfigured,
                            "detail": ev.detail})
        self._pending_topo = []
        return out

    # -- journal / persistence ----------------------------------------
    def _journal_op(self, op: Dict[str, Any]) -> None:
        if self._replaying:
            return
        if self._current_rid is not None:
            op["rid"] = self._current_rid
        if self._current_client is not None:
            op["client"] = self._current_client
        # Fencing: every record carries the epoch it was written
        # under, so replication and recovery both restore the token.
        op["e"] = self.epoch
        self.journal.append(op)
        if not self.config.checkpoint_dir:
            return
        # WAL first: the op is durable (framed, CRC'd, fsynced) before
        # any reply can leave the daemon. ``i`` is the op's journal
        # index — recovery uses it to skip records the snapshot
        # already subsumes (crash between snapshot write and WAL
        # reset must not double-apply).
        self._wal_writer().append({"i": len(self.journal) - 1, **op})
        self._ops_since_sync += 1
        if (self.config.checkpoint_every
                and self._ops_since_sync >= self.config.checkpoint_every):
            self.sync_checkpoint()

    def _wal_path(self) -> str:
        cfg = self.config
        return os.path.join(shard_dir(cfg.checkpoint_dir,
                                      cfg.fingerprint()),
                            cfg.checkpoint_name() + ".wal")

    def _wal_writer(self) -> JournalWriter:
        if self._wal is None:
            self._wal = JournalWriter(self._wal_path(),
                                      fsync=self.config.fsync)
        return self._wal

    def sync_checkpoint(self) -> Optional[str]:
        """Write the journal snapshot now (atomic tmp+rename via the
        eval store), then reset the WAL it subsumes. Returns the
        checkpoint path, or None when persistence is off."""
        cfg = self.config
        if not cfg.checkpoint_dir:
            return None
        rec = {"fingerprint": cfg.fingerprint(), "format": 1,
               "next_id": self.next_id, "journal": self.journal}
        save_checkpoint(cfg.checkpoint_dir, cfg, rec)
        self._wal_writer().reset()
        self._ops_since_sync = 0
        return os.path.join(shard_dir(cfg.checkpoint_dir,
                                      cfg.fingerprint()),
                            cfg.checkpoint_name())

    @staticmethod
    def load_state(config: SchedulerConfig) -> Optional[Dict[str, Any]]:
        """The stored journal record for this config, or None (no
        store, no file, or fingerprint mismatch — a changed config
        must start fresh, never resume another config's journal)."""
        if not config.checkpoint_dir:
            return None
        fp = config.fingerprint()
        name = config.checkpoint_name()
        for path in (os.path.join(shard_dir(config.checkpoint_dir, fp),
                                  name),
                     os.path.join(config.checkpoint_dir, name)):
            if not os.path.exists(path):
                continue
            try:
                with open(path) as f:
                    rec = json.load(f)
            except (OSError, ValueError):
                continue
            if not verify_record(rec):
                continue   # bit-rot: a corrupt snapshot never replays
            rec.pop("_crc32", None)
            if rec.get("fingerprint") == fp:
                return rec
        return None

    @classmethod
    def recover(cls, config: SchedulerConfig,
                mask_client=None) -> "AllocatorCore":
        """Fresh core, or one rebuilt by replaying snapshot + WAL tail.
        Placement is deterministic in op order, so the replayed
        occupancy grid, queue and in-flight set are byte-identical to
        the pre-crash state (tested). A torn WAL tail is truncated at
        the first corrupt record — everything acknowledged before the
        crash precedes it by the fsync ordering."""
        core = cls(config, mask_client=mask_client)
        rec = cls.load_state(config)
        base = list(rec["journal"]) if rec else []
        tail: List[Dict[str, Any]] = []
        truncated = False
        if config.checkpoint_dir:
            wal_recs, truncated = recover_journal(core._wal_path())
            for w in wal_recs:
                i = w.pop("i", None)
                expected = len(base) + len(tail)
                if i is not None and i < expected:
                    continue   # already subsumed by the snapshot
                if i is not None and i > expected:
                    break      # gap — never replay past missing ops
                tail.append(w)
        full = base + tail
        if full:
            core._replay({"journal": full,
                          "next_id": (rec or {}).get("next_id", 0)})
        elif rec:
            core.next_id = max(core.next_id, int(rec.get("next_id", 0)))
        core.counters["wal_tail_ops"] = len(tail)
        core.counters["wal_truncated"] = int(truncated)
        return core

    def _replay(self, rec: Dict[str, Any]) -> None:
        self._replaying = True
        try:
            for op in rec["journal"]:
                reply, _ = self.apply(dict(op))
                rid = op.get("rid")
                if rid is not None:
                    # Replay regenerates the identical reply bytes
                    # (determinism), repopulating the dedup cache: a
                    # client retrying across a daemon crash still gets
                    # exactly-once semantics.
                    self._remember(rid, reply)
        finally:
            self._replaying = False
            self._pending_topo = []
        self.journal = [dict(op) for op in rec["journal"]]
        self.next_id = max(self.next_id, int(rec.get("next_id", 0)))
        self.recovered_ops = len(self.journal)
        # Restore the fencing token: promote ops replayed above already
        # bumped it; the per-record stamp covers journals whose last
        # promotion predates the snapshot horizon (records written
        # before fencing existed carry no "e" — epoch 1 by definition).
        for op in self.journal:
            self.epoch = max(self.epoch, int(op.get("e", 1)))

    # -- op dispatch ---------------------------------------------------
    def apply(self, msg: Dict[str, Any]):
        """Dispatch one request dict -> (reply, events). Unknown ops
        and handler exceptions become error replies (the daemon must
        survive malformed clients).

        Idempotency: a request whose ``request_id`` already produced a
        journaled op returns the remembered reply without re-applying
        (and without re-broadcasting events — the originals were
        already pushed). Stateless outcomes (status, REJECTED, errors)
        are not cached: re-evaluating them is safe by construction."""
        op = msg.get("op")
        handler = getattr(self, f"op_{op}", None)
        if handler is None:
            return {"ok": False, "error": f"unknown op {op!r}"}, []
        rid = msg.get("request_id") or msg.get("rid")
        if rid is not None and self.config.dedup_cache:
            cached = self._dedup.get(rid)
            if cached is not None:
                self._dedup.move_to_end(rid)
                self.counters["dedup_hits"] += 1
                return dict(cached), []
        self._current_rid = rid
        self._current_client = msg.get("client")
        before = len(self.journal)
        try:
            reply, events = handler(msg)
        except Exception as e:  # noqa: BLE001 — protocol boundary
            self._pending_topo = []
            return {"ok": False, "error": f"{type(e).__name__}: {e}"}, []
        finally:
            self._current_rid = None
            self._current_client = None
        if rid is not None and len(self.journal) > before:
            self._remember(rid, reply)
        return reply, events

    def _remember(self, rid: str, reply: Dict[str, Any]) -> None:
        if not self.config.dedup_cache:
            return
        self._dedup[rid] = dict(reply)
        self._dedup.move_to_end(rid)
        while len(self._dedup) > self.config.dedup_cache:
            self._dedup.popitem(last=False)

    @staticmethod
    def _shape(msg: Dict[str, Any]) -> JobShape:
        dims = tuple(int(v) for v in msg["shape"])
        if len(dims) != 3 or any(d <= 0 for d in dims):
            raise ValueError(f"shape must be 3 positive extents, "
                             f"got {dims}")
        return JobShape(dims)

    # -- service ops ---------------------------------------------------
    def op_submit(self, msg: Dict[str, Any]):
        """Streaming arrival: place now, queue FIFO, drop (shape can
        never fit), or reject (queue full). Placement respects
        head-of-line blocking: with a non-empty queue and no backfill,
        a new arrival queues behind the blocked head even if it would
        fit — identical to the simulator's discipline."""
        shape = self._shape(msg)
        job_id = msg.get("job_id")
        if job_id is None:
            job_id = self.next_id
        job_id = int(job_id)
        if any(j == job_id for j, _ in self.queue) \
                or job_id in self.model.allocations:
            return {"ok": False,
                    "error": f"job {job_id} already known"}, []
        if (self.config.max_queue is not None
                and len(self.queue) >= self.config.max_queue):
            # Stateless outcome: not journaled, no id consumed.
            return {"ok": True, "outcome": protocol.REJECTED,
                    "job_id": job_id, "queue_depth": len(self.queue)}, []
        self.next_id = max(self.next_id, job_id + 1)
        self._journal_op({"op": "submit", "job_id": job_id,
                          "shape": list(shape.dims)})
        if not self.policy.can_ever_place(shape):
            return {"ok": True, "outcome": protocol.DROPPED,
                    "job_id": job_id}, []
        if self._current_client is not None:
            self.owners[job_id] = self._current_client
        placement = None
        if not self.queue or self.config.backfill:
            placement = self.policy.try_place(job_id, shape)
        if placement is None:
            self.queue.append((job_id, shape.dims))
            return {"ok": True, "outcome": protocol.QUEUED,
                    "job_id": job_id,
                    "queue_depth": len(self.queue)}, self._drain_topo()
        self.shapes[job_id] = shape.dims
        return ({"ok": True, "outcome": protocol.PLACED,
                 "job_id": job_id,
                 "placement": self._placement_fields(placement)},
                self._drain_topo())

    def op_done(self, msg: Dict[str, Any]):
        """A running job finished: release it, then drain the queue
        (FIFO; newly started jobs are announced via pushed SETUP —
        their owners subscribed for exactly this)."""
        job_id = int(msg["job_id"])
        queued = [j for j, _ in self.queue]
        if job_id in self.model.allocations:
            self._journal_op({"op": "done", "job_id": job_id})
            self.policy.release(job_id)
            self.shapes.pop(job_id, None)
            self.owners.pop(job_id, None)
            started = self._drain_fifo()
        elif job_id in queued:
            # Cancelled while queued.
            self._journal_op({"op": "done", "job_id": job_id})
            self.queue = [(j, s) for j, s in self.queue if j != job_id]
            self.owners.pop(job_id, None)
            started = []
        else:
            return {"ok": False, "error": f"job {job_id} not known"}, []
        return ({"ok": True, "job_id": job_id,
                 "started": started,
                 "queue_depth": len(self.queue)}, self._drain_topo())

    def _drain_fifo(self) -> List[Dict[str, Any]]:
        """The simulator's ``_drain_queue`` discipline: FIFO with
        head-of-line blocking; with backfill, later jobs may start
        past a blocked head. Drops queued jobs whose shape can never
        fit. Returns started/dropped notices (also pushed as events)."""
        started: List[Dict[str, Any]] = []
        i = 0
        while i < len(self.queue):
            job_id, dims = self.queue[i]
            shape = JobShape(dims)
            if not self.policy.can_ever_place(shape):
                self.queue.pop(i)
                started.append({"job_id": job_id,
                                "outcome": protocol.DROPPED})
                continue
            placement = self.policy.try_place(job_id, shape)
            if placement is None:
                if not self.config.backfill:
                    break
                i += 1
                continue
            self.queue.pop(i)
            self.shapes[job_id] = dims
            started.append({"job_id": job_id,
                            "outcome": protocol.PLACED,
                            "placement":
                                self._placement_fields(placement)})
        return started

    # -- raw policy ops (the simulator-as-client surface) -------------
    def op_try_place(self, msg: Dict[str, Any]):
        """Raw ``PlacementPolicy.try_place`` over the wire: no queue,
        no admission — the simulator client drives its own FIFO and
        needs exactly the in-process contract."""
        shape = self._shape(msg)
        job_id = int(msg["job_id"])
        placement = self.policy.try_place(job_id, shape)
        if placement is None:
            return {"ok": True, "outcome": "full"}, []
        self.next_id = max(self.next_id, job_id + 1)
        self._journal_op({"op": "try_place", "job_id": job_id,
                          "shape": list(shape.dims)})
        self.shapes[job_id] = shape.dims
        if self._current_client is not None:
            self.owners[job_id] = self._current_client
        return ({"ok": True, "outcome": protocol.PLACED,
                 "placement": self._placement_fields(placement)},
                self._drain_topo())

    def op_release(self, msg: Dict[str, Any]):
        job_id = int(msg["job_id"])
        if job_id not in self.model.allocations:
            return {"ok": False, "error": f"job {job_id} not allocated"}, []
        self._journal_op({"op": "release", "job_id": job_id})
        self.policy.release(job_id)
        self.shapes.pop(job_id, None)
        self.owners.pop(job_id, None)
        return {"ok": True, "job_id": job_id}, self._drain_topo()

    # -- chaos ops (preemption, migration, fault injection) ------------
    def op_preempt(self, msg: Dict[str, Any]):
        """Evict a running job back to the *head* of the queue (it was
        already admitted — FIFO order is by first admission). Work is
        assumed checkpointed; the service tracks placement, not
        progress. The freed hole is deliberately NOT drained: the
        preempted head itself would immediately re-place into it."""
        job_id = int(msg["job_id"])
        if job_id not in self.model.allocations:
            return {"ok": False, "error": f"job {job_id} not allocated"}, []
        self._journal_op({"op": "preempt", "job_id": job_id})
        dims = self.shapes.pop(job_id)
        self.policy.release(job_id)
        self.queue.insert(0, (job_id, dims))
        events = self._drain_topo()
        events.append({"event": protocol.EV_PREEMPT, "job_id": job_id,
                       "shape": list(dims)})
        return ({"ok": True, "job_id": job_id,
                 "outcome": protocol.PREEMPTED,
                 "queue_depth": len(self.queue)}, events)

    def op_migrate(self, msg: Dict[str, Any]):
        """Evict + replan through the allocator *now*: the job lands in
        a fresh placement (``migrated``) or, if the cluster cannot fit
        it at the moment (degraded fabric), falls back to the queue
        head (``preempted``). Deterministic in op order, so the journal
        records only the intent."""
        job_id = int(msg["job_id"])
        if job_id not in self.model.allocations:
            return {"ok": False, "error": f"job {job_id} not allocated"}, []
        self._journal_op({"op": "migrate", "job_id": job_id})
        dims = self.shapes[job_id]
        self.policy.release(job_id)
        placement = self.policy.try_place(job_id, JobShape(dims))
        if placement is None:
            self.shapes.pop(job_id, None)
            self.queue.insert(0, (job_id, dims))
            events = self._drain_topo()
            events.append({"event": protocol.EV_PREEMPT,
                           "job_id": job_id, "shape": list(dims)})
            return ({"ok": True, "job_id": job_id,
                     "outcome": protocol.PREEMPTED,
                     "queue_depth": len(self.queue)}, events)
        events = self._drain_topo()
        events.append({"event": protocol.EV_MIGRATE, "job_id": job_id,
                       "shape": list(dims)})
        return ({"ok": True, "job_id": job_id,
                 "outcome": protocol.MIGRATED,
                 "placement": self._placement_fields(placement)}, events)

    def _fault_injector(self) -> FaultInjector:
        if self._injector is None:
            self._injector = FaultInjector(self.policy)
        return self._injector

    @staticmethod
    def _fault_event(msg: Dict[str, Any], action: str) -> FaultEvent:
        return FaultEvent.from_wire({"time": 0.0, "action": action,
                                     "kind": msg["kind"],
                                     "targets": msg.get("targets", [])})

    def op_fault(self, msg: Dict[str, Any]):
        """Inject a fabric fault (``kind`` = node|link|ocs_port,
        ``targets`` as in :class:`repro_torch.sim.faults.FaultEvent`).
        Victims are evicted *before* the model transitions (the models
        refuse otherwise), then replanned in job-id order: re-placed
        now → ``migrated``; no capacity → ``preempted`` at the queue
        head. Journaled as intent — replay recomputes victims and
        replans deterministically."""
        ev = self._fault_event(msg, "fault")
        inj = self._fault_injector()
        victims = [j for j in inj.victims(ev)
                   if j in self.model.allocations]
        self._journal_op({"op": "fault", "kind": ev.kind,
                          "targets": list(ev.targets)})
        evicted: List[Tuple[int, Tuple[int, int, int]]] = []
        for jid in victims:
            dims = self.shapes.pop(jid)
            self.policy.release(jid)
            evicted.append((jid, dims))
        applied = inj.apply(ev)
        events = self._drain_topo()
        dispositions: List[Dict[str, Any]] = []
        requeue: List[Tuple[int, Tuple[int, int, int]]] = []
        for jid, dims in evicted:
            placement = self.policy.try_place(jid, JobShape(dims))
            if placement is not None:
                self.shapes[jid] = dims
                dispositions.append(
                    {"job_id": jid, "outcome": protocol.MIGRATED,
                     "placement": self._placement_fields(placement)})
                events.append({"event": protocol.EV_MIGRATE,
                               "job_id": jid, "shape": list(dims)})
            else:
                requeue.append((jid, dims))
                dispositions.append({"job_id": jid,
                                     "outcome": protocol.PREEMPTED})
                events.append({"event": protocol.EV_PREEMPT,
                               "job_id": jid, "shape": list(dims)})
        self.queue[0:0] = requeue
        events.extend(self._drain_topo())
        return ({"ok": True, "kind": ev.kind,
                 "applied": list(applied), "victims": dispositions,
                 "queue_depth": len(self.queue)}, events)

    def op_repair(self, msg: Dict[str, Any]):
        """Undo a fault (no-op for targets that never failed) and
        drain the queue — capacity came back."""
        ev = self._fault_event(msg, "repair")
        inj = self._fault_injector()
        self._journal_op({"op": "repair", "kind": ev.kind,
                          "targets": list(ev.targets)})
        applied = inj.apply(ev)
        started = self._drain_fifo()
        return ({"ok": True, "kind": ev.kind, "applied": list(applied),
                 "started": started,
                 "queue_depth": len(self.queue)}, self._drain_topo())

    # -- liveness ops ---------------------------------------------------
    def op_heartbeat(self, msg: Dict[str, Any]):
        """Lease renewal. State-free at the core: wall-clock lease
        bookkeeping lives in the daemon (which touches the lease for
        *every* request carrying a ``client`` id, heartbeats
        included); the core only reports the configured policy so a
        client can size its heartbeat interval."""
        return {"ok": True, "client": msg.get("client"),
                "lease_timeout": self.config.lease_timeout,
                "lease_policy": self.config.lease_policy}, []

    def op_lease_expire(self, msg: Dict[str, Any]):
        """A client's lease lapsed: disposition every job it owns.
        Journaled as intent *with the resolved action* — replay
        re-executes the same disposition even if the configured
        lease_policy has changed since.

        ``requeue`` (work-preserving, the Borg eviction analogue):
        running jobs are evicted back to the queue head in job-id
        order; queued jobs simply stay queued. Ownership is retained —
        a client reconnecting under the same id resumes its lease.
        ``release``: running *and* queued jobs are dropped outright
        and the freed capacity drains the queue."""
        cid = str(msg["client"])
        action = msg.get("action") or self.config.lease_policy
        owned_alloc = sorted(j for j, c in self.owners.items()
                             if c == cid and j in self.model.allocations)
        owned_queued = [j for j, _ in self.queue
                        if self.owners.get(j) == cid]
        # A no-op expiry (nothing owned; or requeue with only queued
        # jobs, which stay queued) is not journaled — deterministic
        # to re-derive, and keeping it out of the journal keeps
        # heartbeat-less idle clients free.
        if not owned_alloc and (action != "release" or not owned_queued):
            return {"ok": True, "client": cid, "action": action,
                    "jobs": [], "queue_depth": len(self.queue)}, []
        self._journal_op({"op": "lease_expire", "client": cid,
                          "action": action})
        self.counters["lease_expiries"] += 1
        dispositions: List[Dict[str, Any]] = []
        events: List[Dict[str, Any]] = []
        started: List[Dict[str, Any]] = []
        if action == "release":
            for jid in owned_alloc:
                self.policy.release(jid)
                self.shapes.pop(jid, None)
                self.owners.pop(jid, None)
                dispositions.append({"job_id": jid, "outcome": "released"})
                events.append({"event": protocol.EV_LEASE,
                               "job_id": jid, "client": cid,
                               "action": "release"})
            drop = set(owned_queued)
            if drop:
                self.queue = [(j, s) for j, s in self.queue
                              if j not in drop]
                for jid in owned_queued:
                    self.owners.pop(jid, None)
                    dispositions.append({"job_id": jid,
                                         "outcome": "released"})
            started = self._drain_fifo()
        else:
            requeue: List[Tuple[int, Tuple[int, int, int]]] = []
            for jid in owned_alloc:
                dims = self.shapes.pop(jid)
                self.policy.release(jid)
                requeue.append((jid, dims))
                dispositions.append({"job_id": jid,
                                     "outcome": protocol.PREEMPTED})
                events.append({"event": protocol.EV_LEASE,
                               "job_id": jid, "client": cid,
                               "action": "requeue"})
            self.queue[0:0] = requeue
        events = self._drain_topo() + events
        return ({"ok": True, "client": cid, "action": action,
                 "jobs": dispositions, "started": started,
                 "queue_depth": len(self.queue)}, events)

    def op_can_ever_place(self, msg: Dict[str, Any]):
        shape = self._shape(msg)
        return {"ok": True,
                "feasible": bool(self.policy.can_ever_place(shape))}, []

    # -- replication & fencing ------------------------------------------
    def op_promote(self, msg: Dict[str, Any]):
        """Mint a new fencing epoch and journal the promotion. The
        epoch is bumped *before* journaling, so the promotion record
        is the first op of the new epoch — every daemon or standby
        that replays or replicates it learns the new token.

        A live promote mints ``max(own epoch, request's fencing
        stamp) + 1`` — the stamp is the highest epoch the caller has
        witnessed anywhere, so the minted token supersedes leaders
        this daemon never heard of. Replay instead restores the
        journaled record's epoch verbatim."""
        if self._replaying:
            new_epoch = int(msg.get("epoch", self.epoch + 1))
        else:
            new_epoch = max(self.epoch, int(msg.get("epoch", 0))) + 1
        self.epoch = max(self.epoch, new_epoch)
        self._journal_op({"op": "promote", "epoch": self.epoch})
        self.counters["promotions"] += 1
        return {"ok": True, "epoch": self.epoch, "promoted": True}, []

    def journal_frames(self, index: int,
                       limit: int = 512) -> Tuple[bytes, int]:
        """Serve the replication stream: WAL-framed records from
        journal ``index`` (at most ``limit`` per pull), byte-identical
        to what the WAL holds for them. Returns ``(frames,
        next_index)`` — the follower's new cursor."""
        index = max(0, int(index))
        recs = [{"i": i, **op}
                for i, op in enumerate(self.journal[index:index + limit],
                                       start=index)]
        return encode_frames(recs), index + len(recs)

    def apply_replicated(self, rec: Dict[str, Any]) -> Dict[str, Any]:
        """Apply one record pulled from the leader (the standby path):
        run it through the normal handlers in replay mode —
        regenerating the identical reply for the dedup cache, pushing
        no events — then append it verbatim to this core's own journal
        *and WAL*, so a promoted standby recovers from its own disk
        exactly like a primary would. The caller guarantees contiguity
        (record index == len(journal))."""
        op = {k: v for k, v in rec.items() if k != "i"}
        self._replaying = True
        try:
            reply, _ = self.apply(dict(op))
            rid = op.get("rid")
            if rid is not None:
                self._remember(rid, reply)
        finally:
            self._replaying = False
            self._pending_topo = []
        self.epoch = max(self.epoch, int(op.get("e", 1)))
        self.journal.append(op)
        self.counters["repl_applied"] += 1
        if self.config.checkpoint_dir:
            self._wal_writer().append({"i": len(self.journal) - 1, **op})
            self._ops_since_sync += 1
            if (self.config.checkpoint_every
                    and self._ops_since_sync >= self.config.checkpoint_every):
                self.sync_checkpoint()
        return reply

    # -- introspection -------------------------------------------------
    def op_status(self, msg: Dict[str, Any]):
        return {"ok": True, **self.status()}, []

    def status(self) -> Dict[str, Any]:
        return {
            "policy": self.policy.name,
            "num_xpus": int(self.policy.num_xpus),
            "busy_xpus": int(self.policy.busy_xpus),
            "utilization": float(self.policy.utilization()),
            "allocated": len(self.model.allocations),
            "queue_depth": len(self.queue),
            "next_id": self.next_id,
            "journal_ops": len(self.journal),
            "epoch": self.epoch,
            "state_digest": self.state_digest(),
            "resilience": {**self.counters,
                           "dedup_entries": len(self._dedup),
                           "owned_jobs": len(self.owners),
                           "recovered_ops": self.recovered_ops},
        }

    def state_digest(self) -> str:
        """Content hash of the full allocator state (occupancy bytes,
        fault masks, allocation ids + shapes, queue, id counter) — the
        byte-identity oracle for the crash-recovery and parity tests."""
        h = hashlib.sha256()
        h.update(self.model.occ.tobytes())
        dedicated = getattr(self.model, "dedicated", None)
        if dedicated is not None:
            h.update(dedicated.tobytes())
        # Chaos state: failed nodes, dead OCS ports, cut links — a
        # faulted cluster must never digest-match a healthy one.
        h.update(self.model.failed.tobytes())
        ocs_ok = getattr(self.model, "ocs_ok", None)
        if ocs_ok is not None:
            h.update(ocs_ok.tobytes())
        cut = getattr(self.model, "cut_links", None)
        if cut is not None:
            h.update(json.dumps(sorted(cut)).encode())
        h.update(json.dumps(sorted(self.model.allocations)).encode())
        h.update(json.dumps(sorted(
            (j, list(d)) for j, d in self.shapes.items())).encode())
        h.update(json.dumps(self.queue).encode())
        h.update(str(self.next_id).encode())
        return h.hexdigest()[:16]

    def op_sync(self, msg: Dict[str, Any]):
        path = self.sync_checkpoint()
        return {"ok": True, "path": path,
                "journal_ops": len(self.journal)}, []

    @staticmethod
    def _placement_fields(placement) -> Dict[str, Any]:
        return {"job_id": placement.job_id,
                "shape": list(placement.shape.dims),
                "broken_rings": list(placement.broken_rings),
                "meta": placement.meta}
