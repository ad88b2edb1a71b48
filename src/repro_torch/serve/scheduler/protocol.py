"""Wire protocol of the allocator service (JSON lines over TCP).

One message per line, UTF-8 JSON. Two message classes share the
stream:

  * **Requests/replies** — a client tags each request with a
    monotonically increasing ``seq``; the daemon's reply echoes it.
    Replies always carry ``ok`` (bool) and, on failure, ``error``.
  * **Pushed events** — untagged messages carrying an ``event`` key
    (``SETUP``/``RECONFIG``/``RELEASE``), delivered to connections
    that issued ``subscribe``. This mirrors the Configurator →
    ``Job.send_setup``/``send_reconfig`` protocol of
    models-on-the-move (SNIPPETS.md §1), with JSON lines instead of
    ``SETUP-``-prefixed byte blobs.

Resilience fields — every request may additionally carry:

  ``request_id``      client-generated idempotency token (the stock
                      client sends ``"<client-id>:<seq>"``). The
                      daemon remembers the reply to every *journaled*
                      op per request_id (bounded LRU, persisted via
                      the journal), so a retry after a reconnect — or
                      even across a daemon crash + recovery — returns
                      the original reply instead of double-applying.
                      Stateless replies (status, REJECTED, errors) are
                      recomputed, which is safe by construction.
  ``client``          stable client identity. Carrying it makes this
                      client the *lease holder* of the jobs it
                      submits/places; with ``lease_timeout`` set, the
                      daemon expires clients that stop sending (any
                      request renews the lease) and requeues or
                      releases their jobs per ``lease_policy``.

Replication & fencing fields:

  ``epoch``           the monotonic **fencing token**. Every reply
                      carries the daemon's current epoch; clients
                      remember the highest epoch they have witnessed
                      and stamp it on every request. A daemon that
                      receives a request stamped with a *higher* epoch
                      than its own has provably been superseded (a new
                      leader was promoted while it was paused, dead,
                      or partitioned): it fences itself and refuses
                      every state-changing op with ``NOT_LEADER`` —
                      nothing reaches its journal, so a stale primary
                      can never double-place. Symmetrically a client
                      that sees a reply with a *lower* epoch than its
                      watermark discards it and fails over.
  ``NOT_LEADER``      error code on refused writes; the reply carries
                      ``leader`` = [host, port] when the daemon knows
                      where the current leader lives, so clients can
                      follow the redirect instead of scanning their
                      server list.

Replication ops:

  ``repl_pull``       fingerprint, index, acked, wait — a follower's
                      cursor into the leader's op log. The reply holds
                      ``frames`` (base64 of WAL-framed records from
                      ``index``; the WAL's on-disk framing *is* the
                      replication format), ``next`` (the follower's
                      new cursor) and the leader's ``epoch``.
                      ``acked`` piggybacks the follower's durable
                      index — in sync ack mode the leader holds client
                      acks until the standby has fsynced the op.
                      ``wait`` long-polls: the reply is deferred until
                      new records exist (or a timeout), so a warm
                      standby tails record-for-record without busy
                      polling. A fingerprint mismatch is refused: a
                      follower must never apply another config's log.
  ``promote``         mint a new fencing epoch (old + 1, journaled) and
                      become leader. On a standby this stops the
                      replication tail first; the promotion record is
                      the first op of the new epoch.
  ``fence``           epoch, leader — best-effort notice to an old
                      primary that a higher epoch exists; it fences
                      itself exactly as a stamped request would force.

Request ops (``{"op": ..., "seq": n, ...fields}``):

  ``submit``          shape=[a,b,c], optional job_id → outcome
                      ``placed``/``queued``/``dropped``/``rejected``
  ``done``            job_id — the job finished; frees its allocation
                      and drains the queue
  ``try_place``       job_id, shape — raw policy op (the simulator
                      client path; no queueing/admission semantics)
  ``release``         job_id — raw policy op
  ``can_ever_place``  shape → feasible on an empty cluster?
  ``preempt``         job_id — evict a running job back to the queue
                      head (checkpoint-resume assumed) → ``preempted``
  ``migrate``         job_id — evict + replan through the allocator
                      now → ``migrated`` (new placement) or
                      ``preempted`` (no capacity: queued at the head)
  ``fault``           kind=node|link|ocs_port, targets — inject a
                      fabric fault; victims are evicted first, then
                      replanned (each → ``migrated``/``preempted``)
  ``repair``          kind, targets — undo a fault (no-op for targets
                      that never failed) and drain the queue
  ``heartbeat``       lease renewal (any request renews too; this one
                      exists so an idle client can stay alive) →
                      echoes the daemon's lease_timeout/lease_policy
  ``lease_expire``    client, action=requeue|release — disposition a
                      dead client's jobs now (normally issued by the
                      daemon's own expiry loop, journaled with the
                      resolved action so replay is policy-independent)
  ``status``          → policy/occupancy/queue snapshot + state digest
                      + resilience counters (dedup/lease/WAL)
  ``events``? no      (events are pushed, never polled)
  ``subscribe``       register this connection for pushed events
                      (bounded per-subscriber queue: a subscriber that
                      stops reading is marked lagged and dropped,
                      never buffered unboundedly)
  ``sync``            force a checkpoint write now
  ``shutdown``        graceful stop (final checkpoint, then close)

Values are JSON-native: tuples become lists on the wire; the client
converts shape-like fields back (`broken_rings`, meta tuples) where
the in-process API promises tuples.
"""
from __future__ import annotations

import json
from typing import Any, Dict

import numpy as np

# Submit outcomes.
PLACED = "placed"        # allocation committed, SETUP pushed
QUEUED = "queued"        # feasible but no capacity now: FIFO-queued
DROPPED = "dropped"      # shape incompatible with the cluster (ever)
REJECTED = "rejected"    # admission control: queue full (overload)
# Eviction outcomes (preempt/migrate/fault victims).
PREEMPTED = "preempted"  # evicted, re-queued at the head
MIGRATED = "migrated"    # evicted and re-placed immediately

# Fencing: error code a superseded (or standby) daemon answers
# state-changing ops with; the reply may carry ``leader`` = [host,
# port] for the client to follow.
NOT_LEADER = "NOT_LEADER"

# Daemon roles.
ROLE_PRIMARY = "primary"
ROLE_STANDBY = "standby"

# Pushed event names (models-on-the-move spelling).
EV_SETUP = "SETUP"
EV_RECONFIG = "RECONFIG"
EV_RELEASE = "RELEASE"
# Chaos-layer events: fabric transitions and victim dispositions.
EV_FAULT = "FAULT"
EV_REPAIR = "REPAIR"
EV_PREEMPT = "PREEMPT"
EV_MIGRATE = "MIGRATE"
# Liveness: a dead client's lease lapsed; one event per owned job
# with its disposition (action=requeue|release).
EV_LEASE = "LEASE_EXPIRED"


def _jsonable(obj: Any):
    """numpy scalars leak out of occupancy math; flatten them. A torch
    value is refused like any other object: the core answers with host
    values only, whatever engine placed the job."""
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    raise TypeError(f"not JSON-serializable: {obj!r}")


def encode(msg: Dict[str, Any]) -> bytes:
    """One protocol line (terminated), ready for the socket."""
    return (json.dumps(msg, default=_jsonable) + "\n").encode()


def decode(line: bytes) -> Dict[str, Any]:
    return json.loads(line)


def detuple(obj):
    """JSON turned every tuple into a list; restore tuples for the
    shape-like values the in-process API returns as tuples (lists and
    nested lists become tuples recursively — placement meta contains
    only scalars, strings and shape tuples, so this is lossless)."""
    if isinstance(obj, list):
        return tuple(detuple(v) for v in obj)
    if isinstance(obj, dict):
        return {k: detuple(v) for k, v in obj.items()}
    return obj
