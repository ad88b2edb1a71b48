"""Fleet simulation layer: one engine, many simulators.

The eval harness runs matrices of independent seeded simulations
(runs x policies x seeds). Driven one at a time, each :class:`Simulator`
issues batch-1 fitmask queries, and the multi-box kernel's grid-batch
axis (the ``B`` of ``(B, K, X, Y, Z)``) never sees more than one
simulator's occupancy. On the card each such query costs a launch and
two copies for a few microseconds of kernel work.

This module runs many simulators *concurrently inside one process* as
cooperatively-scheduled steppers and funnels their per-epoch mask work
through a shared :class:`QueryBroker`:

  * Each simulator runs on its own thread. Simulation itself is plain
    python/numpy (GIL-serialized — process pools provide CPU
    parallelism one level up, see ``repro_torch.eval.runner``); the
    threads exist so a simulator can *block inside its placement hot
    path*, exactly at the point where it used to call the engine inline.
  * A blocked simulator's query parks in the broker. Flushes are
    **continuously scheduled**: a round is answered when a *quorum* of
    live steppers is parked, when *everyone* live is parked, or when
    the oldest parked query exceeds a *deadline* — the fleet never
    stalls on its slowest simulator. Queries arriving while a flush is
    in flight park into the next round, and up to ``max_inflight``
    flushes may overlap: a kernel call through ctypes and the copy back
    from the card release the GIL, as numpy's kernels do. Two lanes on
    the card launch onto the same current stream, so their kernels run
    one after the other: correct, only not overlapped.
  * Coalescing rules: requests are bucketed by grid cell shape (a
    16^3 static torus never stacks with 4^3 cubes), same-bucket grids
    are concatenated on the B axis, and candidate box sets are
    unioned on K — each request gets exactly its own planes back, in
    its own box order. On the ``cuda`` engine one flush is one launch
    of the fused bucketed kernel (bool planes and the free counts).
    The port's engines take B and K as launch arguments, so a flush
    stacks exactly its grids and exactly the union of its boxes (the
    reference pads both for engines that compile a program per shape).

Why schedules stay byte-identical to the single-sim path: every
``multibox``/``free_counts`` answer is a pure per-grid-per-box function
of the submitted occupancy — batching concatenates inputs and slices
outputs, it never mixes grids — so a simulator cannot observe whether
its query was answered solo, in a quorum round of three, or in a
timeout round of one.

The host boundary: the tensor engines answer with tensors on their
device. Every answer is copied to host numpy with
``repro_torch.core.maskquery.to_numpy`` (``.detach().cpu().numpy()``);
``np.asarray`` would raise on a CUDA tensor, and the retry/failover
failover path below, where it is enabled, would then answer every
query on the host engine.

The broker implements the ``repro_torch.core.maskquery`` client
contract, so installing it is one ``mask_client=`` argument per policy.

Containment: the broker tolerates a dead stepper always, and a dying
engine only where the caller asks for failover.

  * **Dead steppers** — a registered simulator thread that exits
    without deactivating would otherwise pin the live count forever.
    When ``register`` is given the thread handle (:class:`Fleet` always
    passes it), parked waiters poll on a bounded watchdog
    tick, reap threads that are no longer alive (``steppers_reaped``),
    shrink the live quorum, and deliver an exception to any request the
    dead thread left parked.
  * **Dying engines** — by default an engine call that raises hands
    its error to every waiter of the round: a run on the card never
    goes on in the plain version or on the host. With
    ``failover=True`` (the canary drill of
    ``benchmarks_torch/fleet_bench.py``, and tests) the call is retried
    once (``engine_retries``); if it raises again the broker fails over
    down the ``cuda → torch → numpy`` chain
    (:data:`repro_torch.core.engineconfig.FAILOVER_CHAIN`), on the same
    device, adopting the first backend that answers
    (``engine_failovers`` / ``failover_engine``). The first few
    post-failover multibox flushes are canary-checked against the host
    numpy oracle (``canary_checks``/``canary_mismatches``). Failover
    applies only to registry-named engines; a custom engine *instance*
    has no registry identity, so its errors always propagate.
    :meth:`QueryBroker.inject_engine_faults` arms synthetic failures
    for drills and tests. No ``EngineConfig`` field turns failover on,
    so the eval runner and its benchmark scripts never fail over.
"""
from __future__ import annotations

import hashlib
import math
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import (Any, Callable, Dict, List, Optional, Sequence,
                    Tuple)

import numpy as np

from repro_torch.core.maskquery import Box, MaskQueryClient, to_numpy

# Engine-aware flush deadlines (seconds): the host engine answers a
# round in a few hundred microseconds, device engines in a few
# milliseconds — the deadline only exists to bound the wait for a
# quorum that never forms, so it sits a little above one flush cost.
# (Set for the reference's CPU and TPU engines and kept as they are.)
_HOST_TIMEOUT = 0.002
_COMPILED_TIMEOUT = 0.005

_FC_CACHE_CAP = 4096       # content-addressed free-count entries

# Bounded wait tick (seconds) for parked waiters while stepper threads
# are being watched: the reap latency for a dead stepper, and the
# upper bound on how long one can stall a flush.
_WATCHDOG_TICK = 0.05

# Post-failover parity canary: how many multibox flushes on the
# adopted engine are cross-checked against the host numpy oracle.
_CANARY_FLUSHES = 3


@dataclass
class BrokerStats:
    """Coalescing + scheduling counters (the fleet bench asserts
    batching really happened — ``batched_calls > 0``,
    ``mean_grids_per_call > 1`` — and reports the flush-trigger
    breakdown)."""

    requests: int = 0          # queries submitted by simulators
    flushes: int = 0           # scheduled rounds answered
    engine_calls: int = 0      # engine invocations actually issued
    batched_calls: int = 0     # engine calls coalescing > 1 request
    grids: int = 0             # real grids stacked on the B axis
    max_grids: int = 0         # largest single-call B (real grids)
    max_coalesced: int = 0     # most requests answered by one call
    # -- continuous-scheduling breakdown --
    flush_all_parked: int = 0  # rounds triggered by everyone parked
    flush_quorum: int = 0      # rounds triggered by the quorum rule
    flush_timeout: int = 0     # rounds triggered by the deadline
    requeued: int = 0          # queries parked while a flush was live
    # -- free-count fast paths --
    fc_inline: int = 0         # answered inline on the host engine
    fc_cache_hits: int = 0     # answered from the content cache
    fc_cache_misses: int = 0   # parked for a batched round
    # -- where a fleet's time goes --
    park_s: float = 0.0        # seconds queries spent parked (sum)
    engine_s: float = 0.0      # seconds in engine calls, copies included
    # -- containment & failover --
    steppers_reaped: int = 0   # dead stepper threads reaped
    engine_retries: int = 0    # engine calls retried after an error
    engine_failovers: int = 0  # chain steps taken (engine adopted)
    canary_checks: int = 0     # post-failover flushes parity-checked
    canary_mismatches: int = 0  # canary disagreed with the host oracle
    failover_engine: Optional[str] = None  # engine currently adopted

    def record_call(self, n_requests: int, n_grids: int) -> None:
        self.engine_calls += 1
        self.grids += n_grids
        self.max_grids = max(self.max_grids, n_grids)
        self.max_coalesced = max(self.max_coalesced, n_requests)
        if n_requests > 1:
            self.batched_calls += 1

    def as_dict(self) -> Dict[str, Any]:
        d = dict(self.__dict__)
        d["mean_grids_per_call"] = (
            round(self.grids / self.engine_calls, 2)
            if self.engine_calls else None)
        return d


class _Request:
    __slots__ = ("kind", "occ", "boxes", "result", "error", "done", "t",
                 "owner")

    def __init__(self, kind: str, occ: np.ndarray,
                 boxes: Optional[Tuple[Box, ...]] = None):
        self.kind = kind
        self.occ = occ
        self.boxes = boxes
        self.result: Optional[np.ndarray] = None
        self.error: Optional[BaseException] = None
        self.done = threading.Event()
        self.t = time.monotonic()
        # The submitting thread: lets the watchdog error out requests
        # a dead stepper left parked.
        self.owner = threading.current_thread()


class QueryBroker(MaskQueryClient):
    """Coalesces mask queries from concurrently running simulators
    into batched engine calls, scheduled continuously.

    Implements the :class:`~repro_torch.core.maskquery.MaskQueryClient`
    contract, so a torus submits work to it exactly as it would to an
    inline client — the submitting thread just blocks until its round
    is answered. With no registered simulators (or only one live), a
    request flushes immediately: a broker is safe to use solo.

    ``engine`` is a registry name (``cuda``/``torch``/``numpy``/
    ``ref``), an :class:`~repro_torch.core.engineconfig.EngineConfig`,
    an engine instance, or ``None`` for the registry default (``cuda``).
    ``device`` (default: the config's) is where the tensor engines run,
    and where a failover adopts the next engine of the chain. The fleet
    path always rides an *engine*: there is no brokered variant of the
    in-torus host integral-image path (the numpy engine is the same
    arithmetic, batched).

    Flush policy — a parked round is answered when the first of these
    fires (the trigger breakdown lands in :class:`BrokerStats`):

      * **all parked**: every live stepper is waiting (the classic
        cooperative barrier; also fired by :meth:`deactivate`);
      * **quorum**: at least ``max(2, ceil(quorum * live))`` steppers
        are waiting. ``quorum=1.0`` (the default here) degenerates to
        the barrier; fleets run ``quorum < 1`` so a round never waits
        on its slowest member. ``quorum=0`` is *drain mode*: any
        parked query flushes the moment an inflight slot is free —
        batching arises from queries parking behind a live flush, not
        from timed waiting (the host-engine policy: one engine pass
        is so cheap that waiting on a timer always loses);
      * **timeout**: the oldest parked query is older than ``timeout``
        seconds (``None`` disables the deadline).

    Latecomers that park while a flush is in flight join the next
    round; up to ``max_inflight`` rounds may be answered concurrently
    (engine calls release the GIL).

    ``failover`` (default False) enables retry, failover down the chain
    and the canary; without it an engine error reaches the waiters.
    """

    def __init__(self, engine=None, quorum: Optional[float] = 1.0,
                 timeout: Optional[float] = None, max_inflight: int = 2,
                 device=None, failover: bool = False):
        from repro_torch.core.engineconfig import EngineConfig
        from repro_torch.kernels.fitmask import ops
        if hasattr(engine, "multibox"):
            # Custom instance: no registry identity — never failed over.
            self.engine = engine
            self.engine_name: Optional[str] = None
            self.device = getattr(engine, "device", device)
        else:
            cfg = EngineConfig.coerce(engine)
            self.device = cfg.device if device is None else device
            self.engine_name = cfg.resolve_name()
            self.engine = ops.get_engine(self.engine_name,
                                         device=self.device)
            # The resolved device (None means the card): failover adopts
            # the next engine there.
            self.device = getattr(self.engine, "device", self.device)
        self.failover = bool(failover)
        self.quorum = quorum
        self.timeout = timeout
        self.max_inflight = max(1, int(max_inflight))
        self._host_free = bool(getattr(self.engine, "host_free", False))
        # Mirror the engine's host-ness on the client contract so
        # toruses can pick lazy (host) vs prefetch-all-seen (device)
        # mask strategies without reaching through the broker.
        self.host_free = self._host_free
        self._lock = threading.Lock()
        self._active = 0
        self._pending: List[_Request] = []
        self._inflight = 0
        self._fc_cache: "OrderedDict[bytes, np.ndarray]" = OrderedDict()
        # Containment & failover state.
        self._watched: List[threading.Thread] = []  # stepper threads
        self._faults_left = 0        # armed synthetic engine failures
        self._canary_left = 0        # post-failover parity checks due
        self.stats = BrokerStats()

    # -- simulator lifecycle ------------------------------------------
    def register(self, thread: Optional[threading.Thread] = None) -> None:
        """Declare one more live simulator (call before it starts).
        With ``thread``, the watchdog tracks it: if it dies without
        deactivating, parked waiters reap it, shrink the quorum and
        error out any requests it left behind."""
        with self._lock:
            self._active += 1
            if thread is not None:
                self._watched.append(thread)

    def deactivate(self) -> None:
        """A simulator finished (or died): it submits no further
        queries. If the survivors' round is now ready (all parked, or
        quorum/deadline met), flush it — nobody else may trigger it."""
        cur = threading.current_thread()
        with self._lock:
            self._active -= 1
            # A clean exit from a watched thread unwatches it — the
            # watchdog must not double-decrement when it later dies.
            if cur in self._watched:
                self._watched.remove(cur)
            batch = self._take_round_locked(deadline_ok=True)
        if batch is not None:
            self._lead(batch)

    def _reap_locked(self) -> bool:
        """Reap watched threads that died without deactivating: shrink
        the live count (so quorum/all-parked reflect survivors only)
        and deliver an exception to any request they left parked.
        Returns True when anything was reaped."""
        dead = [t for t in self._watched
                if t.ident is not None and not t.is_alive()]
        for t in dead:
            self._watched.remove(t)
            self._active -= 1
            self.stats.steppers_reaped += 1
            for r in [r for r in self._pending if r.owner is t]:
                self._pending.remove(r)
                r.error = RuntimeError(
                    f"stepper thread {t.name!r} died with this query "
                    "parked")
                r.done.set()
        return bool(dead)

    # -- MaskQueryClient contract -------------------------------------
    def multibox(self, occ, boxes: Sequence[Box]) -> np.ndarray:
        boxes = tuple(tuple(int(v) for v in b) for b in boxes)
        return self._submit(_Request("multibox", to_numpy(occ), boxes))

    def free_counts(self, occ) -> np.ndarray:
        occ = to_numpy(occ)
        if occ.ndim != 4:
            raise ValueError("broker expects (B, X, Y, Z) occupancy, "
                             f"got shape {occ.shape}")
        if self._host_free:
            # Host reduction: cheaper than a park/flush round-trip.
            t0 = time.monotonic()
            out = to_numpy(self.engine.free_counts(occ))
            with self._lock:
                self.stats.requests += 1
                self.stats.fc_inline += 1
                self.stats.record_call(1, occ.shape[0])
                self.stats.engine_s += time.monotonic() - t0
            return out.astype(np.int64)
        key = self._fc_key(occ)
        with self._lock:
            hit = self._fc_cache.get(key)
            if hit is not None:
                self._fc_cache.move_to_end(key)
                self.stats.requests += 1
                self.stats.fc_cache_hits += 1
                return hit.copy()
            self.stats.fc_cache_misses += 1
        return self._submit(_Request("free_counts", occ))

    @staticmethod
    def _fc_key(occ: np.ndarray) -> bytes:
        h = hashlib.blake2b(digest_size=16)
        h.update(repr(occ.shape).encode())
        h.update(np.ascontiguousarray(occ))
        return h.digest()

    def _submit(self, req: _Request) -> np.ndarray:
        if req.occ.ndim != 4:
            raise ValueError("broker expects (B, X, Y, Z) occupancy, "
                             f"got shape {req.occ.shape}")
        with self._lock:
            self._pending.append(req)
            self.stats.requests += 1
            if self._inflight:
                self.stats.requeued += 1
            batch = self._take_round_locked(deadline_ok=False)
        if batch is not None:
            self._lead(batch)
        # Park until answered; on each deadline tick, check whether a
        # waiting round (possibly ours, possibly a successor round) is
        # now flushable and lead it if so. With watched stepper threads
        # the tick is bounded by the watchdog period, so a killed
        # stepper delays a flush by at most _WATCHDOG_TICK — it can
        # never hang the broker.
        while not req.done.wait(self._wait_tick()):
            with self._lock:
                self._reap_locked()
                batch = self._take_round_locked(deadline_ok=True)
            if batch is not None:
                self._lead(batch)
        with self._lock:
            self.stats.park_s += time.monotonic() - req.t
        if req.error is not None:
            raise req.error
        assert req.result is not None
        return req.result

    def _wait_tick(self) -> Optional[float]:
        """Parked-waiter wakeup period: the flush deadline, bounded by
        the watchdog tick while stepper threads are being watched
        (``None`` — wait forever — only when neither applies)."""
        if self._watched:
            return (_WATCHDOG_TICK if self.timeout is None
                    else min(self.timeout, _WATCHDOG_TICK))
        return self.timeout

    # -- continuous scheduling ----------------------------------------
    def _take_round_locked(self,
                           deadline_ok: bool) -> Optional[List[_Request]]:
        """Decide (under the lock) whether a round flushes now; if so,
        claim the batch and an inflight slot and return it. The caller
        answers it outside the lock."""
        n = len(self._pending)
        if not n or self._inflight >= self.max_inflight:
            return None
        active = self._active
        if active <= 0 or n >= active:
            self.stats.flush_all_parked += 1
        elif (self.quorum is not None and self.quorum < 1.0
              and n >= max(1 if self.quorum <= 0.0 else 2,
                           math.ceil(self.quorum * active))):
            # quorum=0 is *drain mode*: any parked query flushes the
            # moment an inflight slot is free — batching arises from
            # queries that park while a flush is live, not from timed
            # waiting (the right trade when one engine pass is cheap).
            self.stats.flush_quorum += 1
        elif (deadline_ok and self.timeout is not None
              and time.monotonic() - self._pending[0].t >= self.timeout):
            self.stats.flush_timeout += 1
        else:
            return None
        batch, self._pending = self._pending, []
        self._inflight += 1
        self.stats.flushes += 1
        return batch

    def _lead(self, batch: List[_Request]) -> None:
        """Answer rounds until none is ready: the leader that finishes
        a flush immediately chains into any round that became flushable
        while it was computing (its own waiters were woken the moment
        their results landed)."""
        while batch is not None:
            try:
                self._answer(batch)
            except BaseException as e:  # noqa: BLE001 — must wake waiters
                for r in batch:
                    if r.result is None and r.error is None:
                        r.error = e
            for r in batch:
                r.done.set()
            with self._lock:
                self._inflight -= 1
                batch = self._take_round_locked(deadline_ok=True)

    # -- coalescing ----------------------------------------------------
    def _answer(self, batch: List[_Request]) -> None:
        for kind in ("multibox", "free_counts"):
            reqs = [r for r in batch if r.kind == kind]
            # Bucket by grid cell shape: only same-shape grids can
            # share an engine pass.
            by_cell: Dict[Tuple[int, ...], List[_Request]] = {}
            for r in reqs:
                by_cell.setdefault(r.occ.shape[1:], []).append(r)
            for group in by_cell.values():
                if kind == "multibox":
                    self._answer_multibox(group)
                else:
                    self._answer_free_counts(group)

    @staticmethod
    def _stack(group: List[_Request]) -> Tuple[np.ndarray, int]:
        """Concatenate a bucket's grids on B; returns (stacked, B)."""
        occs = [r.occ for r in group]
        b = sum(o.shape[0] for o in occs)
        if len(occs) == 1:
            return occs[0], b
        return np.concatenate(occs, axis=0), b

    # -- engine dispatch: retry, failover, canary ---------------------
    def inject_engine_faults(self, n: int) -> None:
        """Arm ``n`` synthetic engine failures (chaos drills / tests):
        the next ``n`` raw engine invocations raise. Without failover
        the first one reaches the waiters; with it, two faults walk the
        full retry-then-failover path and more walk further down the
        chain."""
        with self._lock:
            self._faults_left = int(n)

    def _dispatch_engine(self, kind: str, occ: np.ndarray,
                         boxes: Optional[Tuple[Box, ...]] = None):
        """One raw invocation on the *current* engine — resolved per
        call, because failover swaps the engine underneath inflight
        flushes. Armed synthetic faults fire here, upstream of the
        real engine, so they exercise the identical recovery path."""
        with self._lock:
            if self._faults_left > 0:
                self._faults_left -= 1
                raise RuntimeError("injected engine fault")
        if kind == "multibox":
            fn = getattr(self.engine, "multibox_bucketed", None)
            if fn is not None:
                planes, free = fn(occ, boxes)
                return to_numpy(planes), to_numpy(free).astype(np.int64)
            return to_numpy(self.engine.multibox(occ, boxes)), None
        return to_numpy(self.engine.free_counts(occ)).astype(np.int64)

    def _failover_names(self) -> Tuple[str, ...]:
        if self.engine_name is None:
            return ()  # custom instance: errors propagate unchanged
        from repro_torch.core.engineconfig import failover_candidates
        return failover_candidates(self.engine_name)

    def _adopt_engine(self, name: str) -> bool:
        """Switch to ``name`` after the current engine failed its
        retry, on the broker's device. Returns False when the backend
        cannot even be constructed — the chain just moves on."""
        from repro_torch.kernels.fitmask import ops
        try:
            eng = ops.get_engine(name, device=self.device)
        except Exception:  # noqa: BLE001 — any backend boot failure
            return False
        with self._lock:
            self.engine = eng
            self.engine_name = name
            self._host_free = bool(getattr(eng, "host_free", False))
            self.host_free = self._host_free
            self._canary_left = _CANARY_FLUSHES
            self.stats.engine_failovers += 1
            self.stats.failover_engine = name
        return True

    def _engine_call(self, kind: str, occ: np.ndarray,
                     boxes: Optional[Tuple[Box, ...]] = None):
        """Engine invocation. Without ``failover`` an error propagates
        at once. With it: retry once on the same engine, then fail over
        down the chain; the last error is raised only when the numpy
        floor itself failed (or the engine has no registry identity)."""
        if not self.failover:
            return self._dispatch_engine(kind, occ, boxes)
        last: Optional[BaseException] = None
        for attempt in range(2):
            try:
                return self._dispatch_engine(kind, occ, boxes)
            except Exception as e:  # noqa: BLE001 — contained below
                last = e
                if attempt == 0:
                    with self._lock:
                        self.stats.engine_retries += 1
        for name in self._failover_names():
            if not self._adopt_engine(name):
                continue
            try:
                return self._dispatch_engine(kind, occ, boxes)
            except Exception as e:  # noqa: BLE001 — keep walking
                last = e
        assert last is not None
        raise last

    def _maybe_canary(self, occ: np.ndarray, boxes: Tuple[Box, ...],
                      planes: np.ndarray) -> None:
        """Parity-check the first few post-failover flushes against
        the host numpy oracle. Engines agree on the fit *mask* (the
        nonzero pattern), so that is what is compared; any mismatch is
        a real defect — answers are pure functions of the inputs."""
        take = False
        with self._lock:
            if self._canary_left > 0 and self.engine_name != "numpy":
                self._canary_left -= 1
                take = True
        if not take:
            return
        from repro_torch.kernels.fitmask import ops
        ref = ops.get_engine("numpy").multibox(occ, boxes)
        ok = np.array_equal(planes != 0, ref != 0)
        with self._lock:
            self.stats.canary_checks += 1
            if not ok:
                self.stats.canary_mismatches += 1

    def _answer_multibox(self, group: List[_Request]) -> None:
        boxes = tuple(sorted({b for r in group for b in r.boxes}))
        kidx = {b: k for k, b in enumerate(boxes)}
        occ, real_b = self._stack(group)
        t0 = time.monotonic()
        planes, free = self._engine_call("multibox", occ, boxes)
        spent = time.monotonic() - t0
        self._maybe_canary(occ, boxes, planes)
        with self._lock:
            self.stats.record_call(len(group), real_b)
            self.stats.engine_s += spent
        lo = 0
        fc_entries = []
        for r in group:
            hi = lo + r.occ.shape[0]
            sub = planes[lo:hi]
            perm = [kidx[b] for b in r.boxes]
            if perm != list(range(sub.shape[1])):
                sub = sub[:, perm]
            r.result = sub
            if free is not None and not self._host_free:
                fc_entries.append((self._fc_key(r.occ),
                                   free[lo:hi].astype(np.int64)))
            lo = hi
        if fc_entries:
            # The fused program computed free counts anyway; remember
            # them so a follow-up free_counts on the same occupancy is
            # answered without parking.
            with self._lock:
                for key, val in fc_entries:
                    self._fc_cache[key] = val
                    self._fc_cache.move_to_end(key)
                while len(self._fc_cache) > _FC_CACHE_CAP:
                    self._fc_cache.popitem(last=False)

    def _answer_free_counts(self, group: List[_Request]) -> None:
        occ, real_b = self._stack(group)
        t0 = time.monotonic()
        out = self._engine_call("free_counts", occ)
        with self._lock:
            self.stats.record_call(len(group), real_b)
            self.stats.engine_s += time.monotonic() - t0
        lo = 0
        for r in group:
            hi = lo + r.occ.shape[0]
            r.result = out[lo:hi]
            lo = hi


class Fleet:
    """Run a set of simulation units concurrently, sharing one broker.

    Each *unit* is a callable receiving the broker (pass it to the
    policy as ``mask_client=``, then run the simulation) and returning an arbitrary result. Units run on daemon threads and
    are registered with the broker *before* any of them starts, so the
    first scheduled round already coalesces across the whole fleet.

    ``engine`` is a registry name, an engine instance, ``None`` (the
    registry default, ``cuda``) or an
    :class:`~repro_torch.core.engineconfig.EngineConfig`, whose device
    and flush fields are taken (explicit kwargs win over its fields).
    ``device`` is where the tensor engines run (default: the config's,
    else the card).

    ``quorum``/``timeout``/``max_inflight`` default to ``"auto"`` /
    ``None``, which resolve engine-aware. The host engine gets drain
    mode (``quorum=0``, one inflight lane): one engine pass is nearly
    free, so any parked query flushes as soon as the engine is idle and
    batching arises from queries parking behind the live flush. Device
    engines (``host_free`` False: ``cuda``, ``torch``) keep the full
    barrier quorum with two inflight lanes — a bigger B per launch is
    what amortizes their launch and copies — plus a ~5 ms deadline: it
    is the deadline, not the quorum, that makes such fleets
    *continuously* scheduled. Pass ``quorum=1.0, timeout=None`` for the
    strict all-parked barrier. ``failover`` goes to the broker (default
    False: an engine error ends the run).

    ``run`` returns per-unit results in input order; the first unit
    exception (if any) is re-raised after every thread has stopped —
    a dying simulator deactivates itself, so survivors keep batching
    among themselves rather than deadlocking.
    """

    def __init__(self, engine=None, quorum="auto", timeout="auto",
                 max_inflight: Optional[int] = None, device=None,
                 failover: bool = False):
        from repro_torch.core.engineconfig import EngineConfig
        from repro_torch.kernels.fitmask import ops
        if isinstance(engine, EngineConfig):
            # One typed value carries backend, device and flush policy;
            # explicit kwargs (non-"auto") still win over its fields.
            if quorum == "auto":
                quorum = engine.quorum
            if timeout == "auto":
                timeout = engine.timeout
            if max_inflight is None:
                max_inflight = engine.max_inflight
            if device is None:
                device = engine.device
            engine = engine.resolve_name()
        if hasattr(engine, "multibox"):
            eng = engine
        else:
            eng = ops.get_engine(EngineConfig.coerce(engine).resolve_name(),
                                 device=device)
        host = bool(getattr(eng, "host_free", False))
        if quorum == "auto":
            quorum = 0.0 if host else 1.0
        if timeout == "auto":
            timeout = _HOST_TIMEOUT if host else _COMPILED_TIMEOUT
        if max_inflight is None:
            # Host drain mode wants exactly one engine lane: queries
            # park behind the live flush and drain as one batch.
            # Device engines overlap two (their calls release the GIL).
            max_inflight = 1 if host else 2
        # Pass the *spec* (name/None/instance), not the resolved
        # instance: a registry name gives the broker the identity the
        # failover chain keys on; an instance stays failover-exempt.
        self.broker = QueryBroker(engine, quorum=quorum, timeout=timeout,
                                  max_inflight=max_inflight, device=device,
                                  failover=failover)

    def run(self, units: Sequence[Callable[[QueryBroker], Any]]) -> List[Any]:
        results: List[Any] = [None] * len(units)
        errors: List[Optional[BaseException]] = [None] * len(units)
        broker = self.broker

        def work(i: int, unit: Callable[[QueryBroker], Any]) -> None:
            try:
                results[i] = unit(broker)
            except BaseException as e:  # noqa: BLE001 — reported below
                errors[i] = e
            finally:
                broker.deactivate()

        threads = [threading.Thread(target=work, args=(i, u), daemon=True)
                   for i, u in enumerate(units)]
        # Register with the thread handles *before* any unit starts:
        # the first round coalesces across the whole fleet, and the
        # watchdog can reap a unit that dies without deactivating.
        for t in threads:
            broker.register(thread=t)
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for e in errors:
            if e is not None:
                raise e
        return results
