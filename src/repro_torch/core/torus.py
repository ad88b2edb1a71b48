"""Static 3D torus occupancy model with link-exclusivity accounting.

The paper's central correctness property is that an allocation gives a
job *exclusive* XPUs and links (that is what "enforcing the job shape"
buys). We therefore track both node occupancy (a numpy grid — the hot
free-box search is delegated to the fitmask kernel wrapper) and link
ownership (a registry keyed by canonical link ids), and assert
exclusivity on every commit.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, FrozenSet, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from .. import obs
from . import events as _events
from . import maskquery
from .engineconfig import EngineConfig
from .geometry import Coord, Dims, is_torus_neighbor, iter_box, volume

Link = Tuple[Coord, Coord]

# ``owner`` sentinel for a failed XPU: the cell is marked busy in the
# occupancy grid (so every fitmask engine naturally routes around it)
# but belongs to no job.
FAILED = -2


class FaultConflictError(RuntimeError):
    """A fault was injected into a resource still owned by a job.

    The orchestrator (``repro_torch.sim.faults`` / a scheduler service)
    must evict victims *before* applying the fault to the model — this
    error is the defense-in-depth backstop that turns "silent
    corruption" into a loud failure."""


def canon_link(u: Coord, v: Coord) -> Link:
    return (u, v) if u <= v else (v, u)


def _cell_index(coords: Sequence[Coord]) -> Tuple[np.ndarray, ...]:
    """``coords`` as one fancy index into a grid: an index array per axis."""
    return tuple(np.asarray(coords, dtype=np.intp).reshape(-1, 3).T)


@dataclass
class Allocation:
    """A committed placement.

    ``coords``  — the XPUs owned by the job (order is meaningful for
                  folded ring placements: it is the ring traversal).
    ``links``   — torus links owned by the job.
    ``meta``    — provenance: fold used, target box, cubes touched, etc.
    """

    job_id: int
    coords: Tuple[Coord, ...]
    links: FrozenSet[Link]
    meta: dict = field(default_factory=dict)

    @property
    def size(self) -> int:
        return len(self.coords)


class StaticTorus:
    """A D1×D2×D3 torus with full wrap-around on every axis whose size
    equals the torus dimension. Occupancy is a numpy bool grid.

    ``engine`` selects the free-box search backend — an
    :class:`~repro_torch.core.engineconfig.EngineConfig`, a registry name, or
    None for the resolved default (``fitmask_engine`` is the retained
    legacy spelling). ``mask_client`` injects a request/response client
    (e.g. a batching broker) at construction. Either way the torus asks
    one client (:func:`~repro_torch.core.maskquery.torus_client`) for
    the full-grid fit masks of an allocator step's missing candidate
    boxes in one multi-box pass, and caches them per occupancy epoch."""

    @obs.span("torus.init")
    def __init__(self, dims: Dims, fitmask_engine: Optional[str] = None,
                 engine=None, mask_client=None, listeners=None):
        self.dims: Dims = tuple(int(d) for d in dims)  # type: ignore[assignment]
        self.engine_config = EngineConfig.coerce(
            engine if engine is not None else fitmask_engine)
        # Back-compat attribute: the raw engine selection (None = the
        # resolved registry default), as call sites historically read.
        self.fitmask_engine = self.engine_config.engine
        # Request/response client (repro_torch.core.maskquery), injected at
        # construction. None: resolve per query from the engine config.
        self.mask_client: Optional[maskquery.MaskQueryClient] = mask_client
        # Topology-event listeners (repro_torch.core.events): notified on
        # every commit/release so a scheduler service can push
        # SETUP/RELEASE messages. Empty list = zero-cost.
        self.listeners: List[_events.Listener] = list(listeners or [])
        self.occ = np.zeros(self.dims, dtype=bool)
        self.owner = np.full(self.dims, -1, dtype=np.int64)
        self.link_owner: Dict[Link, int] = {}
        self.allocations: Dict[int, Allocation] = {}
        # Fault state (chaos layer): failed XPUs are marked busy in
        # ``occ`` with ``owner == FAILED`` so the whole fitmask stack
        # avoids them without a second mask; cut links cannot be
        # claimed (the allocator routes the ring around them as an
        # extra broken axis).
        self.failed = np.zeros(self.dims, dtype=bool)
        self.num_failed = 0
        self.cut_links: set = set()
        # Occupancy epoch: bumped on every commit/release. Derived state
        # (per-box fit masks and answers, busy count) is cached per
        # epoch, so one allocator step asks for its boxes' masks once.
        # Direct writes to ``occ`` must be followed by ``bump_epoch()``.
        self._epoch = 0
        self._busy = 0
        self._fit_epoch = -1
        self._fit_origin: Dict[Dims, Optional[Coord]] = {}
        self._fit_count: Dict[Dims, int] = {}
        self._box_masks: Dict[Dims, np.ndarray] = {}

    # ------------------------------------------------------------------
    def bump_epoch(self) -> None:
        """Invalidate cached occupancy-derived state (call after any
        direct mutation of ``occ``)."""
        self._epoch += 1
        self._busy = int(self.occ.sum())

    def _fit_state(self) -> None:
        """Roll the per-epoch caches."""
        if self._fit_epoch != self._epoch:
            self._fit_origin = {}
            self._fit_count = {}
            self._box_masks = {}
            self._fit_epoch = self._epoch

    def _fill_masks(self, boxes: List[Dims]) -> None:
        """Ask the client for the fit masks of ``boxes`` (sorted, none
        cached at this epoch) in one multi-box pass, and cache each
        plane as a bool mask."""
        client = maskquery.torus_client(self.mask_client, self.engine_config)
        out = client.multibox(self.occ[None], boxes)[0]
        for k, b in enumerate(boxes):
            self._box_masks[b] = out[k] != 0

    def _fit_mask_for(self, box: Dims) -> np.ndarray:
        """Full-grid bool fit mask for one box at the current epoch:
        the cached plane, which the step's prefetch has usually
        filled, else the client's answer for this box alone."""
        self._fit_state()
        if box not in self._box_masks:
            self._fill_masks([box])
        return self._box_masks[box]

    @obs.span("torus.prefetch")
    def prefetch_boxes(self, boxes) -> None:
        """Declare an allocator step's candidate boxes up front so the
        client answers them all in one multi-box pass. Only the step's
        missing boxes are asked for: boxes of other job shapes would
        only pad the K axis with work nobody reads this epoch."""
        self._fit_state()
        missing = sorted({tuple(int(v) for v in b) for b in boxes}
                         - self._box_masks.keys())
        if missing:
            self._fill_masks(missing)

    # ------------------------------------------------------------------
    @property
    def num_xpus(self) -> int:
        return volume(self.dims)

    @property
    def busy_xpus(self) -> int:
        """XPUs owned by jobs (failed cells occupy the grid but are
        not *busy* — utilization dips, it does not lie)."""
        return self._busy - self.num_failed

    @property
    def free_xpus(self) -> int:
        """XPUs actually placeable right now (excludes failed cells)."""
        return self.num_xpus - self._busy

    def utilization(self) -> float:
        return self.busy_xpus / self.num_xpus

    def wrap_flags(self) -> Tuple[bool, bool, bool]:
        """A static torus has wrap-around links on every axis."""
        return (True, True, True)

    # ------------------------------------------------------------------
    def is_free(self, coords: Iterable[Coord]) -> bool:
        return not any(self.occ[c] for c in coords)

    def box_free(self, origin: Coord, box: Dims) -> bool:
        """Box fit without wrapping past the boundary."""
        if any(o + b > d for o, b, d in zip(origin, box, self.dims)):
            return False
        ox, oy, oz = origin
        a, b, c = box
        return not self.occ[ox:ox + a, oy:oy + b, oz:oz + c].any()

    def find_free_box(self, box: Dims) -> Optional[Coord]:
        """First (lexicographic) origin where an un-wrapped a×b×c box of
        free XPUs exists, or None. Read off the box's fit mask at this
        occupancy epoch; repeated boxes are memoized."""
        box = tuple(int(b) for b in box)
        self._fit_state()
        if box not in self._fit_origin:
            with obs.span("torus.find_box"):
                m = self._fit_mask_for(box)
                if not m.any():
                    self._fit_origin[box] = None
                else:
                    flat = int(np.argmax(m))  # first True in C order
                    self._fit_origin[box] = tuple(
                        int(v) for v in np.unravel_index(flat, m.shape))
        return self._fit_origin[box]

    def count_free_boxes(self, box: Dims) -> int:
        box = tuple(int(b) for b in box)
        self._fit_state()
        if box not in self._fit_count:
            self._fit_count[box] = int(self._fit_mask_for(box).sum())
        return self._fit_count[box]

    # ------------------------------------------------------------------
    def _links_for_box(self, origin: Coord, box: Dims) -> FrozenSet[Link]:
        """All internal links of a contiguous box, plus wrap-around links
        on axes where the box spans the full torus dimension."""
        links: set[Link] = set()
        ox, oy, oz = origin
        a, b, c = box
        for (x, y, z) in iter_box(origin, box):
            if x + 1 < ox + a:
                links.add(canon_link((x, y, z), (x + 1, y, z)))
            elif a == self.dims[0]:
                links.add(canon_link((ox, y, z), (x, y, z)))
            if y + 1 < oy + b:
                links.add(canon_link((x, y, z), (x, y + 1, z)))
            elif b == self.dims[1]:
                links.add(canon_link((x, oy, z), (x, y, z)))
            if z + 1 < oz + c:
                links.add(canon_link((x, y, z), (x, y, z + 1)))
            elif c == self.dims[2]:
                links.add(canon_link((x, y, oz), (x, y, z)))
        return frozenset(links)

    def links_for_ring(self, ring: Sequence[Coord]) -> FrozenSet[Link]:
        """Links used by an ordered ring of torus-neighbouring XPUs."""
        n = len(ring)
        links: set[Link] = set()
        wrap = self.wrap_flags()
        pairs = [(ring[i], ring[(i + 1) % n]) for i in range(n)] \
            if n > 2 else [(ring[0], ring[1])]
        for u, v in pairs:
            if not is_torus_neighbor(u, v, self.dims, wrap):
                raise ValueError(f"ring hop {u}->{v} is not a torus link")
            links.add(canon_link(u, v))
        return links

    # ------------------------------------------------------------------
    def commit(self, job_id: int, coords: Sequence[Coord],
               links: Iterable[Link], meta: Optional[dict] = None) -> Allocation:
        coords = tuple(coords)
        links = frozenset(links)
        if len(set(coords)) != len(coords):
            raise ValueError("duplicate XPUs in allocation")
        cells = _cell_index(coords)
        taken = self.occ[cells]
        if taken.any():
            c = coords[int(np.argmax(taken))]  # the first, in coords order
            raise ValueError(f"XPU {c} already owned by {self.owner[c]}")
        for l in links:
            if l in self.link_owner:
                raise ValueError(
                    f"link {l} already owned by job {self.link_owner[l]}")
            if l in self.cut_links:
                raise ValueError(f"link {l} is cut (fault injected)")
        self.occ[cells] = True
        self.owner[cells] = job_id
        for l in links:
            self.link_owner[l] = job_id
        self._epoch += 1
        self._busy += len(coords)
        alloc = Allocation(job_id, coords, links, dict(meta or {}))
        self.allocations[job_id] = alloc
        if self.listeners:
            _events.emit(self.listeners, _events.TopologyEvent(
                kind="setup", job_id=job_id, topology="static",
                detail={"num_xpus": len(coords),
                        "num_links": len(links), **alloc.meta}))
        return alloc

    def commit_box(self, job_id: int, origin: Coord, box: Dims,
                   meta: Optional[dict] = None) -> Allocation:
        coords = tuple(iter_box(origin, box))
        links = self._links_for_box(origin, box)
        m = {"kind": "box", "origin": origin, "box": box}
        m.update(meta or {})
        return self.commit(job_id, coords, links, m)

    def release(self, job_id: int) -> None:
        alloc = self.allocations.pop(job_id)
        cells = _cell_index(alloc.coords)
        self.occ[cells] = False
        self.owner[cells] = -1
        for l in alloc.links:
            del self.link_owner[l]
        self._epoch += 1
        self._busy -= len(alloc.coords)
        if self.listeners:
            _events.emit(self.listeners, _events.TopologyEvent(
                kind="release", job_id=job_id, topology="static",
                detail={"num_xpus": len(alloc.coords),
                        "num_links": len(alloc.links)}))

    # -- fault injection (chaos layer) ---------------------------------
    def jobs_on(self, coords: Iterable[Coord]) -> List[int]:
        """Job ids allocated on any of ``coords`` (fault victims),
        sorted for determinism."""
        return sorted({int(self.owner[tuple(c)]) for c in coords
                       if self.owner[tuple(c)] >= 0})

    def link_jobs(self, links: Iterable[Link]) -> List[int]:
        """Job ids owning any of ``links`` (link-cut victims)."""
        return sorted({self.link_owner[l] for l in links
                       if l in self.link_owner})

    def fail_nodes(self, coords: Iterable[Coord]) -> List[Coord]:
        """Mark XPUs failed. Returns the coords actually transitioned
        (already-failed cells are skipped — idempotent). Raises
        :class:`FaultConflictError` if any cell is still job-owned:
        the orchestrator must evict victims first."""
        applied: List[Coord] = []
        for c in coords:
            c = tuple(int(v) for v in c)
            if self.failed[c]:
                continue
            if self.owner[c] >= 0:
                raise FaultConflictError(
                    f"XPU {c} still owned by job {self.owner[c]}; "
                    "evict before failing")
            self.failed[c] = True
            self.occ[c] = True
            self.owner[c] = FAILED
            applied.append(c)
        if applied:
            self._epoch += 1
            self._busy += len(applied)
            self.num_failed += len(applied)
            if self.listeners:
                _events.emit(self.listeners, _events.TopologyEvent(
                    kind="fault", job_id=-1, topology="static",
                    detail={"fault": "node", "targets": applied}))
        return applied

    def repair_nodes(self, coords: Iterable[Coord]) -> List[Coord]:
        """Bring failed XPUs back. Repairing a never-failed cell is a
        no-op; returns the coords actually repaired."""
        applied: List[Coord] = []
        for c in coords:
            c = tuple(int(v) for v in c)
            if not self.failed[c]:
                continue
            self.failed[c] = False
            self.occ[c] = False
            self.owner[c] = -1
            applied.append(c)
        if applied:
            self._epoch += 1
            self._busy -= len(applied)
            self.num_failed -= len(applied)
            if self.listeners:
                _events.emit(self.listeners, _events.TopologyEvent(
                    kind="repair", job_id=-1, topology="static",
                    detail={"fault": "node", "targets": applied}))
        return applied

    def cut_link(self, u: Coord, v: Coord) -> bool:
        """Cut one torus link. Returns False if already cut (no-op).
        Raises :class:`FaultConflictError` if a job owns the link."""
        u = tuple(int(x) for x in u)
        v = tuple(int(x) for x in v)
        if not is_torus_neighbor(u, v, self.dims, self.wrap_flags()):
            raise ValueError(f"{u}->{v} is not a torus link")
        l = canon_link(u, v)
        if l in self.cut_links:
            return False
        if l in self.link_owner:
            raise FaultConflictError(
                f"link {l} still owned by job {self.link_owner[l]}; "
                "evict before cutting")
        self.cut_links.add(l)
        self._epoch += 1
        if self.listeners:
            _events.emit(self.listeners, _events.TopologyEvent(
                kind="fault", job_id=-1, topology="static",
                detail={"fault": "link", "targets": [l]}))
        return True

    def repair_link(self, u: Coord, v: Coord) -> bool:
        """Restore a cut link; no-op (False) if it was never cut."""
        l = canon_link(tuple(int(x) for x in u), tuple(int(x) for x in v))
        if l not in self.cut_links:
            return False
        self.cut_links.discard(l)
        self._epoch += 1
        if self.listeners:
            _events.emit(self.listeners, _events.TopologyEvent(
                kind="repair", job_id=-1, topology="static",
                detail={"fault": "link", "targets": [l]}))
        return True

    def link_failed(self, l: Link) -> bool:
        return l in self.cut_links

    # ------------------------------------------------------------------
    def check_invariants(self) -> None:
        """Exclusivity invariants (used by property tests)."""
        owned = np.zeros(self.dims, dtype=np.int64)
        for a in self.allocations.values():
            for c in a.coords:
                owned[c] += 1
        if (owned > 1).any():
            raise AssertionError("XPU double-booked")
        if (owned[self.failed] > 0).any():
            raise AssertionError("failed XPU owned by a job")
        if not (((owned == 1) | self.failed) == self.occ).all():
            raise AssertionError("occupancy grid out of sync")
        if not (self.owner[self.failed] == FAILED).all():
            raise AssertionError("failed cells must carry the FAILED owner")
        if self.num_failed != int(self.failed.sum()):
            raise AssertionError("failed counter out of sync")
        link_counts: Dict[Link, int] = {}
        for a in self.allocations.values():
            for l in a.links:
                link_counts[l] = link_counts.get(l, 0) + 1
        if any(v > 1 for v in link_counts.values()):
            raise AssertionError("link double-booked")
        if set(link_counts) != set(self.link_owner):
            raise AssertionError("link registry out of sync")
        if self._busy != int(self.occ.sum()):
            raise AssertionError("busy counter out of sync")
