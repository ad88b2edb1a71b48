"""Reconfigurable torus: hardwired N³ cubes stitched by OCS groups.

Model (paper §2 / §3.2, TPU-v4-like): the cluster is ``num_cubes``
hardwired N×N×N cubes. Each XPU has 6 ports; the two opposing ports at
the same face position connect to the same optical circuit switch, so a
cube face can either loop back onto itself (wrap-around) or chain to the
*same face position* of another cube. Consequences we model faithfully:

  * A job spanning cubes must use a **uniform corner offset** in every
    cube (the port-alignment constraint: face XPUs only connect to the
    corresponding XPU of the next cube).
  * Wrap-around links exist for a job dimension only when it spans a
    full chain of cubes (extent == k·N and offset 0 on that axis).
  * Only face XPUs can reach other cubes: a piece that crosses a cube
    boundary necessarily occupies the face cells there — free "core"
    XPUs behind occupied faces are unusable for multi-cube jobs.
  * The OCS layer is modelled as a full per-face-position crossbar
    (assumption noted in DESIGN.md): any free cube can occupy any
    position of the job's virtual cube grid.
  * **Cube ownership**: a cube chained into a multi-cube virtual torus
    has its face OCS wiring dedicated to that job — its leftover XPUs
    are *stranded* until the job completes. This is exactly the
    fragmentation the paper attributes to partially-used cubes ("it
    results in at least one partially used cube", §3.2), and what
    folding into fewer cubes avoids. A standalone cube keeps its
    loop-back wiring and behaves as a small static torus that several
    single-cube jobs may share.

Placement: decompose a fold's target box into per-cube pieces at a
uniform offset, assign physical cubes to grid positions (best-fit
packing), and score plans by the paper's heuristic — fewest cubes,
then fewest OCS links, then least new-cube fragmentation.

The plan search is batched (see DESIGN.md §Batched reconfiguration
plan search): every (offset, cube-grid, wrap, OCS-link, broken-ring)
ingredient is occupancy-independent, so it is materialized once per
(fold, cube size) as numpy arrays, sorted by optimistic score prefix,
and the runtime loop only runs cube assignment for offsets that can
still beat the incumbent — visiting best-prefix-first makes the
score-bound prune a ``break``. ``place_fold_naive`` is the retained
pure-python oracle; parity is byte-identical by construction (both
searches return the feasible plan minimizing ``(score, offset
product index)``).

Occupancy-derived state (free counts, best-fit order, sub-block fit
masks) is cached per occupancy epoch, and a commit or release marks
only the cubes it touched for the next refresh. The masks come from
one mask client (the host ``numpy`` engine, an inline engine or the
fleet's broker): every shape's full-grid fit mask seen so far is one
column of a single ``(C, K, n, n, n)`` stack, and a refresh asks for
all columns of the changed cubes, writes them with one array write,
then asks for the same cubes' free counts, which a broker's fused pass
has already computed and answers without a second round.
"""
from __future__ import annotations

import functools
import itertools
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import obs
from . import events as _events
from . import maskquery
from .engineconfig import EngineConfig
from .folding import Fold, WrapFlags, verify_fold
from .geometry import Coord, Dims, volume
from .torus import FaultConflictError

Slice3 = Tuple[Tuple[int, int], Tuple[int, int], Tuple[int, int]]  # half-open


@functools.lru_cache(maxsize=None)
def _offset_candidates_cached(extent: int, n: int) -> Tuple[int, ...]:
    ca = -(-extent // n)
    slack = ca * n - extent
    return tuple(range(0, slack + 1))


@functools.lru_cache(maxsize=None)
def _axis_spans(ext: int, off: int, n: int):
    """Per-cube spans of one axis at a corner offset: ((grid_i,
    (lo, hi), length), ...) — geometry only, cached forever."""
    spans = []
    lo_g, hi_g = off, off + ext
    for i in range(-(-hi_g // n)):
        lo = max(lo_g, i * n) - i * n
        hi = min(hi_g, (i + 1) * n) - i * n
        if hi > lo:
            spans.append((i, (lo, hi), hi - lo))
    return tuple(spans)


@functools.lru_cache(maxsize=131072)
def _pieces_cached(box: Dims, offsets: Coord, n: int):
    """Per-(box, offsets) span decomposition, computed once ever:
    (pieces_spec, best-fit assignment order, cube_grid). Geometry only —
    independent of occupancy."""
    spans = [_axis_spans(e, o, n) for e, o in zip(box, offsets)]
    pieces: List[Tuple[Coord, Slice3]] = []
    sizes: List[int] = []
    for ix, spx, lx in spans[0]:
        for iy, spy, ly in spans[1]:
            lxy = lx * ly
            for iz, spz, lz in spans[2]:
                pieces.append(((ix, iy, iz), (spx, spy, spz)))
                sizes.append(lxy * lz)
    cube_grid = tuple(ax_spans[-1][0] + 1 for ax_spans in spans)
    order = tuple(sorted(range(len(pieces)), key=lambda i: -sizes[i]))
    return tuple(pieces), order, cube_grid


@functools.lru_cache(maxsize=131072)
def _offset_table_cached(box: Dims, n: int):
    """Occupancy-independent plan ingredients for every candidate corner
    offset of ``box`` at cube size ``n``, vectorized over the whole
    offset product (rows in ``itertools.product`` order): offsets
    (O, 3), cube grids (O, 3), cube counts (O,), OCS links (O,) and a
    3-bit per-row wrap code."""
    cands = [_offset_candidates_cached(e, n) for e in box]
    offs = np.array(list(itertools.product(*cands)),
                    dtype=np.int64).reshape(-1, 3)
    ext = np.asarray(box, dtype=np.int64)
    cube_grid = -(-(offs + ext) // n)
    ncubes = cube_grid.prod(axis=1)
    wrap = (offs == 0) & (ext[None, :] == cube_grid * n)
    a, b, c = box
    cross = np.array([b * c, a * c, a * b], dtype=np.int64)
    links = ((cube_grid - 1 + wrap) * cross).sum(axis=1)
    wrapcode = wrap[:, 0] * 4 + wrap[:, 1] * 2 + wrap[:, 2]
    return offs, ncubes, links, wrapcode


@dataclass
class _FoldPlanTable:
    """One fold's valid offset candidates at a fixed (cube size, cube
    budget), pre-sorted by optimistic score prefix ``(broken rings,
    cubes, OCS links)`` with the offset product index as the stable
    tiebreak — so a runtime search that walks rows in order and stops
    at the first row whose prefix cannot beat the incumbent reproduces
    the naive product-order scan exactly."""

    offsets: List[Coord]
    offs_arr: np.ndarray           # (O, 3) int64 — the same rows, batched
    ncubes: np.ndarray
    links: np.ndarray
    nbroken: np.ndarray
    broken: List[Tuple[int, ...]]
    wrap: List[WrapFlags]
    pinned_pos: Optional[int]      # row with offsets == (0, 0, 0), if valid
    # The same prefix columns as plain-int lists: the runtime loop
    # compares one row per iteration and python ints beat numpy
    # scalars there.
    prefix: List[Tuple[int, int, int]] = None  # type: ignore[assignment]

    def __post_init__(self):
        self.prefix = list(zip(self.nbroken.tolist(), self.ncubes.tolist(),
                               self.links.tolist()))


def fold_plan_table(fold: Fold, n: int,
                    num_cubes: int) -> Optional[_FoldPlanTable]:
    """Memoized per fold instance (folds are immutable and themselves
    memoized per shape, so tables are computed once per process)."""
    cache = getattr(fold, "_plan_table_cache", None)
    if cache is None:
        cache = {}
        object.__setattr__(fold, "_plan_table_cache", cache)
    key = (n, num_cubes)
    if key not in cache:
        cache[key] = _build_plan_table(fold, n, num_cubes)
    return cache[key]


def _build_plan_table(fold: Fold, n: int,
                      num_cubes: int) -> Optional[_FoldPlanTable]:
    offs, ncubes, links, wrapcode = _offset_table_cached(fold.box, n)
    keep = ncubes <= num_cubes
    if not keep.any():
        return None
    # Fold validity / broken rings depend only on the wrap flags: 8
    # possible codes, each certified once (and memoized on the fold).
    ok8 = np.zeros(8, dtype=bool)
    nb8 = np.zeros(8, dtype=np.int64)
    br8: List[Tuple[int, ...]] = [()] * 8
    for code in np.unique(wrapcode[keep]):
        w = (bool(code & 4), bool(code & 2), bool(code & 1))
        valid, br = verify_fold(fold, w)
        ok8[code], nb8[code], br8[code] = valid, len(br), tuple(br)
    rows = np.nonzero(keep & ok8[wrapcode])[0]
    if not rows.size:
        return None
    nbroken = nb8[wrapcode[rows]]
    order = np.lexsort((rows, links[rows], ncubes[rows], nbroken))
    rows = rows[order]
    offsets = [tuple(int(v) for v in offs[r]) for r in rows]
    pinned = next((i for i, o in enumerate(offsets) if o == (0, 0, 0)),
                  None)
    return _FoldPlanTable(
        offsets=offsets, offs_arr=offs[rows],
        ncubes=ncubes[rows], links=links[rows], nbroken=nbroken[order],
        broken=[br8[wrapcode[r]] for r in rows],
        wrap=[(bool(c & 4), bool(c & 2), bool(c & 1))
              for c in wrapcode[rows]],
        pinned_pos=pinned)


def fold_score_bound(fold: Fold, n: int) -> Tuple:
    """Optimistic lexicographic score bound for a fold, computed
    without placing it: the minimal broken-ring count (wrap on every
    axis whose extent admits it — wrap availability only ever shrinks
    the broken set), the minimal cube count (offset 0), the minimal
    OCS links (wrap only where the extent forces it), zero fresh
    cubes. Lower-bounds every plan the fold can produce, so a fold
    whose bound loses to the incumbent is skipped without placing."""
    cache = getattr(fold, "_bound_cache", None)
    if cache is None:
        cache = {}
        object.__setattr__(fold, "_bound_cache", cache)
    hit = cache.get(n)
    if hit is None:
        a, b, c = fold.box
        cross = (b * c, a * c, a * b)
        ca = tuple(-(-e // n) for e in fold.box)
        links = sum(
            (ca[ax] - 1 + (1 if fold.box[ax] == ca[ax] * n else 0))
            * cross[ax] for ax in range(3))
        wrap_max = tuple(e % n == 0 for e in fold.box)
        _, broken_min = verify_fold(fold, wrap_max)  # type: ignore[arg-type]
        hit = (len(broken_min), volume(ca), links, 0)
        cache[n] = hit
    return hit


@dataclass
class Piece:
    grid_pos: Coord          # position in the job's virtual cube grid
    cube_id: int             # physical cube assigned
    local: Slice3            # sub-block within the cube (half-open)

    @property
    def shape(self) -> Dims:
        return tuple(hi - lo for lo, hi in self.local)  # type: ignore

    @property
    def size(self) -> int:
        return volume(self.shape)


@dataclass
class ReconfigPlan:
    fold: Fold
    offsets: Coord                     # uniform corner offset per axis
    cube_grid: Dims                    # virtual cube-grid extents
    pieces: List[Piece]
    wrap: WrapFlags                    # wrap-around availability per axis
    broken_rings: Tuple[int, ...]      # job ring axes that cannot close
    num_ocs_links: int
    fresh_cubes: int                   # cubes that were previously empty

    @property
    def num_cubes(self) -> int:
        return len(self.pieces)

    def score(self) -> Tuple:
        """Paper heuristic: fewest cubes, then fewest OCS links; prefer
        plans with intact rings and less fresh-cube consumption."""
        return (len(self.broken_rings), self.num_cubes, self.num_ocs_links,
                self.fresh_cubes)


class ReconfigTorus:
    """Occupancy + placement over ``num_cubes`` reconfigurable cubes."""

    def __init__(self, num_xpus: int = 4096, cube_n: int = 4,
                 dedicate_chained: bool = False,
                 fitmask_engine: Optional[str] = None,
                 engine=None, mask_client=None, listeners=None):
        if num_xpus % (cube_n ** 3):
            raise ValueError("num_xpus must be a multiple of cube volume")
        # Free-block search backend: an EngineConfig / registry name /
        # None for the resolved default (``fitmask_engine`` is the
        # retained legacy spelling).
        self.engine_config = EngineConfig.coerce(
            engine if engine is not None else fitmask_engine)
        self.fitmask_engine = self.engine_config.engine
        # Request/response client (repro_torch.core.maskquery), injected at
        # construction; the fleet layer points many clusters at one
        # shared query broker.
        self.mask_client = mask_client
        # Topology-event listeners (repro_torch.core.events): notified on
        # every commit/release; OCS-wiring changes (multi-cube chains,
        # wrap closures) are flagged ``reconfigured`` so a scheduler
        # service can push RECONFIG. Empty list = zero-cost.
        self.listeners: List[_events.Listener] = list(listeners or [])
        # If True, a cube chained into a multi-cube job is exclusively
        # owned by it (strands leftover XPUs). Default False: the OCS is
        # per-face-position, so leftover sub-blocks stay usable — this
        # matches the paper's reported JCR/utilization bands best; the
        # dedicated variant is kept as an ablation (EXPERIMENTS.md).
        self.dedicate_chained = bool(dedicate_chained)
        self.cube_n = int(cube_n)
        self.num_cubes = num_xpus // (cube_n ** 3)
        # occupancy: (num_cubes, n, n, n)
        self.occ = np.zeros((self.num_cubes,) + (cube_n,) * 3, dtype=bool)
        # cube dedicated to a multi-cube job's virtual torus (-1 = no)
        self.dedicated = np.full(self.num_cubes, -1, dtype=np.int64)
        self.allocations: Dict[int, List[Piece]] = {}
        self.alloc_meta: Dict[int, dict] = {}
        # Fault state (chaos layer): failed cells are marked busy in
        # ``occ`` so every fit mask routes around them; ``ocs_ok``
        # tracks per-cube OCS-port health — a cube with a dead port is
        # detached from the switch fabric, so it cannot join any
        # placement that needs OCS wiring (multi-cube chains or
        # wrap-ring closures) but still hosts OCS-free sub-blocks.
        self.failed = np.zeros(self.occ.shape, dtype=bool)
        self.num_failed = 0
        self.ocs_ok = np.ones(self.num_cubes, dtype=bool)
        # Occupancy epoch: bumped on every commit/release/scatter. All
        # occupancy-derived state consumed by ``place_fold`` is cached
        # per epoch and shared across every fold/offset query in one
        # allocator step. Place/release record which cubes they touched
        # so the next refresh updates only those rows; direct writes to
        # ``occ``/``dedicated`` must be followed by ``bump_epoch()``
        # once any query has been issued (full rebuild).
        self._epoch = 0
        self._busy = 0
        self._cache_epoch = -1
        self._dirty: Optional[set] = None               # None = rebuild all
        self._client = None           # mask client resolved per refresh
        self._free_cnt: Optional[np.ndarray] = None     # (C,) free cells/cube
        self._cube_empty: Optional[np.ndarray] = None   # (C,) bool
        self._order_key: Optional[np.ndarray] = None    # best-fit sort key
        self._global_order: Optional[np.ndarray] = None  # stable key argsort
        self._elig_order: Optional[np.ndarray] = None    # ...non-dedicated
        self._sorted_cands: Dict[Tuple[Slice3, bool, bool], List[int]] = {}
        # Per-epoch full-grid fit masks per sub-block shape (the shape
        # set stabilizes after the first few placements): the columns
        # of one (C, K_cap, n, n, n) stack, in ``_stack_shapes`` order,
        # and ``_shape_masks[shape]`` is a view of its column.
        self._shape_masks: Dict[Dims, np.ndarray] = {}
        self._stack: Optional[np.ndarray] = None
        self._stack_shapes: List[Dims] = []

    # ------------------------------------------------------------------
    def bump_epoch(self) -> None:
        """Invalidate cached occupancy-derived state (call after any
        direct mutation of ``occ``/``dedicated``)."""
        self._epoch += 1
        self._dirty = None          # unknown mutation: rebuild everything
        self._busy = int(self.occ.sum())

    def _mark_dirty(self, cubes) -> None:
        """Start a new occupancy epoch, remembering which cubes changed
        so the refresh is incremental."""
        self._epoch += 1
        if self._dirty is not None:
            self._dirty.update(cubes)

    def _derived(self) -> None:
        """Refresh per-epoch derived state: per-cube free counts and
        best-fit sort keys, and every stacked fit mask, brought up to
        date with the free counts in one round (:meth:`_refresh_rows`).
        When only a few cubes changed since the last refresh (tracked
        by place/release), just those rows are recomputed. A refresh is
        the span ``reconfig.derive`` (repro_torch.obs)."""
        if self._cache_epoch == self._epoch:
            return
        with obs.span("reconfig.derive"):
            n3 = self.cube_n ** 3
            client = maskquery.torus_client(self.mask_client,
                                            self.engine_config)
            dirty = self._dirty
            partial = (dirty is not None and self._cache_epoch >= 0
                       and client is self._client
                       and len(dirty) * 4 <= self.num_cubes)
            if partial:
                d = np.fromiter(dirty, dtype=np.int64, count=len(dirty))
                d.sort()
                if d.size:
                    self._free_cnt[d] = self._refresh_rows(client, d)
                    self._cube_empty[d] = self._free_cnt[d] == n3
            else:
                self._free_cnt = self._refresh_rows(client, slice(None))
                self._cube_empty = self._free_cnt == n3
            # Best-fit ordering: least leftover first, non-empty cubes break
            # ties (the piece size shifts every key equally, so one key
            # serves all piece sizes); np.argmin's first-minimum rule becomes
            # a stable sort with index tiebreak.
            self._order_key = self._free_cnt * 2 + self._cube_empty
            self._global_order = np.argsort(self._order_key, kind="stable")
            # Eligible non-empty cubes: any plan on nc cubes strands at
            # least nc - this many fresh (previously empty) cubes — the
            # per-row fresh lower bound the search prunes with.
            self._n_nonempty_elig = int(
                (~self._cube_empty & (self.dedicated < 0)).sum())
            self._elig_order = None
            self._client = client
            self._sorted_cands = {}
            self._dirty = set()
            self._cache_epoch = self._epoch

    def _refresh_rows(self, client, rows) -> np.ndarray:
        """Bring rows ``rows`` of every stacked fit mask up to date and
        return their free counts, in one round: masks for every stacked
        shape first, in column order and written with one array write,
        then the counts of the same occupancy. A broker's fused pass
        computed those counts with the masks and answers them from its
        cache without parking; with no stacked shape the counts are a
        round of their own."""
        occ = self.occ[rows]
        k = len(self._stack_shapes)
        if k:
            out = client.multibox(occ, self._stack_shapes)
            self._stack[rows, :k] = out != 0
        return client.free_counts(occ)

    def _stack_column(self, shape: Dims) -> np.ndarray:
        """Append ``shape`` as the stack's next column, growing its
        capacity geometrically (and rebinding every column's view), and
        return the column's view."""
        k = len(self._stack_shapes)
        if self._stack is None or k == self._stack.shape[1]:
            grown = np.zeros((self.num_cubes, max(8, 2 * k))
                             + self.occ.shape[1:], dtype=bool)
            if k:
                grown[:, :k] = self._stack[:, :k]
            self._stack = grown
            self._shape_masks = {s: grown[:, j]
                                 for j, s in enumerate(self._stack_shapes)}
        self._stack_shapes.append(shape)
        m = self._shape_masks[shape] = self._stack[:, k]
        return m

    def _eligible_order(self) -> np.ndarray:
        """Non-dedicated cube ids in best-fit order (the per-epoch
        stable key argsort filtered to eligible cubes)."""
        if self._elig_order is None:
            go = self._global_order
            self._elig_order = go[(self.dedicated < 0)[go]]
        return self._elig_order

    # ------------------------------------------------------------------
    @property
    def num_xpus(self) -> int:
        return self.num_cubes * self.cube_n ** 3

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

    @property
    def max_extent(self) -> int:
        """Largest placeable extent on one axis: a chain of all cubes."""
        return self.num_cubes * self.cube_n

    # ------------------------------------------------------------------
    def _offset_candidates(self, extent: int) -> List[int]:
        """Corner offsets on one axis that do not inflate the cube count
        beyond ceil(extent / n)."""
        return list(_offset_candidates_cached(extent, self.cube_n))

    def _pieces_for(self, box: Dims, offsets: Coord) -> List[Tuple[Coord, Slice3]]:
        """Virtual grid positions and per-cube local sub-blocks."""
        n = self.cube_n
        per_axis: List[List[Tuple[int, Tuple[int, int]]]] = []
        for ext, off in zip(box, offsets):
            spans = []
            lo_g, hi_g = off, off + ext
            ncubes = -(-hi_g // n)
            for i in range(ncubes):
                lo = max(lo_g, i * n) - i * n
                hi = min(hi_g, (i + 1) * n) - i * n
                if hi > lo:
                    spans.append((i, (lo, hi)))
            per_axis.append(spans)
        out = []
        for (ix, sx), (iy, sy), (iz, sz) in itertools.product(*per_axis):
            out.append(((ix, iy, iz), (sx, sy, sz)))
        return out

    def _shape_fit_mask(self, shape: Dims) -> np.ndarray:
        """Full-grid fit mask for one sub-block shape across ALL cubes:
        bool (C, n, n, n), True where the shape fits in free space with
        its corner at that cell. The mask is a column of the stack that
        each refresh brings up to date in one round with the free
        counts; a shape not yet stacked is asked for alone and appended,
        and refreshed with the rest from then on. Every per-local query
        (:meth:`_block_free_mask`, the cube assignment, the vectorized
        single-cube search) is a view into it. Asking for a missing
        mask is the span ``reconfig.fit_masks`` (repro_torch.obs)."""
        self._derived()
        m = self._shape_masks.get(shape)
        if m is None:
            with obs.span("reconfig.fit_masks"):
                out = self._client.multibox(self.occ, [shape])
                m = self._stack_column(shape)
                m[...] = out[:, 0] != 0
        return m

    def _block_free_mask(self, local: Slice3) -> np.ndarray:
        """Bool mask over cubes: sub-block ``local`` entirely free."""
        shape = tuple(hi - lo for lo, hi in local)
        origin = tuple(lo for lo, _ in local)
        return self._shape_fit_mask(shape)[(slice(None),) + origin]

    def _block_free_mask_naive(self, local: Slice3) -> np.ndarray:
        """Reference implementation (direct slice scan), retained for
        the parity tests."""
        (x0, x1), (y0, y1), (z0, z1) = local
        sub = self.occ[:, x0:x1, y0:y1, z0:z1]
        return ~sub.any(axis=(1, 2, 3))

    def _cands_for(self, local: Slice3, chained: bool,
                   multi: bool = False) -> List[int]:
        """Cube ids eligible for a piece, pre-sorted by the best-fit key
        (stable, index tiebreak) — the per-epoch stable argsort of the
        key, filtered to eligible cubes, which equals sorting the
        eligible ids by ``(key, id)``. Computed once per (local,
        chained, multi) per epoch; returned as a plain list (the
        assignment scan is a tight python loop). Callers hold the epoch
        current (``place_fold`` refreshes before searching). ``multi``
        marks pieces of a multi-cube plan: chaining rides the OCS
        fabric, so cubes with a failed OCS port are excluded."""
        key = (local, chained, multi)
        arr = self._sorted_cands.get(key)
        if arr is None:
            if chained:
                mask = self._cube_empty & (self.dedicated < 0)
            else:
                mask = self._block_free_mask(local) & (self.dedicated < 0)
            if multi and not self.ocs_ok.all():
                mask = mask & self.ocs_ok
            go = self._global_order
            arr = go[mask[go]].tolist()
            self._sorted_cands[key] = arr
        return arr

    @staticmethod
    def _ocs_links(box: Dims, offsets: Coord, cube_grid: Dims, n: int,
                   wrap: WrapFlags) -> int:
        """Inter-cube (OCS) links consumed: one per face-position at each
        cube-boundary crossing, plus wrap closures."""
        total = 0
        a, b, c = box
        cross_section = (b * c, a * c, a * b)
        for ax in range(3):
            crossings = cube_grid[ax] - 1
            if wrap[ax]:
                crossings += 1  # ring closure through the OCS
            total += crossings * cross_section[ax]
        return total

    # ------------------------------------------------------------------
    def place_fold(self, fold: Fold, offset_search: bool = True,
                   bound: Optional[Tuple] = None) -> Optional[ReconfigPlan]:
        """Best reconfiguration plan for one fold candidate, or None.

        ``offset_search=False`` pins every piece to the cube corner
        (offset 0) — the naive Reconfig baseline whose partial-cube
        fragmentation the paper criticises; RFold searches offsets as
        part of "virtually reconfiguring the topology to best match the
        shape".

        ``bound`` is an incumbent lexicographic score: only plans that
        strictly beat it are returned. All offset candidates were
        pre-scored into the fold's plan table (vectorized, occupancy
        independent) and sorted by optimistic prefix, so the search
        runs cube assignment best-prefix-first and terminates at the
        first row that cannot beat the incumbent. With ``bound=None``
        the result equals :meth:`place_fold_naive`.
        """
        box = fold.box
        n = self.cube_n
        if any(ext > self.max_extent for ext in box):
            return None
        tab = fold_plan_table(fold, n, self.num_cubes)
        if tab is None:
            return None
        self._derived()
        # Port alignment only binds multi-cube chains; a single-cube job
        # is an ordinary within-cube box placement, so its offsets are
        # always searchable (and fully vectorizable). The naive
        # (Reconfig) baseline pins chained pieces to the cube corner.
        if all(ext <= n for ext in box):
            return self._place_single_cube(fold, tab, bound)
        if offset_search:
            positions = range(len(tab.offsets))
        elif tab.pinned_pos is not None:
            positions = (tab.pinned_pos,)
        else:
            return None
        best: Optional[ReconfigPlan] = None
        incumbent = bound
        dedic = self.dedicate_chained
        navail = self._n_nonempty_elig
        for t in positions:
            nb, nc, lk = p3 = tab.prefix[t]
            # Fresh-cube lower bound: a chained plan dedicates nc empty
            # cubes (fresh == nc exactly); otherwise at most ``navail``
            # of the nc cubes can be non-empty.
            fresh_lb = nc if (dedic and nc > 1) else max(0, nc - navail)
            if incumbent is not None:
                i3 = incumbent[:3]
                # Rows are prefix-sorted: once this row cannot strictly
                # beat the incumbent, no later row can either.
                if p3 > i3 or (p3 == i3 and incumbent[3] == 0):
                    break
                # Rows that cannot strictly beat the incumbent even at
                # their fresh bound skip cube assignment entirely.
                if (nb, nc, lk, fresh_lb) >= incumbent:
                    continue
            plan = self._assign_plan(fold, tab, t)
            if plan is None:
                continue
            score = plan.score()
            if incumbent is None or score < incumbent:
                best = plan
                incumbent = score
                # A plan at its own row's fresh bound is unbeatable:
                # same-prefix rows share the bound (ties never replace)
                # and later prefixes only score worse.
                if score[3] == fresh_lb:
                    break
        return best

    def _place_single_cube(self, fold: Fold, tab: _FoldPlanTable,
                           bound: Optional[Tuple]) -> Optional[ReconfigPlan]:
        """Fully vectorized search for a fold whose box fits inside one
        cube — the bulk of a Philly-like trace. Every (offset, cube)
        candidate is scored in one numpy pass: the full-grid fit mask
        answers sub-block freeness for all offsets of all cubes at
        once, the per-epoch best-fit cube order turns cube choice into
        a column argmax, and the winning row is a single lexicographic
        argmin over ``(broken, links, fresh, product index)`` — exactly
        the naive scan's ``(score, offset order)`` minimum."""
        shape = fold.box
        sub = self._shape_fit_mask(shape)
        elig = self._eligible_order()
        if not elig.size:
            return None
        offs = tab.offs_arr
        sub = sub[elig][:, offs[:, 0], offs[:, 1], offs[:, 2]]  # (E, O)
        if not self.ocs_ok.all():
            # Wrap-ring closures ride the OCS fabric even inside one
            # cube: offsets that close a ring (links > 0) are barred
            # from cubes with a failed OCS port.
            need_ocs = tab.links > 0
            sub = sub & (self.ocs_ok[elig][:, None] | ~need_ocs[None, :])
        feas = sub.any(axis=0)
        if not feas.any():
            return None
        chosen = elig[sub.argmax(axis=0)]       # first eligible per offset
        fresh = self._cube_empty[chosen].astype(np.int64)
        rows = np.nonzero(feas)[0]
        order = np.lexsort((rows, fresh[rows], tab.links[rows],
                            tab.nbroken[rows]))
        t = int(rows[order[0]])
        score = (int(tab.nbroken[t]), 1, int(tab.links[t]), int(fresh[t]))
        if bound is not None and score >= bound:
            return None
        cube = int(chosen[t])
        ox, oy, oz = tab.offsets[t]
        a, b, c = shape
        piece = Piece((0, 0, 0), cube,
                      ((ox, ox + a), (oy, oy + b), (oz, oz + c)))
        return ReconfigPlan(
            fold=fold, offsets=tab.offsets[t], cube_grid=(1, 1, 1),
            pieces=[piece], wrap=tab.wrap[t], broken_rings=tab.broken[t],
            num_ocs_links=int(tab.links[t]), fresh_cubes=int(fresh[t]))

    def _assign_plan(self, fold: Fold, tab: _FoldPlanTable,
                     t: int) -> Optional[ReconfigPlan]:
        """Best-fit cube assignment for one pre-scored offset row, or
        None if some piece has no eligible cube left."""
        offsets = tab.offsets[t]
        pieces_spec, order, cube_grid = _pieces_cached(fold.box, offsets,
                                                       self.cube_n)
        multi = len(pieces_spec) > 1
        chained = multi and self.dedicate_chained
        taken: set = set()
        assignment: Dict[int, int] = {}
        for idx in order:
            local = pieces_spec[idx][1]
            chosen = -1
            for cid in self._cands_for(local, chained, multi):
                if cid not in taken:
                    chosen = cid
                    break
            if chosen < 0:
                return None
            assignment[idx] = chosen
            taken.add(chosen)
        pieces = [Piece(pieces_spec[i][0], assignment[i], pieces_spec[i][1])
                  for i in range(len(pieces_spec))]
        cube_empty = self._cube_empty
        fresh = int(sum(cube_empty[p.cube_id] for p in pieces))
        return ReconfigPlan(
            fold=fold, offsets=offsets, cube_grid=cube_grid,
            pieces=pieces, wrap=tab.wrap[t],
            broken_rings=tab.broken[t],
            num_ocs_links=int(tab.links[t]), fresh_cubes=fresh)

    @obs.span("reconfig.plan_search")
    def plan_search(self, folds: Sequence[Fold], offset_search: bool = True,
                    ) -> Optional[ReconfigPlan]:
        """Best plan across a fold candidate list — the batched engine
        behind ``_ReconfigBase.try_place``. Folds are visited in caller
        order (scores tie-break on it); each fold's occupancy-free
        optimistic bound (:func:`fold_score_bound`) prunes whole folds
        against the incumbent before any table or occupancy state is
        consulted. The span ``reconfig.plan_search`` (repro_torch.obs)."""
        best: Optional[ReconfigPlan] = None
        bound: Optional[Tuple] = None
        n = self.cube_n
        for fold in folds:
            if bound is not None and fold_score_bound(fold, n) >= bound:
                continue  # cannot strictly beat the incumbent
            plan = self.place_fold(fold, offset_search=offset_search,
                                   bound=bound)
            if plan is None:
                continue
            if bound is None or plan.score() < bound:
                best = plan
                bound = plan.score()
        return best

    def place_fold_naive(self, fold: Fold,
                         offset_search: bool = True) -> Optional[ReconfigPlan]:
        """Reference implementation of :meth:`place_fold` (pure-python
        offset loop, no caching/pruning). Retained as the parity oracle
        for the vectorized engine."""
        box = fold.box
        n = self.cube_n
        if any(ext > self.max_extent for ext in box):
            return None
        best: Optional[ReconfigPlan] = None
        cube_empty = ~self.occ.any(axis=(1, 2, 3))
        single_cube = all(ext <= n for ext in box)
        if offset_search or single_cube:
            offset_space = itertools.product(*(self._offset_candidates(e)
                                               for e in box))
        else:
            offset_space = [(0, 0, 0)]
        for offsets in offset_space:
            pieces_spec = self._pieces_for(box, offsets)
            cube_grid = tuple(
                max(p[0][ax] for p in pieces_spec) + 1 for ax in range(3))
            if volume(cube_grid) > self.num_cubes:
                continue
            multi = len(pieces_spec) > 1
            wrap = tuple(
                offsets[ax] == 0 and box[ax] == cube_grid[ax] * n
                for ax in range(3))
            # OCS dependence is knowable before assignment: chains
            # (multi-cube) and wrap closures both ride the fabric.
            needs_ocs = multi or any(wrap)
            # Assign physical cubes: biggest pieces first, best-fit
            # (prefer partially-used cubes with least leftover).
            order = sorted(range(len(pieces_spec)),
                           key=lambda i: -volume(
                               tuple(hi - lo for lo, hi in pieces_spec[i][1])))
            free_cnt = (~self.occ).sum(axis=(1, 2, 3)).astype(np.int64)
            taken = np.zeros(self.num_cubes, dtype=bool)
            assignment: Dict[int, int] = {}
            ok = True
            for idx in order:
                _, local = pieces_spec[idx]
                if multi and self.dedicate_chained:
                    # chaining dedicates the cube: only fully-free,
                    # non-dedicated cubes are eligible
                    mask = cube_empty & (self.dedicated < 0) & ~taken
                else:
                    # per-face-position OCS: shareable; sub-block free
                    mask = (self._block_free_mask_naive(local)
                            & (self.dedicated < 0) & ~taken)
                if needs_ocs:
                    mask = mask & self.ocs_ok
                if not mask.any():
                    ok = False
                    break
                cand = np.nonzero(mask)[0]
                piece_sz = volume(tuple(hi - lo for lo, hi in local))
                # best-fit: least leftover; among ties prefer non-empty cubes
                leftovers = free_cnt[cand] - piece_sz
                keys = leftovers * 2 + cube_empty[cand].astype(np.int64)
                chosen = int(cand[int(np.argmin(keys))])
                assignment[idx] = chosen
                taken[chosen] = True
            if not ok:
                continue
            valid, broken = verify_fold(fold, wrap)  # type: ignore[arg-type]
            if not valid:
                continue
            pieces = [Piece(pieces_spec[i][0], assignment[i],
                            pieces_spec[i][1]) for i in range(len(pieces_spec))]
            fresh = int(sum(cube_empty[p.cube_id] for p in pieces))
            plan = ReconfigPlan(
                fold=fold, offsets=offsets, cube_grid=cube_grid,  # type: ignore
                pieces=pieces, wrap=wrap,  # type: ignore[arg-type]
                broken_rings=tuple(broken),
                num_ocs_links=self._ocs_links(box, offsets, cube_grid, n,
                                              wrap),  # type: ignore[arg-type]
                fresh_cubes=fresh)
            if best is None or plan.score() < best.score():
                best = plan
        return best

    # ------------------------------------------------------------------
    def commit(self, job_id: int, plan: ReconfigPlan) -> None:
        if job_id in self.allocations:
            raise ValueError(f"job {job_id} already allocated")
        multi = len(plan.pieces) > 1
        for p in plan.pieces:
            (x0, x1), (y0, y1), (z0, z1) = p.local
            blk = self.occ[p.cube_id, x0:x1, y0:y1, z0:z1]
            if blk.any():
                raise ValueError("sub-block no longer free at commit")
            if self.dedicated[p.cube_id] >= 0:
                raise ValueError("cube already dedicated at commit")
            if multi and self.dedicate_chained:
                if self.occ[p.cube_id].any():
                    raise ValueError("chained cube must be empty at commit")
                self.dedicated[p.cube_id] = job_id
            self.occ[p.cube_id, x0:x1, y0:y1, z0:z1] = True
        self._mark_dirty(p.cube_id for p in plan.pieces)
        self._busy += sum(p.size for p in plan.pieces)
        self.allocations[job_id] = list(plan.pieces)
        self.alloc_meta[job_id] = {
            "fold": str(plan.fold), "kind": plan.fold.kind,
            "box": plan.fold.box, "cube_grid": plan.cube_grid,
            "offsets": plan.offsets, "wrap": plan.wrap,
            "broken_rings": plan.broken_rings,
            "num_cubes": plan.num_cubes, "ocs_links": plan.num_ocs_links,
        }
        if self.listeners:
            _events.emit(self.listeners, _events.TopologyEvent(
                kind="setup", job_id=job_id, topology="reconfig",
                reconfigured=plan.num_ocs_links > 0,
                detail={"cubes": sorted(p.cube_id for p in plan.pieces),
                        **self.alloc_meta[job_id]}))

    def release(self, job_id: int) -> None:
        pieces = self.allocations.pop(job_id)
        meta = self.alloc_meta.get(job_id, {})
        for p in pieces:
            (x0, x1), (y0, y1), (z0, z1) = p.local
            self.occ[p.cube_id, x0:x1, y0:y1, z0:z1] = False
            if self.dedicated[p.cube_id] == job_id:
                self.dedicated[p.cube_id] = -1
            self._busy -= p.size
        self._mark_dirty(p.cube_id for p in pieces)
        self.alloc_meta.pop(job_id, None)
        if self.listeners:
            # Releasing a chained job frees its OCS wiring — that, too,
            # is a reconfiguration of the switch layer.
            _events.emit(self.listeners, _events.TopologyEvent(
                kind="release", job_id=job_id, topology="reconfig",
                reconfigured=int(meta.get("ocs_links", 0) or 0) > 0,
                detail={"cubes": sorted({p.cube_id for p in pieces}),
                        "ocs_links": meta.get("ocs_links", 0)}))

    # ------------------------------------------------------------------
    def free_cells(self, limit: int):
        """Up to ``limit`` free (cube_id, x, y, z) cells from
        non-dedicated cubes (best-effort scatter placement)."""
        out = []
        for cid in range(self.num_cubes):
            if self.dedicated[cid] >= 0:
                continue
            free = np.argwhere(~self.occ[cid])
            for (x, y, z) in free:
                out.append((cid, int(x), int(y), int(z)))
                if len(out) >= limit:
                    return out
        return out

    def commit_scatter(self, job_id: int, cells) -> None:
        """Best-effort non-contiguous allocation (paper §5): occupy the
        given cells as single-cell pieces (no shape/ring guarantee)."""
        if job_id in self.allocations:
            raise ValueError(f"job {job_id} already allocated")
        pieces = []
        for (cid, x, y, z) in cells:
            if self.occ[cid, x, y, z]:
                raise ValueError("cell busy at scatter commit")
            self.occ[cid, x, y, z] = True
            pieces.append(Piece((0, 0, 0), cid,
                                ((x, x + 1), (y, y + 1), (z, z + 1))))
        self._mark_dirty(c[0] for c in cells)
        self._busy += len(pieces)
        self.allocations[job_id] = pieces
        self.alloc_meta[job_id] = {"kind": "scatter",
                                   "num_cubes": len({c[0] for c in cells})}
        if self.listeners:
            _events.emit(self.listeners, _events.TopologyEvent(
                kind="setup", job_id=job_id, topology="reconfig",
                detail={"cubes": sorted({c[0] for c in cells}),
                        **self.alloc_meta[job_id]}))

    # -- fault injection (chaos layer) ---------------------------------
    def jobs_on(self, cells) -> List[int]:
        """Job ids whose pieces cover any of the (cube, x, y, z) cells
        (fault victims), sorted for determinism."""
        targets = {tuple(int(v) for v in c) for c in cells}
        hit = set()
        for jid, pieces in self.allocations.items():
            for p in pieces:
                (x0, x1), (y0, y1), (z0, z1) = p.local
                if any(c[0] == p.cube_id and x0 <= c[1] < x1
                       and y0 <= c[2] < y1 and z0 <= c[3] < z1
                       for c in targets):
                    hit.add(jid)
                    break
        return sorted(hit)

    def jobs_using_ocs(self, cube_ids) -> List[int]:
        """Job ids whose OCS wiring rides any of the given cubes: a job
        with ``ocs_links > 0`` (chain or wrap closure) touching the
        cube loses its virtual topology when the port dies."""
        cubes = {int(c) for c in cube_ids}
        hit = set()
        for jid, pieces in self.allocations.items():
            if int(self.alloc_meta.get(jid, {}).get("ocs_links", 0) or 0) <= 0:
                continue
            if any(p.cube_id in cubes for p in pieces):
                hit.add(jid)
        return sorted(hit)

    def fail_cells(self, cells) -> List[Tuple[int, int, int, int]]:
        """Mark (cube, x, y, z) cells failed: they read busy to every
        fit mask but belong to no job. Already-failed cells are skipped
        (idempotent); a still-owned cell raises
        :class:`FaultConflictError` — evict victims first."""
        applied: List[Tuple[int, int, int, int]] = []
        for c in cells:
            c = tuple(int(v) for v in c)
            if self.failed[c]:
                continue
            if self.occ[c]:
                raise FaultConflictError(
                    f"cell {c} still owned by a job; evict before failing")
            self.failed[c] = True
            self.occ[c] = True
            applied.append(c)
        if applied:
            self._mark_dirty({c[0] for c in applied})
            self._busy += len(applied)
            self.num_failed += len(applied)
            if self.listeners:
                _events.emit(self.listeners, _events.TopologyEvent(
                    kind="fault", job_id=-1, topology="reconfig",
                    detail={"fault": "node", "targets": applied}))
        return applied

    def repair_cells(self, cells) -> List[Tuple[int, int, int, int]]:
        """Bring failed cells back; repairing a never-failed cell is a
        no-op. Returns the cells actually repaired."""
        applied: List[Tuple[int, int, int, int]] = []
        for c in cells:
            c = tuple(int(v) for v in c)
            if not self.failed[c]:
                continue
            self.failed[c] = False
            self.occ[c] = False
            applied.append(c)
        if applied:
            self._mark_dirty({c[0] for c in applied})
            self._busy -= len(applied)
            self.num_failed -= len(applied)
            if self.listeners:
                _events.emit(self.listeners, _events.TopologyEvent(
                    kind="repair", job_id=-1, topology="reconfig",
                    detail={"fault": "node", "targets": applied}))
        return applied

    def fail_ocs_port(self, cube_ids) -> List[int]:
        """Detach cubes from the OCS fabric (dead switch port): they
        can no longer join multi-cube chains or close wrap rings, but
        keep hosting OCS-free sub-blocks. Raises
        :class:`FaultConflictError` while a job's wiring still rides
        the cube — evict via :meth:`jobs_using_ocs` first."""
        applied: List[int] = []
        for cid in cube_ids:
            cid = int(cid)
            if not self.ocs_ok[cid]:
                continue
            users = self.jobs_using_ocs([cid])
            if users:
                raise FaultConflictError(
                    f"cube {cid} OCS wiring still used by jobs {users}; "
                    "evict before failing the port")
            self.ocs_ok[cid] = False
            applied.append(cid)
        if applied:
            self._mark_dirty(())   # resets per-epoch candidate caches
            if self.listeners:
                _events.emit(self.listeners, _events.TopologyEvent(
                    kind="fault", job_id=-1, topology="reconfig",
                    reconfigured=True,
                    detail={"fault": "ocs_port", "targets": applied}))
        return applied

    def repair_ocs_port(self, cube_ids) -> List[int]:
        """Re-attach cubes to the OCS fabric; never-failed ports are a
        no-op. Returns the cubes actually repaired."""
        applied: List[int] = []
        for cid in cube_ids:
            cid = int(cid)
            if self.ocs_ok[cid]:
                continue
            self.ocs_ok[cid] = True
            applied.append(cid)
        if applied:
            self._mark_dirty(())
            if self.listeners:
                _events.emit(self.listeners, _events.TopologyEvent(
                    kind="repair", job_id=-1, topology="reconfig",
                    reconfigured=True,
                    detail={"fault": "ocs_port", "targets": applied}))
        return applied

    # ------------------------------------------------------------------
    def check_invariants(self) -> None:
        ref = np.zeros_like(self.occ, dtype=np.int64)
        for pieces in self.allocations.values():
            for p in pieces:
                (x0, x1), (y0, y1), (z0, z1) = p.local
                ref[p.cube_id, x0:x1, y0:y1, z0:z1] += 1
        if (ref > 1).any():
            raise AssertionError("XPU double-booked across cubes")
        if (ref[self.failed] > 0).any():
            raise AssertionError("failed cell owned by a job")
        if not (((ref == 1) | self.failed) == self.occ).all():
            raise AssertionError("cube occupancy out of sync")
        if self.num_failed != int(self.failed.sum()):
            raise AssertionError("failed counter out of sync")
        ded = np.full(self.num_cubes, -1, dtype=np.int64)
        for jid, pieces in self.allocations.items():
            if len(pieces) > 1 and self.dedicate_chained:
                for p in pieces:
                    if ded[p.cube_id] != -1:
                        raise AssertionError("cube dedicated to two jobs")
                    ded[p.cube_id] = jid
        if not (ded == self.dedicated).all():
            raise AssertionError("dedication registry out of sync")
        if self._busy != int(self.occ.sum()):
            raise AssertionError("busy counter out of sync")
