"""Placement policies: FirstFit, Folding-only, Reconfig-only, RFold.

All four are evaluated in the paper (§4). Rotation is default behaviour
for every policy; folding and reconfiguration are the paper's two
techniques, and RFold composes them.

The sim contract:
  * ``can_ever_place(shape)`` — placeable on an EMPTY cluster? If not,
    the scheduler drops the job ("incompatible shape", counts against
    JCR) instead of head-of-line blocking forever.
  * ``try_place(job_id, shape)`` — attempt an allocation now; returns a
    ``Placement`` (with ring-quality metadata for the runtime model) or
    None if resources are currently insufficient.
  * ``release(job_id)`` — free the allocation.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from .. import obs
from .folding import Fold, enumerate_folds, ring_edge_index, verify_fold
from .geometry import Coord, Dims, JobShape, volume
from .reconfig import ReconfigPlan, ReconfigTorus
from .torus import StaticTorus


def shape_key(shape: JobShape) -> Dims:
    """Canonical rotation-invariant key for a job shape.

    Every policy treats rotations of a shape as the same placement
    problem (rotation is default behaviour, §2), so feasibility — both
    ``can_ever_place`` and "does it fit the cluster *right now*" — is a
    function of the sorted extents only. Shared by the policies'
    admission cache and the simulator's backfill feasibility watermark.
    """
    return tuple(sorted(shape.dims, reverse=True))


@dataclass
class Placement:
    job_id: int
    shape: JobShape
    broken_rings: Tuple[int, ...]
    meta: dict = field(default_factory=dict)

    @property
    def rings_intact(self) -> bool:
        return not self.broken_rings


class PlacementPolicy:
    """Base class; owns its cluster model."""

    name = "base"

    def __init__(self) -> None:
        self._can_place_cache: Dict[Dims, bool] = {}

    # -- cluster state -------------------------------------------------
    @property
    def num_xpus(self) -> int:
        raise NotImplementedError

    @property
    def busy_xpus(self) -> int:
        raise NotImplementedError

    def utilization(self) -> float:
        return self.busy_xpus / self.num_xpus

    # -- scheduling API ------------------------------------------------
    # Each policy's ``try_place`` is the span ``policy.place``
    # (repro_torch.obs): the parent of the folding, cube-search and
    # torus spans of one placement attempt.
    def try_place(self, job_id: int, shape: JobShape) -> Optional[Placement]:
        raise NotImplementedError

    def release(self, job_id: int) -> None:
        raise NotImplementedError

    def can_ever_place(self, shape: JobShape) -> bool:
        key = shape_key(shape)
        hit = self._can_place_cache.get(key)
        if hit is None:
            hit = self._can_ever_place(shape)
            self._can_place_cache[key] = hit
        return hit

    def _can_ever_place(self, shape: JobShape) -> bool:
        obs.count("policy.clone_probes")
        fresh = self.empty_clone()
        return fresh.try_place(-1, shape) is not None

    def empty_clone(self) -> "PlacementPolicy":
        raise NotImplementedError


# ----------------------------------------------------------------------
# Static-torus policies
# ----------------------------------------------------------------------

class _StaticBase(PlacementPolicy):
    def __init__(self, dims: Dims = (16, 16, 16),
                 fitmask_engine: Optional[str] = None,
                 engine=None, mask_client=None):
        super().__init__()
        self.torus = StaticTorus(dims, fitmask_engine=fitmask_engine,
                                 engine=engine, mask_client=mask_client)

    def _candidate_boxes(self, folds) -> List[Dims]:
        """Distinct in-bounds fold boxes — one allocator step's fit-mask
        query set, declared up front so an accelerator fitmask engine
        answers them all in a single multi-box kernel pass."""
        seen = set()
        for fold in folds:
            if all(b <= d for b, d in zip(fold.box, self.torus.dims)):
                seen.add(fold.box)
        return sorted(seen)

    @property
    def num_xpus(self) -> int:
        return self.torus.num_xpus

    @property
    def busy_xpus(self) -> int:
        return self.torus.busy_xpus

    def release(self, job_id: int) -> None:
        self.torus.release(job_id)

    def _wrap_for_box(self, box: Dims, origin: Coord):
        """Static torus: an axis has usable wrap-around for this job only
        when the box spans the full torus dimension."""
        return tuple(b == d for b, d in zip(box, self.torus.dims))

    def _folds(self, shape: JobShape) -> List[Fold]:
        raise NotImplementedError

    def _can_ever_place(self, shape: JobShape) -> bool:
        """Empty-cluster feasibility from the fold list, with no clone:
        on an empty static torus every in-bounds fold box fits at the
        origin, and a verified fold always commits. Like a fresh clone,
        it reads none of this torus's occupancy or faults."""
        obs.count("policy.feasibility")
        dims = self.torus.dims
        for fold in self._folds(shape):
            if any(b > d for b, d in zip(fold.box, dims)):
                continue
            if verify_fold(fold, self._wrap_for_box(fold.box, (0, 0, 0)))[0]:
                return True
        return False

    @obs.span("torus.commit")
    def _commit_fold(self, job_id: int, fold: Fold, origin: Coord,
                     broken: Tuple[int, ...]) -> Placement:
        # XPUs in ring-traversal (C-order logical) order: ``mapping``'s.
        o = np.asarray(origin, dtype=np.int64)
        local = np.asarray(fold.mapping, dtype=np.int64)
        coords = list(map(tuple, (local + o).tolist()))
        # Links: ring edges that are physically realizable (direct or via
        # an available wrap link); broken closures consume no link. Every
        # test runs on box-local ends: the origin cancels in each
        # difference and in ``canon_link``'s lexicographic order.
        iu, iv = ring_edge_index(fold.job_dims)
        u, v = local[iu], local[iv]
        dims = np.asarray(self.torus.dims, dtype=np.int64)
        ad = np.abs(u - v)
        hops = np.where(self.torus.wrap_flags(), np.minimum(ad, dims - ad), ad)
        neighbor = hops.sum(axis=1) == 1  # is_torus_neighbor
        # physical only if inside box or via full-span wrap
        wrap = np.asarray(self._wrap_for_box(fold.box, origin))
        physical = (ad <= 1).all(axis=1) | ((ad == dims - 1) & wrap).any(axis=1)
        u, v = u[neighbor & physical], v[neighbor & physical]
        d = v - u
        u_first = d[np.arange(len(d)), np.argmax(d != 0, axis=1)] >= 0
        lo = np.where(u_first[:, None], u, v) + o
        hi = np.where(u_first[:, None], v, u) + o
        links = list(zip(map(tuple, lo.tolist()), map(tuple, hi.tolist())))
        # A cut link (chaos layer) cannot be claimed — the ring routes
        # around it, so its axis joins the broken set (same 17% slowdown
        # the paper charges any broken ring).
        cut = self.torus.cut_links
        if cut:
            extra_broken = {next(ax for ax in range(3) if l[0][ax] != l[1][ax])
                            for l in links if l in cut}
            if extra_broken:
                links = [l for l in links if l not in cut]
                broken = tuple(sorted(set(broken) | extra_broken))
        meta = {"fold": str(fold), "kind": fold.kind, "box": fold.box,
                "origin": origin, "broken_rings": broken}
        self.torus.commit(job_id, coords, links, meta)
        return Placement(job_id, JobShape(fold.job_dims), broken, meta)


class FirstFitPolicy(_StaticBase):
    """Paper baseline: contiguous box at the first free origin, rotations
    allowed, no ring guarantees (broken rings are recorded, not avoided)."""

    name = "firstfit"

    def empty_clone(self) -> "FirstFitPolicy":
        # Clones are throwaway feasibility probes: they inherit the
        # engine config but never the mask client (a brokered client
        # would park a query for a cluster nobody registered).
        return FirstFitPolicy(self.torus.dims,
                              engine=self.torus.engine_config)

    def _folds(self, shape: JobShape) -> List[Fold]:
        return [f for f in enumerate_folds(shape,
                                           max_dim=max(self.torus.dims),
                                           include_identity=True)
                if f.kind == "identity"]

    @obs.span("policy.place")
    def try_place(self, job_id: int, shape: JobShape) -> Optional[Placement]:
        folds = self._folds(shape)
        self.torus.prefetch_boxes(self._candidate_boxes(folds))
        for fold in folds:
            if any(b > d for b, d in zip(fold.box, self.torus.dims)):
                continue
            origin = self.torus.find_free_box(fold.box)
            if origin is None:
                continue
            wrap = self._wrap_for_box(fold.box, origin)
            ok, broken = verify_fold(fold, wrap)
            if not ok:
                continue
            return self._commit_fold(job_id, fold, origin, tuple(broken))
        return None


class FoldingPolicy(_StaticBase):
    """Folding-only (static torus): evaluate every fold variant, prefer
    intact rings, then compact boxes; commit the first-fit origin."""

    name = "folding"

    def empty_clone(self) -> "FoldingPolicy":
        return FoldingPolicy(self.torus.dims,
                             engine=self.torus.engine_config)

    def _folds(self, shape: JobShape) -> List[Fold]:
        return list(enumerate_folds(shape, max_dim=max(self.torus.dims)))

    @obs.span("policy.place")
    def try_place(self, job_id: int, shape: JobShape) -> Optional[Placement]:
        candidates = []
        folds = self._folds(shape)
        self.torus.prefetch_boxes(self._candidate_boxes(folds))
        for fold in folds:
            if any(b > d for b, d in zip(fold.box, self.torus.dims)):
                continue
            origin = self.torus.find_free_box(fold.box)
            if origin is None:
                continue
            wrap = self._wrap_for_box(fold.box, origin)
            ok, broken = verify_fold(fold, wrap)
            if not ok:
                continue
            score = (len(broken), max(fold.box), volume(fold.box))
            candidates.append((score, fold, origin, tuple(broken)))
        if not candidates:
            return None
        candidates.sort(key=lambda t: t[0])
        _, fold, origin, broken = candidates[0]
        return self._commit_fold(job_id, fold, origin, broken)


# ----------------------------------------------------------------------
# Reconfigurable-torus policies
# ----------------------------------------------------------------------

class _ReconfigBase(PlacementPolicy):
    def __init__(self, num_xpus: int = 4096, cube_n: int = 4,
                 dedicate_chained: bool = False,
                 fitmask_engine: Optional[str] = None,
                 engine=None, mask_client=None):
        super().__init__()
        self.cluster = ReconfigTorus(num_xpus, cube_n,
                                     dedicate_chained=dedicate_chained,
                                     fitmask_engine=fitmask_engine,
                                     engine=engine, mask_client=mask_client)

    @property
    def num_xpus(self) -> int:
        return self.cluster.num_xpus

    @property
    def busy_xpus(self) -> int:
        return self.cluster.busy_xpus

    def release(self, job_id: int) -> None:
        self.cluster.release(job_id)

    def _folds(self, shape: JobShape) -> List[Fold]:
        raise NotImplementedError

    @staticmethod
    def _dedupe_rotations(folds: List[Fold]) -> List[Fold]:
        """Cubes are location-free behind the OCS crossbar, so folds whose
        boxes are rotations of each other produce identical plans; keep
        one representative per (kind, extent/wrap multiset)."""
        seen = set()
        out = []
        for f in folds:
            key = (f.kind, tuple(sorted(zip(f.box, f.wrap_required))))
            if key in seen:
                continue
            seen.add(key)
            out.append(f)
        return out

    offset_search = True
    # Parity escape hatch: route everything through the retained naive
    # engine (pure-python place_fold, clone-based can_ever_place).
    use_naive = False

    @obs.span("policy.place")
    def try_place(self, job_id: int, shape: JobShape) -> Optional[Placement]:
        if self.use_naive:
            best: Optional[ReconfigPlan] = None
            for fold in self._folds(shape):
                plan = self.cluster.place_fold_naive(
                    fold, offset_search=self.offset_search)
                if plan is None:
                    continue
                if best is None or plan.score() < best.score():
                    best = plan
        elif shape.size > self.cluster.free_xpus:
            best = None  # every fold box has volume == job size
        else:
            # The batched plan-search engine: fold-level bound pruning
            # plus the per-fold pre-scored offset tables, all inside
            # the cluster model (repro_torch.core.reconfig.plan_search).
            best = self.cluster.plan_search(
                self._folds(shape), offset_search=self.offset_search)
        if best is None:
            return None
        self.cluster.commit(job_id, best)
        meta = dict(self.cluster.alloc_meta[job_id])
        return Placement(job_id, shape, best.broken_rings, meta)

    def _can_ever_place(self, shape: JobShape) -> bool:
        """Empty-cluster feasibility without a clone or placement: a
        fold fits an empty cluster iff its extents are chainable and its
        minimal (offset-0) cube grid fits the cube budget — best-fit
        assignment cannot fail when every cube is free. Fold validity is
        wrap-independent (missing wrap only breaks rings, it never
        invalidates the embedding), so checking the offset-0 wrap flags
        is exact."""
        if self.use_naive:
            obs.count("policy.clone_probes")
            fresh = self.empty_clone()
            fresh.use_naive = True
            return fresh.try_place(-1, shape) is not None
        obs.count("policy.feasibility")
        cl = self.cluster
        n = cl.cube_n
        for fold in self._folds(shape):
            if any(e > cl.max_extent for e in fold.box):
                continue
            if volume(tuple(-(-e // n) for e in fold.box)) > cl.num_cubes:
                continue
            wrap0 = tuple(e % n == 0 for e in fold.box)
            if verify_fold(fold, wrap0)[0]:  # type: ignore[arg-type]
                return True
        return False


class ReconfigPolicy(_ReconfigBase):
    """Reconfiguration-only: original shape (plus rotations) decomposed
    into corner-aligned cube pieces stitched by the OCS layer. Pieces
    are pinned to cube corners (no offset packing) — the naive baseline
    the paper contrasts against (its partial-cube fragmentation is the
    motivation for folding)."""

    name = "reconfig"
    offset_search = False

    def empty_clone(self) -> "ReconfigPolicy":
        return ReconfigPolicy(self.cluster.num_xpus, self.cluster.cube_n,
                              dedicate_chained=self.cluster.dedicate_chained,
                              engine=self.cluster.engine_config)

    def _folds(self, shape: JobShape) -> List[Fold]:
        return self._dedupe_rotations([
            f for f in enumerate_folds(shape, max_dim=self.cluster.max_extent)
            if f.kind == "identity"])


class RFoldPolicy(_ReconfigBase):
    """The paper's contribution: folding x reconfiguration, ranked by the
    fewest-cubes / fewest-OCS-links heuristic."""

    name = "rfold"

    def empty_clone(self) -> "RFoldPolicy":
        return RFoldPolicy(self.cluster.num_xpus, self.cluster.cube_n,
                           dedicate_chained=self.cluster.dedicate_chained,
                           engine=self.cluster.engine_config)

    def _folds(self, shape: JobShape) -> List[Fold]:
        return self._dedupe_rotations(
            enumerate_folds(shape, max_dim=self.cluster.max_extent))


class RFoldBestEffortPolicy(RFoldPolicy):
    """Beyond-paper (paper §5, "Revisiting best-effort placement"):
    when no contiguous/folded placement exists, start the job anyway on
    scattered free XPUs with a contention slowdown — worthwhile whenever
    the slowdown costs less than the queueing delay. The slowdown factor
    defaults to ~1.5, between the paper's measured 1.35 (one contending
    neighbour) and 1.95 (doubled load) on TPU v2 (§3.1)."""

    name = "rfold_be"

    def __init__(self, num_xpus: int = 4096, cube_n: int = 4,
                 dedicate_chained: bool = False,
                 scatter_slowdown: float = 1.5,
                 fitmask_engine: Optional[str] = None,
                 engine=None, mask_client=None):
        super().__init__(num_xpus, cube_n,
                         dedicate_chained=dedicate_chained,
                         fitmask_engine=fitmask_engine,
                         engine=engine, mask_client=mask_client)
        self.scatter_slowdown = scatter_slowdown

    def empty_clone(self) -> "RFoldBestEffortPolicy":
        return RFoldBestEffortPolicy(
            self.cluster.num_xpus, self.cluster.cube_n,
            dedicate_chained=self.cluster.dedicate_chained,
            scatter_slowdown=self.scatter_slowdown,
            engine=self.cluster.engine_config)

    def _can_ever_place(self, shape: JobShape) -> bool:
        if super()._can_ever_place(shape):
            return True
        if self.use_naive:
            return False  # the clone-based check already covered scatter
        # Scatter fallback on an empty cluster: every cell is free and
        # no cube is dedicated, so feasibility is just capacity.
        return shape.size <= self.num_xpus

    @obs.span("policy.place")
    def try_place(self, job_id: int, shape: JobShape) -> Optional[Placement]:
        p = super().try_place(job_id, shape)
        if p is not None:
            return p
        cells = self.cluster.free_cells(limit=shape.size)
        if len(cells) < shape.size:
            return None
        self.cluster.commit_scatter(job_id, cells)
        meta = dict(self.cluster.alloc_meta[job_id])
        meta["slowdown_factor"] = self.scatter_slowdown
        return Placement(job_id, shape, broken_rings=(0, 1, 2), meta=meta)


POLICIES = {
    "firstfit": FirstFitPolicy,
    "folding": FoldingPolicy,
    "reconfig": ReconfigPolicy,
    "rfold": RFoldPolicy,
    "rfold_be": RFoldBestEffortPolicy,
}


def make_policy(name: str, **kw) -> PlacementPolicy:
    return POLICIES[name](**kw)
