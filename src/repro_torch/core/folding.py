"""Folding: homomorphic job-shape rewriting (the paper's §3.3).

A job's communication graph is the product of rings ``ring(d0) x ring(d1)
x ring(d2)``. A *fold* is an explicit injective mapping of that graph
into a target box such that every ring edge lands on a physical torus
link (possibly a wrap-around link, when the box spans a wrap-capable
extent). We implement the paper's constructions:

  * identity / rotation          (rotation is default policy behaviour)
  * 1D folding: ring(A) -> Hamiltonian cycle of any even-volume box
    (the 18x1x1 -> 2x9 example), or a full wrap line
  * 2D folding: ring(A) x ring(B) -> A kept on an axis, B folded onto a
    Hamiltonian cycle of a 2D sub-grid (the 1x6x4 -> 4x2x3 example)
  * 3D folding: (A, B, 2) -> (A, B/2, 4) via the paper's Y1'/Y2'
    wrap-around mapping (the 4x8x2 -> 4x4x4 example); requires B even
    and a wrap-capable doubled axis — the same rule that rejects the
    paper's impossibility example 4x8x3 -> 4x4x6.

Grid graphs are bipartite, so only even rings can be folded into cycles
(odd rings close only on full wrap lines) — a limitation the paper
acknowledges ("applicable to most jobs with even shape sizes").

Every fold carries its explicit mapping; ``verify_fold`` re-checks the
graph homomorphism edge by edge (this is our equivalent of the paper's
"invoke graph libraries to check for homomorphism", but constructive and
certifying).
"""
from __future__ import annotations

import functools
import itertools
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from .. import obs
from .geometry import (Coord, Dims, JobShape, factor_pairs, factorizations3,
                       hamiltonian_cycle_2d, hamiltonian_cycle_3d,
                       is_torus_neighbor, volume)

WrapFlags = Tuple[bool, bool, bool]


@dataclass(frozen=True)
class Fold:
    """An explicit embedding of ``job_dims`` rings into ``box``.

    job_dims      — ring lengths, as requested (normalized descending).
    box           — target allocation box (a, b, c).
    kind          — construction used.
    wrap_required — per *box axis*: the embedding uses that axis's
                    wrap-around link for some ring edge.
    mapping       — tuple indexed by flattened logical coordinate
                    (C-order over job_dims) of box-local coords.
    """

    job_dims: Dims
    box: Dims
    kind: str
    wrap_required: WrapFlags
    mapping: Tuple[Coord, ...]

    def embed(self, logical: Coord) -> Coord:
        d0, d1, d2 = self.job_dims
        i, j, k = logical
        return self.mapping[(i * d1 + j) * d2 + k]

    @property
    def num_xpus(self) -> int:
        return volume(self.job_dims)

    def __str__(self) -> str:  # pragma: no cover - cosmetic
        return (f"{'x'.join(map(str, self.job_dims))}->"
                f"{'x'.join(map(str, self.box))}[{self.kind}]")


def _logical_coords(job_dims: Dims) -> List[Coord]:
    d0, d1, d2 = job_dims
    return [(i, j, k) for i in range(d0) for j in range(d1) for k in range(d2)]


def ring_edges(job_dims: Dims) -> List[Tuple[Coord, Coord, int]]:
    """All ring edges (u, v, axis) of the product-of-rings comm graph.

    A dim of size 1 has no edges; size 2 has a single edge (one duplex
    link); size >= 3 has d edges including the closing one.
    """
    edges = []
    d = list(job_dims)
    for (i, j, k) in _logical_coords(job_dims):
        u = (i, j, k)
        for ax in range(3):
            if d[ax] < 2:
                continue
            nxt = list(u)
            nxt[ax] = (u[ax] + 1) % d[ax]
            v = (nxt[0], nxt[1], nxt[2])
            if d[ax] == 2 and u[ax] == 1:
                continue  # avoid duplicating the single edge of a 2-ring
            edges.append((u, v, ax))
    return edges


def verify_fold(fold: Fold, wrap_available: WrapFlags) -> Tuple[bool, List[int]]:
    """Memoized per fold instance (folds are immutable). Each call is
    a ``folding.lookups``, each one computed a ``folding.misses``
    (repro_torch.obs), as for :func:`enumerate_folds`."""
    obs.count("folding.lookups")
    cache = getattr(fold, "_verify_cache", None)
    if cache is None:
        cache = {}
        object.__setattr__(fold, "_verify_cache", cache)
    key = tuple(wrap_available)
    hit = cache.get(key)
    if hit is None:
        obs.count("folding.misses")
        hit = _verify_fold_impl(fold, wrap_available)
        cache[key] = hit
    return hit


@obs.span("folding.verify")
def _verify_fold_impl(fold: Fold,
                      wrap_available: WrapFlags) -> Tuple[bool, List[int]]:
    """Certify the fold as a ring-product embedding (vectorized).

    Returns (mapping_valid, broken_ring_axes). ``mapping_valid`` means
    injective, in-bounds, and every ring edge maps to a physical link
    given ``wrap_available`` (per box axis). Ring axes whose closing
    edge fails only due to missing wrap are reported broken (the fold is
    then only usable by policies that tolerate broken rings).

    All ring edges of one job axis are checked as a single numpy batch
    (``np.roll`` of the C-order index grid gives the +1-mod-d neighbour
    of every logical node at once); the per-edge python loop survives as
    :func:`_verify_fold_reference`, the parity oracle.
    """
    d = fold.job_dims
    V = d[0] * d[1] * d[2]
    coords = np.asarray(fold.mapping, dtype=np.int64)  # (V, 3), C-order
    box = np.asarray(fold.box, dtype=np.int64)
    if (coords < 0).any() or (coords >= box[None, :]).any():
        return False, []
    flat = (coords[:, 0] * box[1] + coords[:, 1]) * box[2] + coords[:, 2]
    if np.unique(flat).size != V:
        return False, []
    broken: set[int] = set()
    idx = np.arange(V).reshape(d)
    for ax in range(3):
        if d[ax] < 2:
            continue
        iu, iv = idx, np.roll(idx, -1, axis=ax)  # v = u+1 (mod d[ax])
        if d[ax] == 2:
            # a 2-ring is a single duplex link: keep only the u[ax]==0 edge
            sel = [slice(None)] * 3
            sel[ax] = slice(0, 1)
            iu, iv = iu[tuple(sel)], iv[tuple(sel)]
        ad = np.abs(coords[iu.ravel()] - coords[iv.ravel()])  # (E, 3)
        # sorted(deltas) == [0, 0, 1]  <=>  sum(deltas) == 1  (non-neg ints)
        dw = ad.copy()
        for k in range(3):
            if wrap_available[k]:
                dw[:, k] = np.minimum(ad[:, k], box[k] - ad[:, k])
        ok = dw.sum(axis=1) == 1            # link given available wrap
        if ok.all():
            continue
        full = np.minimum(ad, box[None, :] - ad).sum(axis=1) == 1
        if (~ok & ~full).any():
            return False, []                # not a link at all
        broken.add(ax)                      # closes only through missing wrap
    return True, sorted(broken)


def _verify_fold_reference(fold: Fold,
                           wrap_available: WrapFlags) -> Tuple[bool, List[int]]:
    """Edge-by-edge reference implementation of ``_verify_fold_impl``
    (kept as the parity oracle for the vectorized certifier)."""
    coords = [fold.embed(l) for l in _logical_coords(fold.job_dims)]
    if len(set(coords)) != len(coords):
        return False, []
    for c in coords:
        if any(v < 0 or v >= s for v, s in zip(c, fold.box)):
            return False, []
    broken: set[int] = set()
    nowrap: WrapFlags = (False, False, False)
    for (u, v, ax) in ring_edges(fold.job_dims):
        eu, ev = fold.embed(u), fold.embed(v)
        if is_torus_neighbor(eu, ev, fold.box, nowrap):
            continue
        if is_torus_neighbor(eu, ev, fold.box, wrap_available):
            continue
        if is_torus_neighbor(eu, ev, fold.box, (True, True, True)):
            broken.add(ax)  # needs a wrap link that is not available
        else:
            return False, []  # not a link at all: invalid homomorphism
    return True, sorted(broken)


def ring_edge_index(job_dims: Dims) -> Tuple[np.ndarray, np.ndarray]:
    """:func:`ring_edges` as flat C-order node indices ``(iu, iv)``, in
    the same order: by the node ``u``, then by axis."""
    n = volume(job_dims)
    idx = np.arange(n).reshape(job_dims)
    nxt = np.empty((n, 3), dtype=np.int64)
    keep = np.zeros((n, 3), dtype=bool)
    for ax, d in enumerate(job_dims):
        if d < 2:
            continue
        nxt[:, ax] = np.roll(idx, -1, axis=ax).ravel()  # v = u+1 (mod d)
        if d == 2:
            # a 2-ring is a single duplex link: keep only the u[ax]==0 edge
            first = np.zeros(job_dims, dtype=bool)
            first[(slice(None),) * ax + (0,)] = True
            keep[:, ax] = first.ravel()
        else:
            keep[:, ax] = True
    return np.nonzero(keep)[0], nxt[keep]


def fold_links(fold: Fold, origin: Coord,
               torus_dims: Dims) -> List[Tuple[Coord, Coord]]:
    """Physical links used by the fold placed at ``origin``. Wrap edges
    connect the two box faces; they are physical only when the box spans
    the full wrap extent (callers check wrap availability separately)."""
    iu, iv = ring_edge_index(fold.job_dims)
    placed = np.asarray(fold.mapping, dtype=np.int64) + \
        np.asarray(origin, dtype=np.int64)
    return list(zip(map(tuple, placed[iu].tolist()),
                    map(tuple, placed[iv].tolist())))


# ----------------------------------------------------------------------
# Constructions
# ----------------------------------------------------------------------

def _identity_folds(job_dims: Dims) -> List[Fold]:
    """All axis rotations of the original shape."""
    folds = []
    logical = np.indices(job_dims).reshape(3, -1).T  # (V, 3), C-order
    for perm in set(itertools.permutations((0, 1, 2))):
        box = tuple(job_dims[perm.index(ax)] for ax in range(3))
        # logical axis a sits on box axis perm[a]
        c = np.empty_like(logical)
        for a in range(3):
            c[:, perm[a]] = logical[:, a]
        mapping = [tuple(row) for row in c.tolist()]
        wrap_req = [False, False, False]
        for a in range(3):
            if job_dims[a] > 2:
                wrap_req[perm[a]] = True  # ring closure needs wrap
        folds.append(Fold(job_dims, box, "identity",  # type: ignore[arg-type]
                          tuple(wrap_req), tuple(mapping)))
    # Dedup identical boxes+mapping signatures.
    uniq: Dict[Tuple, Fold] = {}
    for f in folds:
        uniq.setdefault((f.box, f.mapping), f)
    return list(uniq.values())


def _cycle_boxes(length: int, max_dim: Optional[int]) -> List[Dims]:
    """Boxes that admit a Hamiltonian cycle of exactly ``length`` nodes:
    even volume, at most one dim == 1."""
    if length % 2 or length < 4:
        return []
    out = []
    for box in factorizations3(length, max_dim):
        if sum(1 for d in box if d == 1) >= 2:
            continue
        out.append(box)
    return out


def _box_cycle(box: Dims) -> Tuple[Coord, ...]:
    return hamiltonian_cycle_3d(box)


def _fold_1d(job_dims: Dims, max_dim: Optional[int]) -> List[Fold]:
    """ring(A) -> Hamiltonian cycle of an even-volume box."""
    A = job_dims[0]
    folds = []
    for box in _cycle_boxes(A, max_dim):
        cyc = _box_cycle(box)
        folds.append(Fold(job_dims, box, "cycle1d",
                          (False, False, False), tuple(cyc)))
    return folds


def _fold_2d(job_dims: Dims, max_dim: Optional[int]) -> List[Fold]:
    """ring(A) x ring(B): keep one ring on an axis, fold the other onto
    a Hamiltonian cycle of a 2D grid spanning the remaining two axes."""
    A, B = job_dims[0], job_dims[1]
    folds = []
    for keep_first, (keep, foldd) in ((True, (A, B)), (False, (B, A))):
        if foldd % 2 or foldd < 4:
            continue
        for (b1, b2) in factor_pairs(foldd, max_dim):
            if b1 < 2 or b2 < 2:
                continue
            if max_dim is not None and keep > max_dim:
                continue
            cyc = hamiltonian_cycle_2d(b1, b2)
            box = (keep, b1, b2)
            mapping = []
            # logical order is C-order over (A, B, 1)
            if keep_first:
                for i in range(A):
                    for j in range(B):
                        y, z = cyc[j]
                        mapping.append((i, y, z))
            else:
                for i in range(A):
                    for j in range(B):
                        y, z = cyc[i]
                        mapping.append((j, y, z))
            wrap_req = (keep > 2, False, False)
            folds.append(Fold(job_dims, box, "ring_x_ham", wrap_req,
                              tuple(mapping)))
    return folds


def _fold_3d_halving(job_dims: Dims) -> List[Fold]:
    """(A, B, 2) -> (A, B/2, 4): the paper's constructive 3D fold.

    Mapping (x, y, z): y < B/2 -> (x, y, z); else (x, B-1-y, 3-z).
    The B-ring's two crossing edges land on the doubled axis's
    wrap-around link (Y1' in the paper), so wrap there is REQUIRED —
    which is exactly why 4x8x3 -> 4x4x6 is rejected (6 is not a
    wrap-capable extent at 4-cube granularity, and the middle layer has
    no cycle image).
    """
    folds = []
    for perm in set(itertools.permutations((0, 1, 2))):
        dims = tuple(job_dims[p] for p in perm)  # treat as (A, B, C)
        A, B, C = dims
        if C != 2 or B % 2 or B < 4:
            continue
        box = (A, B // 2, 4)
        # mapping from the *original* logical axes (i over job_dims[0]..)
        mapping = []
        d0, d1, d2 = job_dims
        for l in _logical_coords(job_dims):
            x, y, z = (l[perm[0]], l[perm[1]], l[perm[2]])
            if y < B // 2:
                c = (x, y, z)
            else:
                c = (x, B - 1 - y, 3 - z)
            mapping.append(c)
        folds.append(Fold(job_dims, box, "halving3d",
                          (A > 2, False, True), tuple(mapping)))
    return folds


def enumerate_folds(shape: JobShape, max_dim: Optional[int] = None,
                    include_identity: bool = True) -> List[Fold]:
    """All fold candidates for a job shape, most-structured first.

    ``max_dim`` bounds any box dimension (e.g. the torus extent, or the
    largest chainable cube extent for a reconfigurable torus).
    Memoized: fold construction (Hamiltonian cycles over up to 4096
    nodes) dominates allocator cost otherwise. Each call is a
    ``folding.lookups``; a construction is a ``folding.misses`` and the
    span ``folding.enumerate`` (repro_torch.obs).
    """
    obs.count("folding.lookups")
    dims = tuple(sorted(shape.dims, reverse=True))
    return list(_enumerate_folds_cached(dims, max_dim, include_identity))


@functools.lru_cache(maxsize=4096)
@obs.span("folding.enumerate")
def _enumerate_folds_cached(dims: Dims, max_dim: Optional[int],
                            include_identity: bool) -> Tuple[Fold, ...]:
    obs.count("folding.misses")
    shape = JobShape(dims)
    nd = shape.ndim
    folds: List[Fold] = []
    if include_identity:
        folds.extend(_identity_folds(dims))
    if nd == 1:
        folds.extend(_fold_1d(dims, max_dim))
    elif nd == 2:
        folds.extend(_fold_2d(dims, max_dim))
        # a 2-ring in the third slot also admits the halving fold
        folds.extend(_fold_3d_halving(dims))
    else:
        folds.extend(_fold_3d_halving(dims))
    if max_dim is not None:
        folds = [f for f in folds if max(f.box) <= max_dim]
    # Dedup by (box, mapping).
    uniq: Dict[Tuple, Fold] = {}
    for f in folds:
        uniq.setdefault((f.box, f.mapping), f)
    return tuple(uniq.values())
