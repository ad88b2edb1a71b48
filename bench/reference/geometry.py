"""Shape / coordinate algebra for 3D torus placement.

Everything here is plain-Python combinatorics used by the allocator; the
hot numeric path (free-box search over the occupancy grid) lives in
:mod:`repro_torch.kernels.fitmask` and is wrapped by :mod:`repro_torch.core.torus`.
"""
from __future__ import annotations

import functools
import itertools
from dataclasses import dataclass
from typing import Iterator, Sequence, Tuple

Coord = Tuple[int, int, int]
Dims = Tuple[int, int, int]


def volume(dims: Sequence[int]) -> int:
    out = 1
    for d in dims:
        out *= int(d)
    return out


def canonical(dims: Sequence[int]) -> Dims:
    """Sorted-descending canonical form of a shape (rotation class)."""
    a, b, c = sorted((int(d) for d in dims), reverse=True)
    return (a, b, c)


def rotations(dims: Sequence[int]) -> Tuple[Dims, ...]:
    """All distinct axis permutations (the paper treats rotation as a
    default behaviour of every placement policy, not as folding)."""
    seen = []
    for perm in itertools.permutations(tuple(int(d) for d in dims)):
        if perm not in seen:
            seen.append(perm)
    return tuple(seen)


def factorizations3(n: int, max_dim: int | None = None) -> Tuple[Dims, ...]:
    """All ordered (a, b, c) with a*b*c == n (optionally bounded)."""
    n = int(n)
    out = []
    for a in range(1, n + 1):
        if n % a:
            continue
        if max_dim is not None and a > max_dim:
            continue
        m = n // a
        for b in range(1, m + 1):
            if m % b:
                continue
            c = m // b
            if max_dim is not None and (b > max_dim or c > max_dim):
                continue
            out.append((a, b, c))
    return tuple(out)


def factor_pairs(n: int, max_dim: int | None = None) -> Tuple[Tuple[int, int], ...]:
    """All ordered (a, b) with a*b == n."""
    n = int(n)
    out = []
    for a in range(1, n + 1):
        if n % a:
            continue
        b = n // a
        if max_dim is not None and (a > max_dim or b > max_dim):
            continue
        out.append((a, b))
    return tuple(out)


def iter_box(origin: Coord, dims: Dims) -> Iterator[Coord]:
    ox, oy, oz = origin
    a, b, c = dims
    for x in range(a):
        for y in range(b):
            for z in range(c):
                yield (ox + x, oy + y, oz + z)


def wrap_coord(coord: Coord, torus_dims: Dims) -> Coord:
    return tuple(c % d for c, d in zip(coord, torus_dims))  # type: ignore[return-value]


def torus_delta(a: int, b: int, size: int, wrap: bool) -> int:
    """Minimal |a-b| along one axis, honouring wrap-around when present."""
    d = abs(a - b)
    if wrap:
        d = min(d, size - d)
    return d


def is_torus_neighbor(u: Coord, v: Coord, dims: Dims,
                      wrap: Tuple[bool, bool, bool]) -> bool:
    """True iff u and v are joined by a single torus link."""
    deltas = [torus_delta(a, b, s, w)
              for a, b, s, w in zip(u, v, dims, wrap)]
    return sorted(deltas) == [0, 0, 1]


@dataclass(frozen=True)
class JobShape:
    """A job's communication shape: product of rings of sizes dims.

    ``dims`` follows the paper's convention: ``4x6x1`` = four-way DP ×
    six-way TP. The number of dims > 1 classifies the job as 1D/2D/3D.
    """

    dims: Dims

    def __post_init__(self) -> None:
        if len(self.dims) != 3 or any(d < 1 for d in self.dims):
            raise ValueError(f"bad shape {self.dims}")

    @property
    def size(self) -> int:
        return volume(self.dims)

    @property
    def ndim(self) -> int:
        """1D/2D/3D classification per the paper (dims of size > 1)."""
        return max(1, sum(1 for d in self.dims if d > 1))

    @property
    def active_dims(self) -> Tuple[int, ...]:
        """Ring lengths > 1, descending (the communicating dimensions)."""
        act = tuple(sorted((d for d in self.dims if d > 1), reverse=True))
        return act if act else (1,)

    def rotations(self) -> Tuple[Dims, ...]:
        return rotations(self.dims)

    def __str__(self) -> str:  # pragma: no cover - cosmetic
        return "x".join(str(d) for d in self.dims)


def snake_order(dims2: Tuple[int, int]) -> Tuple[Tuple[int, int], ...]:
    """Boustrophedon order over an a×b grid (used by Hamiltonian cycles)."""
    a, b = dims2
    out = []
    for i in range(a):
        cols = range(b) if i % 2 == 0 else range(b - 1, -1, -1)
        for j in cols:
            out.append((i, j))
    return tuple(out)


@functools.lru_cache(maxsize=None)
def hamiltonian_cycle_2d(a: int, b: int) -> Tuple[Tuple[int, int], ...]:
    """Hamiltonian cycle of the a×b grid graph (requires a*b even,
    a, b >= 2). Returned as an ordered tuple of (i, j); consecutive
    entries (and last→first) are grid neighbours.

    Construction: pin column 0 as the "return rail"; snake through
    columns 1..b-1 across all rows, then come home down column 0.
    Needs ``a`` even when snaking rows (each row contributes one cell to
    the rail). We orient so the even dimension does the snaking.
    """
    if a < 2 or b < 2:
        raise ValueError("grid must be at least 2x2")
    if (a * b) % 2:
        raise ValueError("grid graphs are bipartite: no odd Hamiltonian cycle")
    if a % 2 == 0:
        # Snake rows over columns 1..b-1, rail = column 0.
        cyc = []
        for i in range(a):
            cols = range(1, b) if i % 2 == 0 else range(b - 1, 0, -1)
            for j in cols:
                cyc.append((i, j))
        for i in range(a - 1, -1, -1):
            cyc.append((i, 0))
        return tuple(cyc)
    # a odd => b must be even; transpose.
    cyc_t = hamiltonian_cycle_2d(b, a)
    return tuple((j, i) for (i, j) in cyc_t)


def hamiltonian_path_2d(b: int, c: int) -> Tuple[Tuple[int, int], ...]:
    """Row-major snake: Hamiltonian *path* of the b×c grid, any b,c >= 1,
    starting at (0, 0)."""
    return tuple(
        (i, j)
        for i in range(b)
        for j in (range(c) if i % 2 == 0 else range(c - 1, -1, -1))
    )


@functools.lru_cache(maxsize=None)
def hamiltonian_cycle_3d(dims: Dims) -> Tuple[Coord, ...]:
    """Hamiltonian cycle of an a×b×c box grid (even volume; at least two
    dims >= 2).

    Construction: orient so the X dimension is even; pair X-layers into
    2-layer slabs. Each slab 2×b×c is the prism over the b×c grid, which
    has a Hamiltonian cycle (snake path out on the lower layer, back on
    the upper). Adjacent slab cycles are then merged with a ladder-rung
    edge swap, yielding one cycle — valid for every even-volume box.
    """
    a, b, c = dims
    ones = sum(1 for d in dims if d == 1)
    if ones >= 2:
        raise ValueError("need at least a 2D box for a cycle")
    if (a * b * c) % 2:
        raise ValueError("odd volume: bipartite grid has no odd cycle")
    if ones == 1:
        # Degenerate to 2D in the plane of the non-1 dims.
        if a == 1:
            return tuple((0, i, j) for i, j in hamiltonian_cycle_2d(b, c))
        if b == 1:
            return tuple((i, 0, j) for i, j in hamiltonian_cycle_2d(a, c))
        return tuple((i, j, 0) for i, j in hamiltonian_cycle_2d(a, b))
    # Orient so the X dimension is even (always possible: volume even).
    if a % 2 == 0:
        pass
    elif b % 2 == 0:
        return tuple((x, y, z) for (y, x, z) in hamiltonian_cycle_3d((b, a, c)))
    else:
        return tuple((x, y, z) for (z, y, x) in hamiltonian_cycle_3d((c, b, a)))

    snake = hamiltonian_path_2d(b, c)  # S[0] == (0, 0), S[1] == (0, 1)
    # Adjacency map: vertex -> set of its two cycle neighbours.
    adj: dict[Coord, set[Coord]] = {}

    def _add_cycle(verts: Sequence[Coord]) -> None:
        n = len(verts)
        for i, v in enumerate(verts):
            adj.setdefault(v, set()).add(verts[(i + 1) % n])
            adj.setdefault(verts[(i + 1) % n], set()).add(v)

    def _swap(u1: Coord, v1: Coord, u2: Coord, v2: Coord) -> None:
        """Replace cycle edges (u1,v1),(u2,v2) with rungs (u1,u2),(v1,v2)."""
        adj[u1].remove(v1); adj[v1].remove(u1)
        adj[u2].remove(v2); adj[v2].remove(u2)
        adj[u1].add(u2); adj[u2].add(u1)
        adj[v1].add(v2); adj[v2].add(v1)

    for t in range(a // 2):
        lo, hi = 2 * t, 2 * t + 1
        slab = [(lo, y, z) for (y, z) in snake] + \
               [(hi, y, z) for (y, z) in reversed(snake)]
        _add_cycle(slab)
    for t in range(a // 2 - 1):
        # Merge slab t and t+1 via the rung at snake[0]/snake[1]: the
        # top layer of slab t traverses ...S[1],S[0] and the bottom
        # layer of slab t+1 traverses S[0],S[1]... — both are cycle
        # edges, and the two vertical links between the layers exist.
        (y0, z0), (y1, z1) = snake[0], snake[1]
        _swap((2 * t + 1, y0, z0), (2 * t + 1, y1, z1),
              (2 * t + 2, y0, z0), (2 * t + 2, y1, z1))
    # Walk the merged cycle.
    start: Coord = (0, 0, 0)
    cyc = [start]
    prev, cur = None, start
    while True:
        nxts = [n for n in adj[cur] if n != prev]
        nxt = nxts[0]
        if nxt == start:
            break
        cyc.append(nxt)
        prev, cur = cur, nxt
    if len(cyc) != a * b * c:
        raise AssertionError("cycle merge failed to cover the box")
    return tuple(cyc)


def cycle_is_valid(cycle: Sequence[Coord], dims: Dims,
                   wrap: Tuple[bool, bool, bool] = (False, False, False)) -> bool:
    """Check consecutive (and closing) entries are torus neighbours and
    all entries distinct."""
    n = len(cycle)
    if n < 2:
        return False
    if len(set(cycle)) != n:
        return False
    if n == 2:  # 2-ring = one duplex link
        return is_torus_neighbor(cycle[0], cycle[1], dims, wrap)
    return all(
        is_torus_neighbor(cycle[i], cycle[(i + 1) % n], dims, wrap)
        for i in range(n)
    )
