"""Free-box ("fit mask") search over an occupancy grid.

Given a bool occupancy grid and a box shape (a, b, c), compute for every
un-wrapped origin whether the a×b×c window is entirely free. This is the
allocator's hot spot: FirstFit, Folding and Reconfig all reduce to it.

Engine selection:
  * ``numpy`` (default here) — integral-image window sums; the simulator
    calls this thousands of times with *varying* box shapes, so a
    trace-free engine is the right choice on CPU.
  * ``repro_torch.kernels.fitmask`` — the CUDA kernel (one shared-memory
    integral image per grid, batched over grids) with a
    ``Tensor.unfold`` window-sum oracle; tests assert all engines agree.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from .geometry import Coord, Dims


def integral_image(occ: np.ndarray) -> np.ndarray:
    """3D integral image over the trailing axes: (..., X, Y, Z) ->
    int64 (..., X+1, Y+1, Z+1); leading axes (if any) are batch dims.

    ``ii[..., x, y, z]`` is the sum of ``occ[..., :x, :y, :z]``. Build
    it once per occupancy state and answer any number of box queries
    from it — this is the shared structure the allocator reuses across
    all fold-box queries within one placement step.
    """
    shape = occ.shape[:-3] + tuple(d + 1 for d in occ.shape[-3:])
    ii = np.zeros(shape, dtype=np.int64)
    ii[..., 1:, 1:, 1:] = occ.astype(np.int64)
    for ax in (-3, -2, -1):
        np.cumsum(ii, axis=ax, out=ii)
    return ii


def window_sums_from_ii(ii: np.ndarray, box: Dims) -> np.ndarray:
    """Window sums for every un-wrapped origin, from a precomputed
    (possibly batched) integral image (..., X+1, Y+1, Z+1). Empty along
    the window axes if the box does not fit at all."""
    a, b, c = box
    X, Y, Z = (d - 1 for d in ii.shape[-3:])
    if a > X or b > Y or c > Z:
        return np.zeros(ii.shape[:-3] + (max(X - a + 1, 0),
                                         max(Y - b + 1, 0),
                                         max(Z - c + 1, 0)), dtype=np.int64)
    s = (ii[..., a:, b:, c:] - ii[..., :-a, b:, c:] - ii[..., a:, :-b, c:]
         - ii[..., a:, b:, :-c] + ii[..., :-a, :-b, c:]
         + ii[..., :-a, b:, :-c] + ii[..., a:, :-b, :-c]
         - ii[..., :-a, :-b, :-c])
    return s


def window_sums(occ: np.ndarray, box: Dims) -> np.ndarray:
    """Sum of ``occ`` over every un-wrapped a×b×c window.

    occ: bool/int array (X, Y, Z). Returns int array of shape
    (X-a+1, Y-b+1, Z-c+1); empty if the box does not fit at all.
    """
    a, b, c = box
    X, Y, Z = occ.shape
    if a > X or b > Y or c > Z:
        return np.zeros((max(X - a + 1, 0), max(Y - b + 1, 0),
                         max(Z - c + 1, 0)), dtype=np.int64)
    return window_sums_from_ii(integral_image(occ), box)


def batched_integral_image(occ: np.ndarray) -> np.ndarray:
    """Per-grid integral images for a batch: (B, X, Y, Z) bool/int ->
    (B, X+1, Y+1, Z+1) int64. One fused pass for all grids (e.g. all
    cubes of a reconfigurable torus)."""
    return integral_image(occ)


Slice3 = Tuple[Tuple[int, int], Tuple[int, int], Tuple[int, int]]


def block_sums_from_ii(ii: np.ndarray, local: Slice3) -> np.ndarray:
    """Occupied-cell count of the fixed sub-block ``local`` in every grid
    of a batched integral image (B, X+1, Y+1, Z+1) -> int64 (B,)."""
    (x0, x1), (y0, y1), (z0, z1) = local
    return (ii[:, x1, y1, z1] - ii[:, x0, y1, z1] - ii[:, x1, y0, z1]
            - ii[:, x1, y1, z0] + ii[:, x0, y0, z1] + ii[:, x0, y1, z0]
            + ii[:, x1, y0, z0] - ii[:, x0, y0, z0])


def block_free_from_ii(ii: np.ndarray, local: Slice3) -> np.ndarray:
    """Bool (B,): sub-block ``local`` entirely free in each grid."""
    return block_sums_from_ii(ii, local) == 0


def block_sums_from_ii_multi(ii: np.ndarray,
                             locals_: Sequence[Slice3]) -> np.ndarray:
    """Occupied-cell counts for L sub-blocks in every grid at once:
    batched integral image (B, X+1, Y+1, Z+1) x L locals -> int64
    (L, B). One fancy-indexed gather per integral-image corner replaces
    L separate :func:`block_sums_from_ii` calls. Part of the batched
    sub-block query surface; note the allocator's plan search instead
    consumes per-*shape* full-grid masks (``window_sums_from_ii``),
    which amortize better when many origins of few shapes are queried
    — this helper is the right form when the L sub-blocks have many
    distinct shapes."""
    lo = np.array([[s[0] for s in loc] for loc in locals_],
                  dtype=np.int64)                       # (L, 3)
    hi = np.array([[s[1] for s in loc] for loc in locals_],
                  dtype=np.int64)                       # (L, 3)
    x0, y0, z0 = lo[:, 0], lo[:, 1], lo[:, 2]
    x1, y1, z1 = hi[:, 0], hi[:, 1], hi[:, 2]
    iit = np.moveaxis(ii, 0, -1)                        # (X+1, Y+1, Z+1, B)
    return (iit[x1, y1, z1] - iit[x0, y1, z1] - iit[x1, y0, z1]
            - iit[x1, y1, z0] + iit[x0, y0, z1] + iit[x0, y1, z0]
            + iit[x1, y0, z0] - iit[x0, y0, z0])


def block_free_from_ii_multi(ii: np.ndarray,
                             locals_: Sequence[Slice3]) -> np.ndarray:
    """Bool (L, B): each of L sub-blocks entirely free in each grid."""
    return block_sums_from_ii_multi(ii, locals_) == 0


def free_counts(occ: np.ndarray) -> np.ndarray:
    """Free-cell count per grid: (B, X, Y, Z) bool/int -> (B,) int64.
    The host half of the engine ``free_counts`` contract
    (``repro_torch.kernels.fitmask.ops``)."""
    occ = np.asarray(occ)
    n3 = occ.shape[-3] * occ.shape[-2] * occ.shape[-1]
    return n3 - occ.reshape(occ.shape[0], -1).sum(axis=1).astype(np.int64)


def fit_mask(occ: np.ndarray, box: Dims) -> np.ndarray:
    """Bool mask over origins where the box fits in free space."""
    return window_sums(occ, box) == 0


def fit_mask_batched(occ: np.ndarray, box: Dims) -> np.ndarray:
    """Batched fit mask: (B, X, Y, Z) -> bool (B, X-a+1, Y-b+1, Z-c+1)
    via one shared batched integral image (no per-grid python loop)."""
    return window_sums_from_ii(integral_image(occ), box) == 0


def fit_mask_multi(occ: np.ndarray, boxes: Sequence[Dims]) -> np.ndarray:
    """All K candidate boxes from one shared batched integral image:
    (B, X, Y, Z) x K boxes -> (B, K, X, Y, Z) int32, each plane padded
    to the full grid (0 where the box overhangs or does not fit at
    all). Straight-line 8-corner arithmetic on an int64 integral
    image — the parity oracle for :func:`fit_mask_multi_fast` (which
    the numpy engine serves queries from) and for the CUDA multi-box
    kernel (``repro_torch.kernels.fitmask.kernel.fitmask_multibox``).
    """
    occ = np.asarray(occ)
    bsz = occ.shape[0]
    X, Y, Z = occ.shape[-3:]
    out = np.zeros((bsz, len(boxes), X, Y, Z), dtype=np.int32)
    if not boxes:
        return out
    ii = integral_image(occ)
    for k, box in enumerate(boxes):
        s = window_sums_from_ii(ii, box)
        if s.size:
            a, b, c = box
            out[:, k, :X - a + 1, :Y - b + 1, :Z - c + 1] = s == 0
    return out


def fit_mask_multi_fast(occ: np.ndarray, boxes: Sequence[Dims],
                        out_dtype=np.int32) -> Tuple[np.ndarray, np.ndarray]:
    """The batched-(B, K) production form of :func:`fit_mask_multi`:
    one narrow integral image stacked over all grids answers every
    candidate box, and the per-grid free counts fall out of the same
    pass for free.

    Returns ``(masks, free)``: masks is (B, K, X, Y, Z) ``out_dtype``
    (nonzero where the box fits, full-grid padded exactly like
    :func:`fit_mask_multi`), free is (B,) int64 free-cell counts.

    Two deliberate departures from the oracle, both exact:

    * the integral image is int16 whenever the cell volume fits
      (every cluster grid up to 31^3) — cumsums and window diffs are
      memory-bound, so halving the element width roughly halves the
      pass;
    * window sums use nested per-axis differencing (three
      subtractions, as the torch engine does) instead of 8-corner
      inclusion/exclusion, and each ``== 0`` writes straight into the
      padded output plane — no intermediate full-size temporaries.

    Parity with the oracle is property-tested in
    ``tests/test_fitmask_engines.py``.
    """
    occ = np.asarray(occ)
    bsz = occ.shape[0]
    X, Y, Z = occ.shape[-3:]
    out = np.zeros((bsz, len(boxes), X, Y, Z), dtype=out_dtype)
    vol = X * Y * Z
    dt = np.int16 if vol <= np.iinfo(np.int16).max else np.int64
    ii = np.zeros((bsz, X + 1, Y + 1, Z + 1), dtype=dt)
    ii[:, 1:, 1:, 1:] = occ
    for ax in (1, 2, 3):
        np.cumsum(ii, axis=ax, out=ii)
    for k, box in enumerate(boxes):
        a, b, c = (int(v) for v in box)
        if a > X or b > Y or c > Z:
            continue
        s = ii[:, a:, :, :] - ii[:, :-a, :, :]
        s = s[:, :, b:, :] - s[:, :, :-b, :]
        s = s[:, :, :, c:] - s[:, :, :, :-c]
        np.equal(s, 0, out=out[:, k, :X - a + 1, :Y - b + 1, :Z - c + 1],
                 casting="unsafe")
    free = vol - ii[:, -1, -1, -1].astype(np.int64)
    return out, free


def first_fit_origin(occ: np.ndarray, box: Dims) -> Optional[Coord]:
    """Lexicographically-first free origin, or None."""
    m = fit_mask(occ, box)
    if m.size == 0 or not m.any():
        return None
    flat = int(np.argmax(m))  # first True in C order == lexicographic
    return tuple(int(v) for v in np.unravel_index(flat, m.shape))  # type: ignore[return-value]


def count_fits(occ: np.ndarray, box: Dims) -> int:
    m = fit_mask(occ, box)
    return int(m.sum())
