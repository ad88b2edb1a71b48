"""Free-box search ("fitmask") as hand-written CUDA kernels for Hopper.

For every origin of an occupancy grid: is the (a, b, c) window entirely
free? Four wrappers, each beside its plain PyTorch version and with a
launch counter (``<wrapper>.launches``, a plain int bumped once per
kernel launch and nowhere else):

* :func:`fitmask_multibox` — all K candidate boxes of a placement step
  in one launch. Replaces the Pallas kernel
  ``repro/kernels/fitmask/kernel.py::fitmask_multibox``
  (``_fitmask_multibox_kernel``).
* :func:`fitmask_batched` — one box; a launch of the same CUDA kernel
  with a one-row box table. Replaces ``fitmask_batched``
  (``_fitmask_kernel``).
* :func:`occupancy_counts` — occupied cells per grid. Replaces
  ``occupancy_counts`` (``_occupancy_counts_kernel``).
* :func:`fitmask_multibox_bucketed` — bool planes of all K boxes and
  the occupied counts in one launch of the multi-box kernel: the fleet
  broker's flush, as ``repro``'s ``JaxEngine._bucket_fn`` answers it
  (``repro/kernels/fitmask/ops.py``).

:func:`fitmask_multibox_singlepass_baseline` is no kernel of its own:
K launches of :func:`fitmask_batched` (each counted there), stacked —
the design from before the multi-box kernel, kept as the baseline that
``benchmarks_torch/fitmask_bench.py`` times K1 against, as ``repro``'s
function of that name is for its bench.

A wrapper takes its plain version only for a tensor on the CPU. For a
CUDA tensor it launches the kernel or raises; nothing falls back. The
host's part of a launch (plan, box table on the card, output allocation,
the call through ctypes) is the span ``fitmask.launch``
(``repro_torch.obs``). The kernels are CUDA C++ in
``repro_torch/csrc/fitmask.cu``, compiled with
``nvcc`` for ``sm_90a`` into ``build/repro_torch/`` at first use (by
:func:`repro_torch.kernels._build.build`) and bound with ctypes.

Bound on an H100 SXM: ``fitmask_multibox`` reads B·X·Y·Z bool cells and
writes B·K·X·Y·Z int32 cells, about 4 bytes per output cell over
3.35 TB/s against a few integer operations, so it is bound by bytes; at
the placement loop's smallest shapes (one 16³ grid, one box) the card's
time for one launch is the floor. The kernel keeps each (x, y) row of a
grid as one 64-bit word of occupancy bits in shared memory (a 16³ grid
is 2 KB) and answers a box from the OR of the a·b row words it covers,
shifted along z by doubling: one barrier after the load, and every
output plane stored as consecutive 16-byte chunks.
:func:`launch_plan` cuts the (grid, box, x, y) items into blocks and
checks the limit: Z ≤ 64 (a row is one word) and one grid's row words
with a block's staging words within a block's shared memory.
``occupancy_counts`` reads each cell once and writes one int32 per grid;
:func:`counts_plan` sizes its launch from (B, n): a power of two of
lanes up to a warp a grid for small grids, a cluster of up to eight
blocks a grid for large ones.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ... import obs
from .._build import (SMEM_LIMIT_BYTES, Library, count_launch, load_once,
                      stream_of)

Box = Tuple[int, int, int]

SOURCE = "fitmask.cu"                 # in repro_torch/csrc

# Threads a block, one item a thread: 256, or 128 where 256 already
# gives a block to each of the H100's 132 SMs or where a grid has fewer
# than 128 rows (smaller blocks then spread the same work over more
# SMs; a 16^3 grid's 256 rows are loaded best by 256 threads at once).
THREADS = 256
_SMS = 132
# Largest row along z: one row of the grid is one 64-bit word.
MAX_Z = 64
# How an item ORs the a x b row words its box covers (csrc/fitmask.cu's
# OrMode): a * b loads; a loads, a barrier and b loads through shared
# memory; a loads and b along y across the lanes of a warp, where a warp
# holds whole rows of items (32 % Y == 0).
OR_MODES = ("direct", "staged", "shuffle")
# Boxes of at most this many rows take the direct OR where the shuffle
# does not apply: there it beats the staged OR's extra barrier.
_DIRECT_ROWS = 16
# occupancy_counts: the loads a thread is sized for (and the most it
# issues at once), and the most blocks a grid may take (a thread-block
# cluster; eight is the portable limit).
COUNT_LOADS = 8
MAX_CLUSTER = 8
# Shared memory the bucketed launch keeps ahead of the row words (one
# int a warp: csrc/fitmask.cu's kCountBytes).
COUNT_SMEM = 4 * THREADS // 32
_INT_MAX = 2**31 - 1


class Plan(NamedTuple):
    """How one multi-box launch cuts its work. The items are the
    (grid, box, x, y) rows of the output, in its order; a unit is the Y
    items of one (grid, box, x). A block takes ``gpb`` whole grids (when
    a grid has fewer than ``upb`` units) or ``upb`` units of one grid;
    ``bpg`` blocks share a group of grids, and the launch is a
    ``bpg`` × ceil(B / ``gpb``) grid of blocks."""
    threads: int
    gpb: int
    bpg: int
    upb: int
    blocks: int
    smem: int
    mode: str


def check_grid(dims: Sequence[int]) -> int:
    """Shared-memory bytes the kernel may need for a grid of these
    dimensions: its X·Y 64-bit row words and two staging words for each
    item of the largest block. Raises ``ValueError`` when Z exceeds 64
    (a row is one word) or when that exceeds what one block can use."""
    x, y, z = (int(d) for d in dims)
    if z > MAX_Z:
        raise ValueError(
            f"grid {x}x{y}x{z}: the kernel keeps each (x, y) row as one "
            f"64-bit word, so Z must be at most {MAX_Z}")
    smem = 8 * x * y + 16 * max(THREADS, y)
    if smem > SMEM_LIMIT_BYTES:
        raise ValueError(
            f"grid {x}x{y}x{z}: its row words and a block's staging words "
            f"need {smem} bytes of shared memory; a block holds at most "
            f"{SMEM_LIMIT_BYTES}")
    return smem


def launch_plan(bsz: int, x: int, y: int, z: int, table: np.ndarray,
                mode: str = "") -> Plan:
    """Blocks and shared memory for B grids of X×Y×Z and the (K, 3) box
    ``table``, with the OR ``mode``. By default: ``shuffle`` where
    32 % Y == 0; elsewhere ``direct`` when no box that fits covers more
    than 16 rows (a·b), else ``staged``. Raises ``ValueError`` beyond
    :func:`check_grid`'s limit."""
    check_grid((x, y, z))
    k = len(table)
    if not mode and 32 % y == 0:
        mode = "shuffle"
    elif not mode:
        rows = [a * b for a, b, _ in table.tolist() if a <= x and b <= y]
        mode = "direct" if max(rows, default=0) <= _DIRECT_ROWS else "staged"
    if mode == "shuffle" and 32 % y:
        raise ValueError(f"the shuffle OR needs 32 % Y == 0, got Y = {y}")
    kx = k * x
    if kx >= 1 << 23:    # the kernel's float-reciprocal division
        raise ValueError(f"K * X = {kx} (K {k}, X {x}): one launch takes "
                         f"K * X below 2^23")

    def plan(threads):
        upb = max(1, threads // y)
        gpb = max(1, upb // kx)
        bpg = 1 if gpb > 1 else -(-kx // upb)
        items = min(upb, gpb * kx) * y
        smem = 8 * (gpb * x * y + (2 if mode == "staged" else 1) * items)
        return Plan(threads, gpb, bpg, upb, -(-bsz // gpb) * bpg, smem, mode)

    p = plan(THREADS)
    if p.blocks >= _SMS or x * y < THREADS // 2:
        p = plan(THREADS // 2)
    if p.blocks // p.bpg > 65535:   # the launch's second grid dimension
        raise ValueError(f"B = {bsz} grids of {x}x{y}x{z} with K {k}: "
                         f"{p.blocks // p.bpg} groups of grids, at most "
                         f"65535 a launch")
    return p


class CountPlan(NamedTuple):
    """How one ``occupancy_counts`` launch cuts B grids of n bytes. Each
    thread reads ``vec`` bytes a load (the widest of 16, 8, 4, 2, 1 that
    divides n and the address), ``batch`` loads at a time (1, 2, 4 or 8:
    the loads it has, up to 8). With ``cluster`` 0, ``lanes`` threads a
    grid (a power of two, at most 32) and ``blocks`` blocks of
    ``threads``; else ``cluster`` blocks of ``threads`` a grid, one
    thread-block cluster each, and ``blocks`` = B · ``cluster``."""
    vec: int
    batch: int
    lanes: int
    cluster: int
    threads: int
    blocks: int


def _pow2_at_least(v: int) -> int:
    return 1 << (max(v, 1) - 1).bit_length()


def counts_plan(bsz: int, n: int, addr: int = 0) -> CountPlan:
    """Threads for B grids of n bytes starting at ``addr``: a lane for
    each load, rounded up to a power of two, up to a warp a grid (which
    then has up to :data:`COUNT_LOADS` loads a lane); past that, blocks
    of 256 threads, as many a grid as leave each thread at most
    :data:`COUNT_LOADS` loads, up to :data:`MAX_CLUSTER` (a larger grid
    loops inside its cluster). More lanes with fewer loads each beat
    fewer lanes with batched loads at every small grid timed on an
    H100: shuffles cost less than the longer batch."""
    m = n | 16 | (addr & 15)
    vec = m & -m
    loads = n // vec
    if loads <= 32 * COUNT_LOADS:
        lanes = min(32, _pow2_at_least(loads))
        threads = min(THREADS, -(-bsz * lanes // 32) * 32)
        batch = min(COUNT_LOADS, _pow2_at_least(-(-loads // lanes)))
        plan = CountPlan(vec, batch, lanes, 0, threads,
                         -(-bsz * lanes // threads))
        work = bsz * lanes
    else:
        cluster = min(MAX_CLUSTER, -(-loads // (THREADS * COUNT_LOADS)))
        batch = min(COUNT_LOADS,
                    _pow2_at_least(-(-loads // (cluster * THREADS))))
        plan = CountPlan(vec, batch, 0, cluster, THREADS, bsz * cluster)
        work = plan.blocks
    if work > _INT_MAX or n > _INT_MAX:
        raise ValueError(f"B = {bsz} grids of {n} bytes: beyond one "
                         f"occupancy_counts launch")
    return plan


@load_once
def _lib() -> Library:
    p, i = ctypes.c_void_p, ctypes.c_int
    return Library(SOURCE, {
        "fitmask_multibox_launch": [p, p, p] + [i] * 11 + [p],
        "fitmask_multibox_bucketed_launch": [p, p, p, p] + [i] * 11 + [p],
        "occupancy_counts_launch": [p, p] + [i] * 8 + [p]})


# -- argument handling -------------------------------------------------

def box_table(boxes) -> np.ndarray:
    """Validate K (a, b, c) boxes into a (K, 3) int32 host array."""
    arr = np.asarray(boxes, dtype=np.int64).reshape(-1, 3)
    if (arr < 1).any():
        raise ValueError(f"box extents must be >= 1, got {arr.tolist()}")
    return arr.astype(np.int32)


def _cuda_occ(occ: torch.Tensor) -> torch.Tensor:
    if occ.device.type != "cuda":
        raise ValueError(f"fitmask kernels take CPU or CUDA tensors, "
                         f"got {occ.device}")
    if occ.dtype != torch.bool or occ.dim() != 4 or not occ.is_contiguous():
        raise ValueError("the CUDA fitmask kernels take a contiguous "
                         f"(B, X, Y, Z) bool tensor, got {occ.dtype} "
                         f"{tuple(occ.shape)}")
    return occ


@functools.lru_cache(maxsize=256)
def _device_boxes(table: bytes, device: torch.device) -> torch.Tensor:
    """The (K, 3) int32 box table on the card, uploaded once per distinct
    table: a pageable upload would block the host on every launch."""
    return torch.frombuffer(bytearray(table), dtype=torch.int32).reshape(
        -1, 3).to(device)


def _launch_multibox(occ: torch.Tensor, table: np.ndarray,
                     plan: Plan = None) -> torch.Tensor:
    bsz, x, y, z = occ.shape
    k = len(table)
    out = torch.empty((bsz, k, x, y, z), dtype=torch.int32, device=occ.device)
    if k == 0 or out.numel() == 0:
        return out
    plan = plan or launch_plan(bsz, x, y, z, table)
    boxes = _device_boxes(table.tobytes(), occ.device)
    _lib().launch(
        "fitmask_multibox_launch", occ.data_ptr(), boxes.data_ptr(),
        out.data_ptr(), bsz, x, y, z, k, plan.gpb, plan.bpg, plan.upb,
        plan.threads, plan.smem, OR_MODES.index(plan.mode),
        stream_of(occ), context=f"B {bsz}, grid {x}x{y}x{z}, K {k}")
    return out


def _launch_bucketed(occ: torch.Tensor, table: np.ndarray):
    """Bool planes and int32 counts from one launch; K >= 1 and a
    nonempty output."""
    bsz, x, y, z = occ.shape
    k = len(table)
    planes = torch.empty((bsz, k, x, y, z), dtype=torch.bool,
                         device=occ.device)
    counts = torch.empty((bsz,), dtype=torch.int32, device=occ.device)
    plan = launch_plan(bsz, x, y, z, table)
    smem = plan.smem + COUNT_SMEM
    if smem > SMEM_LIMIT_BYTES:
        raise ValueError(f"grid {x}x{y}x{z}: the bucketed launch needs "
                         f"{smem} bytes of shared memory; a block holds at "
                         f"most {SMEM_LIMIT_BYTES}")
    boxes = _device_boxes(table.tobytes(), occ.device)
    _lib().launch(
        "fitmask_multibox_bucketed_launch", occ.data_ptr(),
        boxes.data_ptr(), planes.data_ptr(), counts.data_ptr(), bsz, x, y,
        z, k, plan.gpb, plan.bpg, plan.upb, plan.threads, smem,
        OR_MODES.index(plan.mode), stream_of(occ),
        context=f"B {bsz}, grid {x}x{y}x{z}, K {k}")
    return planes, counts


def _launch_counts(occ: torch.Tensor, plan: CountPlan = None) -> torch.Tensor:
    """(B,) int32 occupied counts from one launch; B >= 1 and n >= 1."""
    bsz = occ.shape[0]
    n = occ[0].numel()
    out = torch.empty((bsz,), dtype=torch.int32, device=occ.device)
    plan = plan or counts_plan(bsz, n, occ.data_ptr())
    _lib().launch("occupancy_counts_launch", occ.data_ptr(), out.data_ptr(),
                  bsz, n, *plan, stream_of(occ),
                  context=f"B {bsz}, {n} bytes a grid, {plan}")
    return out


# -- plain PyTorch versions ------------------------------------------

def integral_image(occ: torch.Tensor,
                   dtype: torch.dtype = torch.int32) -> torch.Tensor:
    """(B, X, Y, Z) -> (B, X+1, Y+1, Z+1) inclusive prefix sums in
    ``dtype`` (int32; int16 holds grids of up to 32767 cells)."""
    ii = F.pad(occ.to(dtype), (1, 0, 1, 0, 1, 0))
    for ax in (1, 2, 3):
        ii = ii.cumsum(ax, dtype=dtype)
    return ii


def window_fits(ii: torch.Tensor, box: Box) -> torch.Tensor:
    """Cropped (B, X-a+1, Y-b+1, Z-c+1) bool fit mask of one in-bounds
    box, by nested per-axis differencing of the integral image."""
    a, b, c = box
    s = ii[:, a:] - ii[:, :-a]
    s = s[:, :, b:] - s[:, :, :-b]
    s = s[:, :, :, c:] - s[:, :, :, :-c]
    return s == 0


def fitmask_multibox_plain(occ: torch.Tensor, boxes) -> torch.Tensor:
    """Plain version of :func:`fitmask_multibox`: cumsum integral image
    and slice differences, on ``occ``'s device."""
    bsz, x, y, z = occ.shape
    table = box_table(boxes).tolist()
    out = torch.zeros((bsz, len(table), x, y, z), dtype=torch.int32,
                      device=occ.device)
    if not table:
        return out
    ii = integral_image(occ)
    for k, (a, b, c) in enumerate(table):
        if a <= x and b <= y and c <= z:
            out[:, k, :x - a + 1, :y - b + 1, :z - c + 1] = \
                window_fits(ii, (a, b, c))
    return out


def fitmask_batched_plain(occ: torch.Tensor, box: Box) -> torch.Tensor:
    """Plain version of :func:`fitmask_batched`."""
    return fitmask_multibox_plain(occ, [box])[:, 0]


def occupancy_counts_plain(occ: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`occupancy_counts`."""
    return occ.reshape(occ.shape[0], -1).to(torch.int32).sum(
        1, dtype=torch.int32)


def fitmask_multibox_bucketed_plain(occ: torch.Tensor, boxes):
    """Plain version of :func:`fitmask_multibox_bucketed`."""
    return fitmask_multibox_plain(occ, boxes) != 0, occupancy_counts_plain(occ)


def fitmask_multibox_singlepass_baseline_plain(occ: torch.Tensor,
                                               boxes) -> torch.Tensor:
    """Plain version of :func:`fitmask_multibox_singlepass_baseline`:
    the K plain single-box planes, stacked."""
    if len(boxes) == 0:
        return fitmask_multibox_plain(occ, boxes)
    return torch.stack([fitmask_batched_plain(occ, box) for box in boxes],
                       dim=1)


# -- kernel wrappers ---------------------------------------------------

def fitmask_multibox(occ: torch.Tensor, boxes) -> torch.Tensor:
    """occ: (B, X, Y, Z) bool; ``boxes``: K (a, b, c) shapes. Returns
    (B, K, X, Y, Z) int32 — plane k is 1 where ``boxes[k]`` fits with
    its corner at that cell, 0 where it does not or overhangs. The box
    table is a runtime (K, 3) int32 device tensor, so a new box costs no
    rebuild. K = 0 returns an empty tensor without a launch."""
    table = box_table(boxes)
    if occ.device.type == "cpu":
        return fitmask_multibox_plain(occ, table)
    with obs.span("fitmask.launch"):
        out = _launch_multibox(_cuda_occ(occ), table)
    if out.numel():
        count_launch(fitmask_multibox)
    return out


fitmask_multibox.launches = 0


def fitmask_batched(occ: torch.Tensor, box: Box) -> torch.Tensor:
    """occ: (B, X, Y, Z) bool. Returns the (B, X, Y, Z) int32 fit mask
    of one box: the multibox kernel with a one-row box table."""
    table = box_table([box])
    if occ.device.type == "cpu":
        return fitmask_multibox_plain(occ, table)[:, 0]
    with obs.span("fitmask.launch"):
        out = _launch_multibox(_cuda_occ(occ), table)
    if out.numel():
        count_launch(fitmask_batched)
    return out[:, 0]


fitmask_batched.launches = 0


def occupancy_counts(occ: torch.Tensor) -> torch.Tensor:
    """Occupied cells per grid: (B, X, Y, Z) bool -> (B,) int32; a cell
    is occupied where its byte is nonzero."""
    if occ.device.type == "cpu":
        return occupancy_counts_plain(occ)
    occ = _cuda_occ(occ)
    bsz = occ.shape[0]
    if bsz == 0 or occ[0].numel() == 0:
        return torch.zeros((bsz,), dtype=torch.int32, device=occ.device)
    with obs.span("fitmask.launch"):
        out = _launch_counts(occ)
    count_launch(occupancy_counts)
    return out


occupancy_counts.launches = 0


def fitmask_multibox_bucketed(occ: torch.Tensor, boxes):
    """occ: (B, X, Y, Z) bool; ``boxes``: K (a, b, c) shapes. Returns
    ``(planes, occupied)``: (B, K, X, Y, Z) bool planes, True where
    ``boxes[k]`` fits with its corner at that cell, and the (B,) int32
    occupied counts, from one launch. K = 0 returns empty planes and
    the counts of :func:`occupancy_counts`."""
    table = box_table(boxes)
    if occ.device.type == "cpu":
        return fitmask_multibox_bucketed_plain(occ, table)
    occ = _cuda_occ(occ)
    bsz, x, y, z = occ.shape
    if len(table) == 0:
        return (torch.empty((bsz, 0, x, y, z), dtype=torch.bool,
                            device=occ.device), occupancy_counts(occ))
    if bsz == 0 or x * y * z == 0:
        return (torch.empty((bsz, len(table), x, y, z), dtype=torch.bool,
                            device=occ.device),
                torch.zeros((bsz,), dtype=torch.int32, device=occ.device))
    with obs.span("fitmask.launch"):
        out = _launch_bucketed(occ, table)
    count_launch(fitmask_multibox_bucketed)
    return out


fitmask_multibox_bucketed.launches = 0


def fitmask_multibox_singlepass_baseline(occ: torch.Tensor,
                                         boxes) -> torch.Tensor:
    """K independent single-box launches (:func:`fitmask_batched`)
    stacked on a new axis 1: the (B, K, X, Y, Z) int32 planes of
    :func:`fitmask_multibox` from K passes over the grids instead of one.
    On a CPU tensor each is the plain single-box version."""
    bsz, x, y, z = occ.shape
    if len(boxes) == 0:
        return torch.zeros((bsz, 0, x, y, z), dtype=torch.int32,
                           device=occ.device)
    return torch.stack([fitmask_batched(occ, tuple(box)) for box in boxes],
                       dim=1)

KERNELS = (fitmask_multibox, fitmask_batched, occupancy_counts,
           fitmask_multibox_bucketed)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in KERNELS}
