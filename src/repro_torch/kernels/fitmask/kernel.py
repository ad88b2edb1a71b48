"""Free-box search ("fitmask") as hand-written CUDA kernels for Hopper.

For every origin of an occupancy grid: is the (a, b, c) window entirely
free? Three wrappers, each beside its plain PyTorch version and with a
launch counter (``<wrapper>.launches``, a plain int bumped once per
kernel launch and nowhere else):

* :func:`fitmask_multibox` — all K candidate boxes of a placement step
  from one integral image per grid. Replaces the Pallas kernel
  ``repro/kernels/fitmask/kernel.py::fitmask_multibox``
  (``_fitmask_multibox_kernel``).
* :func:`fitmask_batched` — one box; a launch of the same CUDA kernel
  with a one-row box table. Replaces ``fitmask_batched``
  (``_fitmask_kernel``).
* :func:`occupancy_counts` — occupied cells per grid. Replaces
  ``occupancy_counts`` (``_occupancy_counts_kernel``).

A wrapper takes its plain version only for a tensor on the CPU. For a
CUDA tensor it launches the kernel or raises; nothing falls back. The
kernels are CUDA C++ in ``repro_torch/csrc/fitmask.cu``, compiled with
``nvcc`` for ``sm_90a`` into ``build/repro_torch/`` at first use (by
:func:`repro_torch.kernels._build.build`) and bound with ctypes.

Bound on an H100 SXM: the functions move far more bytes than they do
operations. ``fitmask_multibox`` reads B·X·Y·Z bool cells and writes
B·K·X·Y·Z int32 cells — about 4 bytes per output cell over 3.35 TB/s —
against about eight integer operations per output cell. The design keeps
the (X+1)(Y+1)(Z+1) int32 integral image in shared memory (built once
per block, never written to device memory) and stores every output
plane with consecutive threads on consecutive cells. ``occupancy_counts``
reads each cell once and writes one int32 per grid.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .._build import SMEM_LIMIT_BYTES, Library, stream_of

Box = Tuple[int, int, int]

SOURCE = "fitmask.cu"                 # in repro_torch/csrc

# The integral image is (X+1)(Y+1)(Z+1) int32 in shared memory, so grids
# up to 37^3 fit (17^3 * 4 B = 19.7 KB for the static 16^3 torus).
# Blocks to aim for: two per SM of the H100's 132.
_TARGET_BLOCKS = 264


@functools.cache
def _lib() -> Library:
    p, i = ctypes.c_void_p, ctypes.c_int
    return Library(SOURCE, {
        "fitmask_multibox_launch": [p, p, p, i, i, i, i, i, i, p],
        "occupancy_counts_launch": [p, p, i, i, p]})


# -- argument handling -------------------------------------------------

def box_table(boxes) -> np.ndarray:
    """Validate K (a, b, c) boxes into a (K, 3) int32 host array."""
    arr = np.asarray(boxes, dtype=np.int64).reshape(-1, 3)
    if (arr < 1).any():
        raise ValueError(f"box extents must be >= 1, got {arr.tolist()}")
    return arr.astype(np.int32)


def check_smem(dims: Sequence[int]) -> int:
    """Shared-memory bytes of a grid's integral image; raises
    ``ValueError`` when it exceeds what one block can use."""
    x, y, z = (int(d) for d in dims)
    smem = (x + 1) * (y + 1) * (z + 1) * 4
    if smem > SMEM_LIMIT_BYTES:
        raise ValueError(
            f"grid {x}x{y}x{z} needs a {smem}-byte int32 integral image; "
            f"the kernel keeps it in shared memory, which holds at most "
            f"{SMEM_LIMIT_BYTES} bytes a block (grids up to 37^3)")
    return smem


def _cuda_occ(occ: torch.Tensor) -> torch.Tensor:
    if occ.device.type != "cuda":
        raise ValueError(f"fitmask kernels take CPU or CUDA tensors, "
                         f"got {occ.device}")
    if occ.dtype != torch.bool or occ.dim() != 4 or not occ.is_contiguous():
        raise ValueError("the CUDA fitmask kernels take a contiguous "
                         f"(B, X, Y, Z) bool tensor, got {occ.dtype} "
                         f"{tuple(occ.shape)}")
    return occ


def _boxes_per_block(bsz: int, k: int) -> int:
    groups = min(k, max(1, -(-_TARGET_BLOCKS // bsz)))
    return max(-(-k // groups), -(-k // 65535))


@functools.lru_cache(maxsize=256)
def _device_boxes(table: bytes, device: torch.device) -> torch.Tensor:
    """The (K, 3) int32 box table on the card, uploaded once per distinct
    table: a pageable upload would block the host on every launch."""
    return torch.frombuffer(bytearray(table), dtype=torch.int32).reshape(
        -1, 3).to(device)


def _launch_multibox(occ: torch.Tensor, table: np.ndarray) -> torch.Tensor:
    bsz, x, y, z = occ.shape
    k = len(table)
    out = torch.empty((bsz, k, x, y, z), dtype=torch.int32, device=occ.device)
    if k == 0 or out.numel() == 0:
        return out
    check_smem((x, y, z))
    boxes = _device_boxes(table.tobytes(), occ.device)
    _lib().launch(
        "fitmask_multibox_launch", occ.data_ptr(), boxes.data_ptr(),
        out.data_ptr(), bsz, x, y, z, k, _boxes_per_block(bsz, k),
        stream_of(occ))
    return out


# -- plain PyTorch versions ------------------------------------------

def integral_image(occ: torch.Tensor) -> torch.Tensor:
    """(B, X, Y, Z) -> (B, X+1, Y+1, Z+1) int32 inclusive prefix sums."""
    ii = F.pad(occ.to(torch.int32), (1, 0, 1, 0, 1, 0))
    for ax in (1, 2, 3):
        ii = ii.cumsum(ax, dtype=torch.int32)
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
    out = _launch_multibox(_cuda_occ(occ), table)
    if out.numel():
        fitmask_multibox.launches += 1
    return out


fitmask_multibox.launches = 0


def fitmask_batched(occ: torch.Tensor, box: Box) -> torch.Tensor:
    """occ: (B, X, Y, Z) bool. Returns the (B, X, Y, Z) int32 fit mask
    of one box: the multibox kernel with a one-row box table."""
    table = box_table([box])
    if occ.device.type == "cpu":
        return fitmask_multibox_plain(occ, table)[:, 0]
    out = _launch_multibox(_cuda_occ(occ), table)
    if out.numel():
        fitmask_batched.launches += 1
    return out[:, 0]


fitmask_batched.launches = 0


def occupancy_counts(occ: torch.Tensor) -> torch.Tensor:
    """Occupied cells per grid: (B, X, Y, Z) bool -> (B,) int32."""
    if occ.device.type == "cpu":
        return occupancy_counts_plain(occ)
    occ = _cuda_occ(occ)
    bsz = occ.shape[0]
    n = occ[0].numel() if bsz else 0
    out = torch.empty((bsz,), dtype=torch.int32, device=occ.device)
    if bsz == 0:
        return out
    if n == 0:
        return out.zero_()
    _lib().launch("occupancy_counts_launch", occ.data_ptr(), out.data_ptr(),
                  bsz, n, stream_of(occ))
    occupancy_counts.launches += 1
    return out


occupancy_counts.launches = 0

KERNELS = (fitmask_multibox, fitmask_batched, occupancy_counts)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in KERNELS}
