"""Mesh construction: the production meshes for the dry-run, and
RFold-driven meshes whose rank order follows a folded allocation.

A mesh is a ``DeviceMesh`` over the ranks of the current process group
(``repro``'s is a ``jax.sharding.Mesh`` over local devices): on the card
its collectives are NCCL's, on ``device="cpu"`` gloo's. Building one is
collective: every rank of the group builds every mesh, its own or not
(``DeviceMesh`` creates a subgroup per mesh row with ``new_group``). A
rank outside a mesh gets ``mesh.get_coordinate() is None`` and must not
run that mesh's step.

NOTE: ``make_production_mesh`` is a function (never a module-level
constant) so importing this module touches no process group.
"""
from __future__ import annotations

import os
import socket
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.device import resolve_device


def device_type(device=None) -> str:
    """``"cuda"`` unless the caller asks for ``"cpu"`` (no card raises)."""
    return resolve_device(device).type


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def ensure_process_group(device=None) -> bool:
    """Join the process group ``torchrun`` describes (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT`` in the environment),
    or start one of world size 1 on a free localhost port. Nothing
    happens if a group is up. Returns True when it started one: the
    caller then destroys it (``dist.destroy_process_group()``).

    On the card the group has NCCL for CUDA tensors and gloo for CPU
    ones; on ``device="cpu"`` gloo only."""
    if dist.is_initialized():
        return False
    backend = ("cpu:gloo,cuda:nccl" if device_type(device) == "cuda"
               else "gloo")
    if "WORLD_SIZE" in os.environ and "RANK" in os.environ:
        if device_type(device) == "cuda":
            local = int(os.environ.get("LOCAL_RANK", os.environ["RANK"]))
            torch.cuda.set_device(local % torch.cuda.device_count())
        dist.init_process_group(backend)
    else:
        if device_type(device) == "cuda":
            torch.cuda.set_device(resolve_device(device).index or 0)
        dist.init_process_group(
            backend, init_method=f"tcp://localhost:{_free_port()}",
            rank=0, world_size=1)
    return True


def _device_mesh(ranks: np.ndarray, axes: Sequence[str], device):
    from torch.distributed.device_mesh import DeviceMesh
    return DeviceMesh(device_type(device), torch.as_tensor(ranks),
                      mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """Single pod: 16x16 (256 ranks) over ("data", "model"); multi-pod:
    2x16x16 (512 ranks) over ("pod", "data", "model")."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device)


def make_mesh(shape: Sequence[int], axes: Sequence[str], device=None):
    """A mesh of ``shape`` over the group's first ``prod(shape)`` ranks;
    raises ``ValueError`` when the group has fewer (a mesh never
    shrinks)."""
    n = int(np.prod(list(shape)))
    world = dist.get_world_size()
    if n > world:
        raise ValueError(f"a {'x'.join(map(str, shape))} mesh needs {n} "
                         f"ranks, the process group has {world}")
    return _device_mesh(np.arange(n).reshape(tuple(shape)), axes, device)


def mesh_from_allocation(coords: Sequence[Tuple[int, int, int]],
                         mesh_shape: Sequence[int],
                         axes: Sequence[str],
                         ranks: Optional[Sequence[int]] = None,
                         device=None):
    """Build a DeviceMesh whose rank order follows an RFold allocation.

    ``coords`` is the ordered XPU list of a committed placement (ring
    traversal order for folded placements — Allocation.coords). The
    ranks assigned to those torus coordinates are laid out in that
    order and reshaped to ``mesh_shape``; collectives along the fastest-
    varying mesh axis then run on torus-neighbour rings, which is
    exactly the property folding preserves.

    ``ranks`` are the ranks in the allocation's order: a deployment
    whose ranks know their torus coordinates passes the rank at each of
    ``coords``. By default the group's ranks are taken in index order,
    as ``repro``'s stand-in takes ``jax.devices()`` off a TPU.
    """
    coords = list(coords)
    n = int(np.prod(list(mesh_shape)))
    if len(coords) != n:
        raise ValueError(f"allocation has {len(coords)} XPUs, mesh "
                         f"needs {n}")
    ranks = list(ranks) if ranks is not None \
        else list(range(dist.get_world_size()))
    if len(ranks) < n:
        raise ValueError(f"only {len(ranks)} ranks for {n}-XPU mesh")
    chosen = np.array(ranks[:n], dtype=np.int64).reshape(tuple(mesh_shape))
    return _device_mesh(chosen, axes, device)


def allocation_mesh_shape(num_xpus: int,
                          prefer_model: int = 0) -> Tuple[int, int]:
    """Factor an allocation size into a (data, model) mesh shape: the
    model axis gets the largest power-of-two divisor <= prefer_model
    (default: sqrt-ish split)."""
    n = num_xpus
    if prefer_model:
        m = prefer_model
        while n % m:
            m -= 1
        return (n // m, m)
    m = 1
    while (m * 2) * (m * 2) <= n or (n % (m * 2) == 0 and m * 2 * m * 2 <= n):
        if n % (m * 2):
            break
        m *= 2
        if m * m >= n:
            break
    m = max(1, m)
    while n % m:
        m //= 2
    return (n // m, m)
