"""Pluggable fitmask engine layer.

Every placement policy reduces to the same primitive — "for each origin
of each grid, does box k fit in free space?" — so the engines live
behind one registry and the allocator picks at runtime:

  * ``cuda``  — the hand-written CUDA kernels
    (:mod:`repro_torch.kernels.fitmask.kernel`): each grid's rows held
    as 64-bit occupancy words in shared memory answer all K candidate
    boxes in one launch, and with the free counts in the same launch
    for ``multibox_bucketed``. The default.
  * ``torch`` — the integral-image algorithm as plain PyTorch tensor
    ops, on any device, with ``multibox_bucketed`` fused as ``repro``'s
    ``JaxEngine._bucket_fn``; a user may select it, the main path never
    does.
  * ``numpy`` — batched integral-image window sums on the host
    (:mod:`repro_torch.core.fitmask`); the host path and the oracle.
  * ``ref``   — the ``Tensor.unfold`` window-sum oracle.

Selection: an explicit ``engine=`` argument wins, then
:func:`set_default_engine`, then the ``REPRO_TORCH_FITMASK_ENGINE``
environment variable, then ``cuda``. The tensor engines run on
``torch.device("cuda")`` unless given another ``device``; with no card
and none asked for, constructing one raises ``RuntimeError``. All
engines share the contract ``multibox(occ, boxes) -> (B, K, X, Y, Z)
int32`` with every plane padded to the full grid (0 where the box
overhangs or cannot fit), plus ``free_counts(occ) -> (B,)``. The tensor
engines answer with tensors on their device; the mask-query client
copies them to the host.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple, Type

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import engineconfig as _engineconfig
from repro_torch.core import fitmask as np_engine
from repro_torch.device import resolve_device

from . import kernel as _kernel
from . import ref as _ref

Box = Tuple[int, int, int]

ENGINE_ENV = _engineconfig.ENGINE_ENV


def _canon_boxes(boxes: Sequence[Box]) -> Tuple[Box, ...]:
    return tuple(tuple(int(v) for v in b) for b in boxes)  # type: ignore


class FitmaskEngine:
    """One fitmask backend. Subclasses implement :meth:`multibox` and
    :meth:`free_counts`; :meth:`fitmask` is the single-box convenience
    on top of :meth:`multibox`.

    ``pads_shapes``
        True for a backend that builds a program per input shape, so
        that a batching client should pad to a few bucketed shapes.
    ``host_free``
        True when the engine computes on the host with cost linear in
        the number of boxes; a fleet's broker then drains rather than
        waits for a quorum and answers free counts inline, and the
        eval runner runs such an engine per task.
    """

    name = "base"
    pads_shapes = False
    host_free = False

    def multibox(self, occ, boxes: Sequence[Box]):
        """(B, X, Y, Z) x K boxes -> (B, K, X, Y, Z) int32."""
        raise NotImplementedError

    def free_counts(self, occ):
        """Free-cell count per grid: (B, X, Y, Z) -> (B,) int."""
        raise NotImplementedError

    def multibox_bucketed(self, occ, boxes: Sequence[Box]):
        """Planes (nonzero where the box fits) and free counts together,
        as ``(planes, free)``: the fleet broker's flush. The default is
        the two classic calls; the ``torch`` and ``cuda`` engines fuse
        them and answer with bool planes."""
        return self.multibox(occ, boxes), self.free_counts(occ)

    def fitmask(self, occ, box: Box):
        """(B, X, Y, Z) -> (B, X, Y, Z) int32 for one box."""
        return self.multibox(occ, (box,))[:, 0]


class NumpyEngine(FitmaskEngine):
    """Host integral-image engine — the oracle. Touches no tensor:
    results stay numpy."""

    name = "numpy"
    host_free = True

    def __init__(self, device=None):
        del device   # host engine: no device

    def multibox(self, occ, boxes: Sequence[Box]) -> np.ndarray:
        return np_engine.fit_mask_multi_fast(np.asarray(occ),
                                             _canon_boxes(boxes))[0]

    def multibox_bucketed(self, occ, boxes: Sequence[Box]):
        return np_engine.fit_mask_multi_fast(
            np.asarray(occ), _canon_boxes(boxes), out_dtype=bool)

    def free_counts(self, occ) -> np.ndarray:
        return np_engine.free_counts(np.asarray(occ))


class _TensorEngine(FitmaskEngine):
    """An engine on one ``torch.device``: occupancy arrives as numpy or
    as a tensor, is moved to the device as a contiguous bool tensor
    (nonzero = occupied; the span ``fitmask.stage``, repro_torch.obs),
    and answers stay on the device."""

    def __init__(self, device=None):
        self.device = resolve_device(device)

    @obs.span("fitmask.stage")
    def _occ(self, occ) -> torch.Tensor:
        t = torch.as_tensor(occ)
        if t.dtype != torch.bool:
            t = t != 0
        return t.to(self.device).contiguous()

    def free_counts(self, occ):
        occ = self._occ(occ)
        n3 = occ.shape[1] * occ.shape[2] * occ.shape[3]
        return n3 - _kernel.occupancy_counts_plain(occ)


class TorchEngine(_TensorEngine):
    """Plain PyTorch ops (the kernels' plain versions) on any device."""

    name = "torch"

    def multibox(self, occ, boxes: Sequence[Box]):
        return _kernel.fitmask_multibox_plain(self._occ(occ),
                                              _canon_boxes(boxes))

    def multibox_bucketed(self, occ, boxes: Sequence[Box]):
        """One pass, as ``repro``'s ``JaxEngine._bucket_fn``: an integral
        image (int16 up to 32767 cells, whose window sums stay within
        [0, cells]), each in-bounds box differenced out of it into a
        bool plane, and the free counts read off its far corner."""
        occ = self._occ(occ)
        bsz, x, y, z = occ.shape
        vol = x * y * z
        ii = _kernel.integral_image(
            occ, torch.int16 if vol <= 32767 else torch.int32)
        boxes = _canon_boxes(boxes)
        planes = torch.zeros((bsz, len(boxes), x, y, z), dtype=torch.bool,
                             device=occ.device)
        for k, (a, b, c) in enumerate(boxes):
            if a <= x and b <= y and c <= z:
                planes[:, k, :x - a + 1, :y - b + 1, :z - c + 1] = \
                    _kernel.window_fits(ii, (a, b, c))
        return planes, vol - ii[:, -1, -1, -1].to(torch.int32)


class CudaEngine(_TensorEngine):
    """The CUDA kernels: ``multibox`` and ``fitmask`` launch the
    multi-box kernel, ``free_counts`` the occupancy-count kernel, and
    ``multibox_bucketed`` the multi-box kernel's fused form (bool planes
    and counts in one launch). On a CPU device (tests) the wrappers run
    their plain versions.

    ``pads_shapes`` is False: the box table is a runtime tensor and the
    kernel takes B and K as arguments, so a new box or batch shape costs
    no rebuild — there is nothing for a batching client to pad for."""

    name = "cuda"

    def multibox(self, occ, boxes: Sequence[Box]):
        return _kernel.fitmask_multibox(self._occ(occ), _canon_boxes(boxes))

    def fitmask(self, occ, box: Box):
        return _kernel.fitmask_batched(self._occ(occ),
                                       tuple(int(v) for v in box))

    def free_counts(self, occ):
        occ = self._occ(occ)
        n3 = occ.shape[1] * occ.shape[2] * occ.shape[3]
        return n3 - _kernel.occupancy_counts(occ)

    def multibox_bucketed(self, occ, boxes: Sequence[Box]):
        occ = self._occ(occ)
        n3 = occ.shape[1] * occ.shape[2] * occ.shape[3]
        planes, occupied = _kernel.fitmask_multibox_bucketed(
            occ, _canon_boxes(boxes))
        return planes, n3 - occupied


class RefEngine(_TensorEngine):
    """``Tensor.unfold`` window-sum oracle."""

    name = "ref"

    def multibox(self, occ, boxes: Sequence[Box]):
        return _ref.fitmask_multibox_reference(self._occ(occ),
                                               _canon_boxes(boxes))


_REGISTRY: Dict[str, Type[FitmaskEngine]] = {}
_INSTANCES: Dict[Tuple[str, Optional[str]], FitmaskEngine] = {}
_ALIASES = {"auto": "cuda", "kernel": "cuda"}


def register_engine(cls: Type[FitmaskEngine]) -> Type[FitmaskEngine]:
    _REGISTRY[cls.name] = cls
    for key in [k for k in _INSTANCES if k[0] == cls.name]:
        del _INSTANCES[key]
    return cls


for _cls in (NumpyEngine, TorchEngine, CudaEngine, RefEngine):
    register_engine(_cls)


def available_engines() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def set_default_engine(name: Optional[str]) -> None:
    """Process-wide default; None resets to env-var/``cuda`` resolution.
    Delegates to ``repro_torch.core.engineconfig``."""
    _engineconfig.set_default_engine(name)


def default_engine_name() -> str:
    return _engineconfig.default_engine_name()


def get_engine(name: Optional[str] = None, device=None) -> FitmaskEngine:
    """The engine instance for (name, device), interned. ``device`` is
    ignored by the numpy host engine."""
    name = _ALIASES.get(name, name) if name else default_engine_name()
    if name not in _REGISTRY:
        raise KeyError(f"unknown fitmask engine {name!r}; "
                       f"have {available_engines()}")
    dev = None if device is None or name == "numpy" else str(
        torch.device(device))
    inst = _INSTANCES.get((name, dev))
    if inst is None:
        inst = _INSTANCES[(name, dev)] = _REGISTRY[name](device=dev)
    return inst


def fitmask(occ, box: Box, engine: Optional[str] = None, device=None):
    """occ: (B, X, Y, Z) or (X, Y, Z). Returns the int32 fit mask of the
    same (batched) shape from the selected engine."""
    squeeze = occ.ndim == 3
    if squeeze:
        occ = occ[None]
    out = get_engine(engine, device).fitmask(occ, box)
    return out[0] if squeeze else out


def fitmask_multi(occ, boxes: Sequence[Box], engine: Optional[str] = None,
                  device=None):
    """All K candidate boxes in one engine pass: (B, X, Y, Z) or
    (X, Y, Z) -> (B, K, X, Y, Z) / (K, X, Y, Z) int32."""
    squeeze = occ.ndim == 3
    if squeeze:
        occ = occ[None]
    out = get_engine(engine, device).multibox(occ, boxes)
    return out[0] if squeeze else out


def free_counts(occ, engine: Optional[str] = None, device=None):
    """Free-cell count per grid: (B, X, Y, Z) -> (B,), or a single
    (X, Y, Z) grid -> scalar."""
    squeeze = occ.ndim == 3
    if squeeze:
        occ = occ[None]
    out = get_engine(engine, device).free_counts(occ)
    return out[0] if squeeze else out
