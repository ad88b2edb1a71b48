"""Request/response interface between torus models and fitmask engines.

A torus *submits* its per-epoch mask work to whatever client is
installed; :class:`InlineMaskClient` answers immediately from one
engine. The contract is the two primitives every policy reduces to:

  ``multibox(occ, boxes) -> (B, K, X, Y, Z) integer/bool numpy``
      occ is a (B, X, Y, Z) bool grid batch; plane k is the full-grid
      fit mask of ``boxes[k]``, *nonzero where the box fits* (zero
      where it overhangs or cannot fit), in the request's box order.
      Consumers test ``!= 0`` rather than comparing dtypes.
  ``free_counts(occ) -> (B,) int64 numpy``
      free cells per grid.

Both return host numpy arrays: the tensor engines answer on their
device, and the client copies the answer back (``.cpu().numpy()``) so
callers index and cache plain arrays. Answers are a pure function of
``(occ[b], box)`` per plane.

Every torus reaches its masks through one client, picked by
:func:`torus_client`: an installed client (the fleet's broker), else
an :class:`InlineMaskClient` over a tensor engine, else the registry's
``numpy`` engine, which computes on the host and meets the contract
as it stands.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from .. import obs

Box = Tuple[int, int, int]


def to_numpy(x) -> np.ndarray:
    """Host numpy view of an engine answer: a tensor on any device is
    copied back; a numpy array passes through."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class MaskQueryClient:
    """The request/response contract a torus submits mask work to.

    ``host_free`` mirrors the backing engine's flag: it computes on the
    host with cost linear in the number of boxes (numpy). Toruses ask
    every client alike and do not read it."""

    host_free = False

    def multibox(self, occ, boxes: Sequence[Box]) -> np.ndarray:
        """(B, X, Y, Z) occupancy x K boxes -> (B, K, X, Y, Z) numpy,
        nonzero where the box fits (consumers test ``!= 0``)."""
        raise NotImplementedError

    def free_counts(self, occ) -> np.ndarray:
        """(B, X, Y, Z) occupancy -> (B,) int64 free-cell counts."""
        raise NotImplementedError


class InlineMaskClient(MaskQueryClient):
    """Answers requests immediately from one fitmask engine and copies
    the answer to host numpy. ``seconds`` accumulates the host time spent
    answering, the total of the span ``maskquery.inline``
    (repro_torch.obs); each answer ends in a copy to the host (the span
    ``fitmask.readback``), so it includes the device's work."""

    def __init__(self, engine):
        self.engine = engine
        self.host_free = bool(getattr(engine, "host_free", False))
        self.seconds = 0.0

    def multibox(self, occ, boxes: Sequence[Box]) -> np.ndarray:
        with obs.span("maskquery.inline") as call:
            if len(boxes) == 1:
                # A lone candidate takes the engine's single-box entry
                # point. The answer is the same as multibox's; the branch
                # exists only so the placement loop drives the single-box
                # kernel.
                out = self.engine.fitmask(occ, boxes[0])
                with obs.span("fitmask.readback"):
                    out = to_numpy(out)[:, None]
            else:
                out = self.engine.multibox(occ, boxes)
                with obs.span("fitmask.readback"):
                    out = to_numpy(out)
        self.seconds += call.seconds
        return out

    def free_counts(self, occ) -> np.ndarray:
        with obs.span("maskquery.inline") as call:
            out = self.engine.free_counts(occ)
            with obs.span("fitmask.readback"):
                out = to_numpy(out).astype(np.int64)
        self.seconds += call.seconds
        return out


# Inline clients are interned per engine instance: `client is` identity
# then doubles as "same backend as last epoch" in the torus caches
# (engines themselves are interned per (name, device) in the registry).
_INLINE: Dict[int, InlineMaskClient] = {}


def resolve_mask_client(selection=None) -> Optional[InlineMaskClient]:
    """Resolve an engine selection to an inline client: ``None`` for
    the ``numpy`` host engine (a torus calls it directly,
    :func:`torus_client`), a cached :class:`InlineMaskClient`
    otherwise. ``selection`` is an engine name, an
    :class:`~repro_torch.core.engineconfig.EngineConfig`, or ``None`` —
    all resolved through ``EngineConfig.resolve_name()``."""
    from repro_torch.core.engineconfig import EngineConfig
    cfg = EngineConfig.coerce(selection)
    if cfg.resolve_name() == "numpy":
        return None
    engine = cfg.get_engine()
    client = _INLINE.get(id(engine))
    if client is None:
        client = _INLINE[id(engine)] = InlineMaskClient(engine)
    return client


def torus_client(mask_client, selection):
    """The client a torus submits its mask work to: ``mask_client`` if
    one is installed, else the inline client of ``selection``'s engine,
    else (``numpy``) the registry's interned host engine itself."""
    if mask_client is not None:
        return mask_client
    client = resolve_mask_client(selection)
    if client is None:
        from repro_torch.core.engineconfig import EngineConfig
        client = EngineConfig.coerce(selection).get_engine()
    return client
