"""Typed engine selection — resolved in exactly one place.

:class:`EngineConfig` carries which fitmask backend answers the
placement loop's mask queries and on which ``torch.device``, and
:meth:`EngineConfig.resolve_name` is the **single** place the
precedence order lives:

    explicit ``engine`` field
      > :func:`set_default_engine` (process-wide programmatic default)
      > ``REPRO_TORCH_FITMASK_ENGINE`` env var (**deprecated** alias —
        warns once per process)
      > ``"cuda"``

The default is the CUDA kernel engine on the card: entry points run on
the GPU unless the caller asks for the host (``engine="numpy"``) or for
a CPU tensor path (``device="cpu"``). With no card and no such request
the engine raises ``RuntimeError``; it never carries on on the CPU.

The env var has its own name so that a process importing both this
package and the JAX reference cannot cross-wire their defaults.
``repro_torch.kernels.fitmask.ops`` delegates its
``set_default_engine``/``default_engine_name`` entry points here. The
registry is consulted lazily.
"""
from __future__ import annotations

import os
import warnings
from dataclasses import dataclass, replace
from typing import Optional, Union

ENGINE_ENV = "REPRO_TORCH_FITMASK_ENGINE"

# Failover order: each step strictly reduces the stack it depends on,
# ending at the pure-numpy host engine that cannot lose a backend.
# Registry engines outside the chain (e.g. ``ref``) degrade straight to
# numpy. The fleet broker (``repro_torch.sim.fleet``) walks it only when
# built with ``failover=True``; otherwise, as in the inline placement
# loop, an engine error is raised.
FAILOVER_CHAIN = ("cuda", "torch", "numpy")


def failover_candidates(name: str) -> tuple:
    """Engines to try, in order, after ``name`` fails at runtime.
    Numpy is the floor (empty tuple); unknown names also return empty."""
    try:
        name = canonical_engine_name(name)
    except KeyError:
        return ()
    if name in FAILOVER_CHAIN:
        return FAILOVER_CHAIN[FAILOVER_CHAIN.index(name) + 1:]
    return ("numpy",)


# Process-wide programmatic default (the ``set_default_engine`` knob).
_default_engine: Optional[str] = None
# The env var warns once per process, not once per query.
_env_warned = False


def canonical_engine_name(name: str) -> str:
    """Alias-fold and validate an engine name against this package's
    registry. Raises ``KeyError`` on an unknown name."""
    from repro_torch.kernels.fitmask import ops
    name = ops._ALIASES.get(name, name)
    if name not in ops._REGISTRY:
        raise KeyError(f"unknown fitmask engine {name!r}; "
                       f"have {ops.available_engines()}")
    return name


def set_default_engine(name: Optional[str]) -> None:
    """Process-wide default engine (overrides the deprecated env var);
    ``None`` resets to env-var/``cuda`` resolution."""
    global _default_engine
    if name is not None:
        name = canonical_engine_name(name)
    _default_engine = name


def _env_engine() -> Optional[str]:
    """The deprecated ``REPRO_TORCH_FITMASK_ENGINE`` escape hatch;
    warns on first use. An unknown value raises ``KeyError`` eagerly."""
    env = os.environ.get(ENGINE_ENV, "").strip()
    if not env:
        return None
    global _env_warned
    if not _env_warned:
        warnings.warn(
            f"{ENGINE_ENV} is deprecated; pass "
            "EngineConfig(engine=...) (or engine=/fitmask_engine= "
            "kwargs) or call set_default_engine() instead",
            DeprecationWarning, stacklevel=3)
        _env_warned = True
    from repro_torch.kernels.fitmask import ops
    name = ops._ALIASES.get(env, env)
    if name not in ops._REGISTRY:
        raise KeyError(f"{ENGINE_ENV}={env!r} names no engine; "
                       f"have {ops.available_engines()}")
    return name


def default_engine_name() -> str:
    """The registry's resolved default — ``EngineConfig().resolve_name()``."""
    if _default_engine is not None:
        return _default_engine
    return _env_engine() or "cuda"


@dataclass(frozen=True)
class EngineConfig:
    """One typed value for "which fitmask backend, on which device".

    ``engine``
        Registry name (``cuda``/``torch``/``numpy``/``ref`` or an
        alias). ``None`` defers to the process default / deprecated
        env var / ``cuda``.
    ``device``
        ``torch.device`` (or its string) the tensor engines run on.
        ``None`` means ``cuda``. Ignored by the ``numpy`` host engine.
    ``fleet_size`` / ``quorum`` / ``timeout`` / ``max_inflight``
        How the fleet layer drives the backend: simulators per broker
        and the broker's flush policy. ``"auto"`` defers to the
        engine-aware policy in ``repro_torch.sim.fleet.Fleet``.
    """

    engine: Optional[str] = None
    device: Optional[object] = None
    fleet_size: Union[str, int, None] = "auto"
    quorum: Union[str, float, None] = "auto"
    timeout: Union[str, float, None] = "auto"
    max_inflight: Optional[int] = None

    @classmethod
    def coerce(cls, value) -> "EngineConfig":
        """Accept the spellings call sites use: ``None`` (all defaults),
        a bare engine name string, or an EngineConfig."""
        if value is None:
            return cls()
        if isinstance(value, EngineConfig):
            return value
        if isinstance(value, str):
            return cls(engine=value)
        raise TypeError("engine selection must be None, an engine name "
                        f"or an EngineConfig, got {value!r}")

    def with_engine(self, name: Optional[str]) -> "EngineConfig":
        return replace(self, engine=name)

    # -- THE selection point ------------------------------------------
    def resolve_name(self) -> str:
        """Resolve to a concrete registry name. Explicit field first,
        then :func:`set_default_engine`, then the deprecated env var,
        then ``cuda``."""
        if self.engine is not None:
            return canonical_engine_name(self.engine)
        return default_engine_name()

    def get_engine(self):
        """The resolved :class:`~repro_torch.kernels.fitmask.ops.FitmaskEngine`
        instance for (engine, device)."""
        from repro_torch.kernels.fitmask import ops
        return ops.get_engine(self.resolve_name(), device=self.device)

    def make_client(self):
        """Inline mask client for the resolved engine, or ``None`` for
        the numpy host integral-image path."""
        from .maskquery import resolve_mask_client
        return resolve_mask_client(self)

    def fleet_kwargs(self) -> dict:
        """Kwargs for ``repro_torch.sim.fleet.Fleet``/``QueryBroker``,
        the device included."""
        kw = {"engine": self.engine, "device": self.device,
              "quorum": self.quorum, "timeout": self.timeout}
        if self.max_inflight is not None:
            kw["max_inflight"] = self.max_inflight
        return kw
