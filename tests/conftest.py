"""Test-suite bootstrap.

Two jobs:

1. Register custom marks (``slow``) so ``pytest`` runs warning-clean.
2. Provide a graceful fallback when ``hypothesis`` is not installed
   (see requirements-dev.txt): a deterministic miniature stand-in that
   implements the tiny surface this suite uses (``given`` / ``settings``
   / ``strategies.integers|tuples|sampled_from``). Property tests then
   run a fixed, seeded sample sweep instead of erroring at collection.
   With the real hypothesis available, the shim is never installed.
"""
from __future__ import annotations

import inspect
import sys
import types
import zlib


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long-running test (subprocess compiles etc.)")
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (skips without one)")


def _install_hypothesis_stub() -> None:
    import numpy as np

    class _Strategy:
        def __init__(self, draw):
            self.draw = draw

    def integers(min_value, max_value):
        return _Strategy(
            lambda rng: int(rng.integers(min_value, max_value + 1)))

    def sampled_from(elements):
        seq = list(elements)
        return _Strategy(lambda rng: seq[int(rng.integers(len(seq)))])

    def tuples(*strategies):
        return _Strategy(
            lambda rng: tuple(s.draw(rng) for s in strategies))

    def settings(max_examples: int = 25, deadline=None, **_kw):
        def deco(fn):
            fn._stub_max_examples = max_examples
            return fn
        return deco

    class _StubAssume(Exception):
        pass

    def given(*strategies):
        def deco(fn):
            def wrapper(*args, **kwargs):
                n = getattr(wrapper, "_stub_max_examples",
                            getattr(fn, "_stub_max_examples", 25))
                # Deterministic per-test seed: same draws every run.
                rng = np.random.default_rng(
                    zlib.crc32(fn.__qualname__.encode()))
                for _ in range(n):
                    drawn = tuple(s.draw(rng) for s in strategies)
                    try:
                        fn(*args, *drawn, **kwargs)
                    except _StubAssume:
                        continue  # rejected example, draw another
            wrapper.__name__ = fn.__name__
            wrapper.__qualname__ = fn.__qualname__
            wrapper.__doc__ = fn.__doc__
            wrapper.__module__ = fn.__module__
            # No fixture params: the strategies supply every argument.
            wrapper.__signature__ = inspect.Signature()
            return wrapper
        return deco

    def assume(condition) -> bool:  # minimal: skip rest of one example
        if not condition:
            raise _StubAssume()
        return True

    strat = types.ModuleType("hypothesis.strategies")
    strat.integers = integers
    strat.sampled_from = sampled_from
    strat.tuples = tuples

    mod = types.ModuleType("hypothesis")
    mod.strategies = strat
    mod.given = given
    mod.settings = settings
    mod.assume = assume
    mod.HealthCheck = types.SimpleNamespace(too_slow="too_slow",
                                            filter_too_much="filter_too_much")
    mod.__stub__ = True
    sys.modules["hypothesis"] = mod
    sys.modules["hypothesis.strategies"] = strat


try:  # pragma: no cover - environment probe
    import hypothesis  # noqa: F401
except ImportError:  # pragma: no cover
    _install_hypothesis_stub()
