"""Engine selection in the reference: there is one engine, the numpy
host path, so every selection resolves to it."""
from __future__ import annotations


class EngineConfig:
    engine = "numpy"

    @classmethod
    def coerce(cls, selection=None) -> "EngineConfig":
        del selection
        return cls()
