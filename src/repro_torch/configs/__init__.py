"""Model configurations of the port, one module per architecture."""
from __future__ import annotations

from .base import all_configs, get_config, smoke_variant  # noqa: F401
