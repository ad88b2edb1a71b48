"""Tree checkpointing: one ``.npz`` per save with ``repro``'s
path-encoded keys (``params/segments/0/...``, ``opt/mu/...``,
``opt/step``) and a ``.meta.json`` beside it, so a checkpoint written by
either package loads in the other."""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.model import tree_map


def _paths(tree: Any, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(key, leaf) in ``repro``'s encoding: dict keys and list indices
    joined by ``/``."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        yield prefix, tree
        return
    for k, v in items:
        yield from _paths(v, f"{prefix}/{k}" if prefix else str(k))


def _base(path: str) -> str:
    return path[:-4] if path.endswith(".npz") else path


def save_checkpoint(path: str, params: Any, opt_state: Optional[Any] = None,
                    step: int = 0, meta: Optional[Dict] = None) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    base = _base(path)
    arrays = {key: leaf.detach().cpu().numpy() for key, leaf in
              _paths({"params": params, "opt": opt_state or {}})}
    np.savez(base + ".npz", **arrays)
    with open(base + ".meta.json", "w") as f:
        json.dump({"step": step, **(meta or {})}, f)


def load_checkpoint(path: str, like_params: Any,
                    like_opt: Optional[Any] = None):
    """Restore into the structure of ``like_*``: each leaf takes the
    like leaf's dtype and device. A missing key raises ``KeyError``, a
    shape other than the like leaf's ``ValueError``. Returns (params,
    opt, meta)."""
    like = {"params": like_params, "opt": like_opt or {}}
    with np.load(_base(path) + ".npz") as data:
        arrays = {key: data[key] for key, _ in _paths(like)}
    it = iter(arrays.items())

    def restore(leaf):
        key, arr = next(it)
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"{key}: shape {arr.shape} in the checkpoint, "
                             f"{tuple(leaf.shape)} wanted")
        return torch.from_numpy(arr).to(device=leaf.device, dtype=leaf.dtype)

    restored = tree_map(restore, like)
    meta = {}
    mp = _base(path) + ".meta.json"
    if os.path.exists(mp):
        with open(mp) as f:
            meta = json.load(f)
    return restored["params"], restored["opt"], meta
