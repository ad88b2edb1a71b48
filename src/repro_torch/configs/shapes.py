"""Assigned input shapes.

Shapes drive different step functions:
  train_4k     -> train_step   (full forward + backward + optimizer)
  prefill_32k  -> prefill_step (full forward, no grad)
  decode_32k   -> serve_step   (ONE token, KV/recurrent state of seq_len)
  long_500k    -> serve_step   (ONE token; sub-quadratic state: sliding
                  window for attention archs, O(1) recurrent for SSM)

``batch_specs`` returns meta-device tensors (the dry-run: no storage),
the counterpart of ``repro``'s ShapeDtypeStructs; ``concrete_batch``
materializes small real tensors for smoke tests, equal to ``repro``'s
arrays for the same seed.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.common import ModelConfig


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # train | prefill | decode


SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


def cache_window(cfg: ModelConfig, shape: InputShape) -> int:
    """KV-cache buffer length for decode shapes. long_500k must be
    sub-quadratic: attention archs use the sliding window; recurrent
    archs keep O(1) state (window only sizes any attention sub-blocks,
    e.g. zamba2's shared attention)."""
    if shape.name == "long_500k":
        w = cfg.sliding_window or 8192
        return min(w, shape.seq_len)
    return shape.seq_len


def _token_spec(cfg: ModelConfig, b: int, s: int) -> torch.Tensor:
    if cfg.arch_type == "audio":
        return torch.empty((b, cfg.n_codebooks, s), dtype=torch.int32,
                           device="meta")
    return torch.empty((b, s), dtype=torch.int32, device="meta")


def batch_specs(cfg: ModelConfig, shape: InputShape) -> Dict[str, Any]:
    """Meta-device int32 stand-ins for the step function's batch arg."""
    b = shape.global_batch
    if shape.kind in ("train", "prefill"):
        s = shape.seq_len
        out: Dict[str, Any] = {"tokens": _token_spec(cfg, b, s)}
        if shape.kind == "train":
            out["targets"] = _token_spec(cfg, b, s)
        if cfg.pos_type == "mrope":
            out["positions"] = torch.empty((b, s, 3), dtype=torch.int32,
                                           device="meta")
        return out
    # decode: one new token at position seq_len-1
    out = {"tokens": _token_spec(cfg, b, 1)}
    pos_shape = (b, 1, 3) if cfg.pos_type == "mrope" else (b, 1)
    out["positions"] = torch.empty(pos_shape, dtype=torch.int32,
                                   device="meta")
    return out


def concrete_batch(cfg: ModelConfig, shape: InputShape, seed: int = 0,
                   device=None) -> Dict[str, Any]:
    """Small real tensors matching batch_specs (smoke tests) on
    ``device`` (None: the card), drawn from numpy's ``default_rng(seed)``
    as ``repro`` draws them."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    out = {}
    for k, spec in batch_specs(cfg, shape).items():
        size = tuple(spec.shape)
        if k == "positions":
            base = np.arange(size[1], dtype=np.int32)
            if size[-1] == 3 and len(size) == 3:
                arr = np.broadcast_to(base[None, :, None], size)
            else:
                arr = np.broadcast_to(base[None], size)
        else:
            arr = rng.integers(0, cfg.vocab_size, size=size, dtype=np.int32)
        out[k] = torch.from_numpy(np.ascontiguousarray(arr)).to(device)
    return out


def smoke_shape(kind: str = "train", seq: int = 32,
                batch: int = 2) -> InputShape:
    return InputShape(f"smoke_{kind}", seq, batch, kind)
