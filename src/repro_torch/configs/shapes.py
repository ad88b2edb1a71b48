"""Assigned input shapes.

Shapes drive different step functions:
  train_4k     -> train_step   (full forward + backward + optimizer)
  prefill_32k  -> prefill_step (full forward, no grad)
  decode_32k   -> serve_step   (ONE token, KV/recurrent state of seq_len)
  long_500k    -> serve_step   (ONE token; sub-quadratic state: sliding
                  window for attention archs, O(1) recurrent for SSM)

The dry-run input specs of ``repro.configs.shapes`` come with the port
of the dry-run.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

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
