"""Gated dense feed-forward layer (SwiGLU/GELU). The MoE layers of
``repro.models.ffn`` come with the MoE families."""
from __future__ import annotations

from typing import Optional

import torch

from .common import ModelConfig, Params, dense_init, gated_act


def init_ffn(cfg: ModelConfig, generator: Optional[torch.Generator],
             device: torch.device, d_ff: Optional[int] = None,
             d_model: Optional[int] = None) -> Params:
    d = d_model or cfg.d_model
    f = d_ff or cfg.d_ff
    return {
        "w_gate": dense_init(generator, (d, f), device),
        "w_up": dense_init(generator, (d, f), device),
        "w_down": dense_init(generator, (f, d), device),
    }


def ffn_forward(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    gate = x @ p["w_gate"].to(x.dtype)
    up = x @ p["w_up"].to(x.dtype)
    h = gated_act(cfg, gate, up)
    return h @ p["w_down"].to(x.dtype)
