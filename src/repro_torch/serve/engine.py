"""Serving engine: batched single-token decode over the unified
KV/recurrent decode state, and greedy generation.

As in ``repro``, the prompt is read one ``decode_step`` at a time
(exact cache population); the full-sequence prefill forward is
``models.model.forward``.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

from repro_torch.configs.shapes import InputShape, cache_window
from repro_torch.models import model as lm
from repro_torch.device import resolve_device
from repro_torch.models.common import ModelConfig


def init_state(cfg: ModelConfig, batch: int, window: int, dtype=None,
               device=None) -> List:
    return lm.init_decode_state(cfg, batch, window,
                                dtype or cfg.activation_dtype, device)


def serve_step(cfg: ModelConfig, params: Any, state: List,
               batch: Dict) -> Tuple[torch.Tensor, List]:
    """One decode step for a batch of sequences."""
    return lm.decode_step(cfg, params, state, batch)


def greedy_decode(cfg: ModelConfig, params: Any, prompt, steps: int,
                  window: int = 0, device=None) -> torch.Tensor:
    """Greedy generation: prompt (B, S0) -> (B, S0+steps) int32 tokens
    (audio: (B, K, S0) -> (B, K, S0+steps), one argmax per codebook) on
    ``device`` (None: the card; no card raises ``RuntimeError``).

    Prompt ingestion uses decode_step per position (exact cache
    population); generation continues greedily, taking the argmax on
    the device. As in ``repro``, no ``pos_offset`` is passed, so
    sinusoidal positions stay those of position 0 in every step."""
    device = resolve_device(device)
    toks = torch.as_tensor(prompt, dtype=torch.int32).to(device)
    b, s0 = toks.shape[0], toks.shape[-1]
    window = window or cache_window(
        cfg, InputShape("gen", s0 + steps, b, "decode"))
    state = init_state(cfg, b, window, device=device)

    def make_batch(tok, t):
        pos = torch.full((b, 1), t, dtype=torch.int32, device=device)
        if cfg.pos_type == "mrope":
            pos = pos[:, :, None].expand(b, 1, 3)
        return {"tokens": tok, "positions": pos}

    logits = None
    for t in range(s0):
        logits, state = serve_step(cfg, params, state,
                                   make_batch(toks[..., t:t + 1], t))
    for t in range(steps):
        # (B, V) or (B, K, V) -> (B, 1) or (B, K, 1)
        nxt = logits[:, -1].argmax(dim=-1).to(torch.int32)[..., None]
        toks = torch.cat([toks, nxt], dim=-1)
        logits, state = serve_step(cfg, params, state,
                                   make_batch(nxt, s0 + t))
    return toks
