"""Grouped-query attention (RoPE, M-RoPE or none; sinusoidal positions
are added at the embedding; optional QKV bias, sliding window) with a
circular-buffer KV cache for full and sliding-window decode.

The einsum path here is the oracle path and the decode path; the
full-sequence forward may take the hand-written flash kernel
(:mod:`repro_torch.kernels.flash_attention`) instead. The einsum path
masks by the temporal position (``positions[..., 0]`` under M-RoPE),
the kernel by ``arange``, as in ``repro``: the two differ where image
patches share a temporal position. MLA of ``repro.models.attention``
comes with its family.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.kernels.flash_attention import ops as flash_ops
from .common import ModelConfig, Params, apply_mrope, apply_rope, dense_init

NEG_INF = -1e30


# ----------------------------------------------------------------------
# Params
# ----------------------------------------------------------------------

def init_attention(cfg: ModelConfig, generator: Optional[torch.Generator],
                   device: torch.device, d_model: Optional[int] = None,
                   n_heads: Optional[int] = None,
                   n_kv_heads: Optional[int] = None,
                   head_dim: Optional[int] = None) -> Params:
    d = d_model or cfg.d_model
    h = n_heads or cfg.n_heads
    k = n_kv_heads or cfg.n_kv_heads
    hd = head_dim or cfg.head_dim
    p: Dict[str, Any] = {
        "w_q": dense_init(generator, (d, h * hd), device),
        "w_k": dense_init(generator, (d, k * hd), device),
        "w_v": dense_init(generator, (d, k * hd), device),
        "w_o": dense_init(generator, (h * hd, d), device),
    }
    if cfg.qkv_bias:
        p["b_q"] = torch.zeros((h * hd,), dtype=torch.float32, device=device)
        p["b_kv"] = torch.zeros((k * hd,), dtype=torch.float32, device=device)
        p["b_v"] = torch.zeros((k * hd,), dtype=torch.float32, device=device)
    return p


# ----------------------------------------------------------------------
# KV cache (circular buffer; window == buffer length)
# ----------------------------------------------------------------------

def init_kv_cache(batch: int, window: int, n_kv_heads: int, head_dim: int,
                  dtype, device: torch.device) -> Params:
    return {
        "k": torch.zeros((batch, window, n_kv_heads, head_dim), dtype=dtype,
                         device=device),
        "v": torch.zeros((batch, window, n_kv_heads, head_dim), dtype=dtype,
                         device=device),
        # absolute position held by each slot; -1 = empty
        "slot_pos": torch.full((batch, window), -1, dtype=torch.int32,
                               device=device),
        "next_pos": torch.zeros((), dtype=torch.int32, device=device),
    }


def _cache_write(cache: Params, names: Tuple[str, ...], values,
                 pos: torch.Tensor) -> Params:
    """Write one token (B, 1, ...) at slot ``pos % window``.

    Unlike ``repro``'s functional update, this writes IN PLACE into the
    cache's tensors (and returns the same dict): the decode state is
    owned by one caller, and copying every cache each step would double
    its traffic. ``pos`` is a 0-d tensor, so no value leaves the card."""
    window = cache["slot_pos"].shape[1]
    slot = (pos % window).to(torch.long).reshape(1)
    for name, val in zip(names, values):
        arr = cache[name]
        arr.index_copy_(1, slot, val.to(arr.dtype))
    b = cache["slot_pos"].shape[0]
    cache["slot_pos"].index_copy_(
        1, slot, pos.to(torch.int32).expand(b, 1).contiguous())
    cache["next_pos"].copy_(pos + 1)
    return cache


# ----------------------------------------------------------------------
# Core attention math
# ----------------------------------------------------------------------

def _gqa_scores_mask(q, k, q_pos, k_pos, window: int):
    """q: (B,S,H,D) k: (B,T,K,D); returns probabilities via fp32
    softmax with causal + sliding-window + validity masking."""
    b, s, h, d = q.shape
    t, kh = k.shape[1], k.shape[2]
    g = h // kh
    qg = q.reshape(b, s, kh, g, d)
    scores = torch.einsum("bskgd,btkd->bkgst", qg.float(),
                          k.float()) / math.sqrt(d)
    causal = k_pos[:, None, :] <= q_pos[:, :, None]           # (B,S,T)
    valid = k_pos[:, None, :] >= 0
    mask = causal & valid
    if window:
        mask &= (q_pos[:, :, None] - k_pos[:, None, :]) < window
    scores = torch.where(mask[:, None, None, :, :], scores,
                         torch.full((), NEG_INF, device=q.device))
    probs = torch.softmax(scores, dim=-1)
    return probs, g


def _gqa_attend(q, k, v, q_pos, k_pos, window: int) -> torch.Tensor:
    probs, g = _gqa_scores_mask(q, k, q_pos, k_pos, window)
    b, s, h, _ = q.shape
    dv = v.shape[-1]
    out = torch.einsum("bkgst,btkd->bskgd", probs, v.float())
    return out.reshape(b, s, h, dv).to(q.dtype)


# ----------------------------------------------------------------------
# GQA forward (train / prefill / decode)
# ----------------------------------------------------------------------

def attention_forward(cfg: ModelConfig, p: Params, x: torch.Tensor,
                      positions: torch.Tensor,
                      cache: Optional[Params] = None,
                      window: int = 0,
                      n_heads: Optional[int] = None,
                      n_kv_heads: Optional[int] = None,
                      head_dim: Optional[int] = None,
                      use_flash: bool = False
                      ) -> Tuple[torch.Tensor, Optional[Params]]:
    """positions: (B, S) absolute token positions, or (B, S, 3) for
    M-RoPE. cache=None -> full-sequence (train/prefill); cache given ->
    single-token decode (S == 1)."""
    h = n_heads or cfg.n_heads
    kh = n_kv_heads or cfg.n_kv_heads
    hd = head_dim or cfg.head_dim
    b, s, _ = x.shape

    q = x @ p["w_q"].to(x.dtype)
    k = x @ p["w_k"].to(x.dtype)
    v = x @ p["w_v"].to(x.dtype)
    if cfg.qkv_bias:
        q = q + p["b_q"].to(x.dtype)
        k = k + p["b_kv"].to(x.dtype)
        v = v + p["b_v"].to(x.dtype)
    q = q.reshape(b, s, h, hd)
    k = k.reshape(b, s, kh, hd)
    v = v.reshape(b, s, kh, hd)

    pos1 = positions[..., 0] if positions.dim() == 3 else positions
    if cfg.pos_type == "rope":
        q = apply_rope(q, pos1, cfg.rope_theta)
        k = apply_rope(k, pos1, cfg.rope_theta)
    elif cfg.pos_type == "mrope":
        pos3 = positions if positions.dim() == 3 else \
            positions[..., None].expand(*positions.shape, 3)
        q = apply_mrope(q, pos3, cfg.rope_theta, cfg.mrope_sections)
        k = apply_mrope(k, pos3, cfg.rope_theta, cfg.mrope_sections)
    elif cfg.pos_type not in ("none", "sinusoidal"):
        raise ValueError(f"pos_type {cfg.pos_type!r} is not ported yet")

    if cache is None:
        out = _flash_or_ref(cfg, q, k, v, pos1, pos1, window, use_flash)
        new_cache = None
    else:
        if s != 1:
            raise ValueError(f"decode expects one new token, got {s}")
        new_cache = _cache_write(cache, ("k", "v"), (k, v), pos1[0, 0])
        kc, vc = new_cache["k"], new_cache["v"]
        out = _gqa_attend(q, kc.to(q.dtype), vc.to(q.dtype),
                          pos1, new_cache["slot_pos"], window)
    out = out.reshape(b, s, h * hd) @ p["w_o"].to(x.dtype)
    return out, new_cache


def _flash_or_ref(cfg, q, k, v, q_pos, k_pos, window, use_flash):
    if use_flash:
        return flash_ops.flash_attention(q, k, v, causal=True,
                                         window=window or None)
    return _gqa_attend(q, k, v, q_pos, k_pos, window)
