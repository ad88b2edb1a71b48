"""Attention variants: grouped-query attention (RoPE, M-RoPE or none;
sinusoidal positions are added at the embedding; optional QKV bias,
sliding window) and MLA (DeepSeek-V2 multi-head latent attention), with
a circular-buffer KV cache for full and sliding-window decode.

The einsum path here is the oracle path and the decode path; the
full-sequence forward may take the hand-written flash kernel
(:mod:`repro_torch.kernels.flash_attention`) instead. The einsum path
masks by the temporal position (``positions[..., 0]`` under M-RoPE),
the kernel by ``arange``, as in ``repro``: the two differ where image
patches share a temporal position. MLA's q/k width (nope + rope) differs
from its v width, so it runs the einsum path on every path, as in
``repro``.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.parallel.sharding import constrain, shard_map
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


def init_mla(cfg: ModelConfig, generator: Optional[torch.Generator],
             device: torch.device) -> Params:
    d, h = cfg.d_model, cfg.n_heads
    qk = cfg.qk_nope_dim + cfg.qk_rope_dim
    return {
        "w_dq": dense_init(generator, (d, cfg.q_lora_rank), device),
        "q_norm_scale": torch.ones((cfg.q_lora_rank,), dtype=torch.float32,
                                   device=device),
        "w_uq": dense_init(generator, (cfg.q_lora_rank, h * qk), device),
        "w_dkv": dense_init(generator,
                            (d, cfg.kv_lora_rank + cfg.qk_rope_dim), device),
        "kv_norm_scale": torch.ones((cfg.kv_lora_rank,),
                                    dtype=torch.float32, device=device),
        "w_ukv": dense_init(generator, (cfg.kv_lora_rank,
                                        h * (cfg.qk_nope_dim
                                             + cfg.v_head_dim)), device),
        "w_o": dense_init(generator, (h * cfg.v_head_dim, d), device),
    }


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


def init_mla_cache(cfg: ModelConfig, batch: int, window: int, dtype,
                   device: torch.device) -> Params:
    return {
        "c_kv": torch.zeros((batch, window, cfg.kv_lora_rank), dtype=dtype,
                            device=device),
        "k_rope": torch.zeros((batch, window, cfg.qk_rope_dim), dtype=dtype,
                              device=device),
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
    if isinstance(cache["slot_pos"], DTensor):
        return _cache_write_sharded(cache, names, values, pos)
    slot = (pos % window).to(torch.long).reshape(1)
    for name, val in zip(names, values):
        arr = cache[name]
        arr.index_copy_(1, slot, val.to(arr.dtype))
    b = cache["slot_pos"].shape[0]
    cache["slot_pos"].index_copy_(
        1, slot, pos.to(torch.int32).expand(b, 1).contiguous())
    cache["next_pos"].copy_(pos + 1)
    return cache


def _cache_write_sharded(cache: Params, names: Tuple[str, ...], values,
                         pos: torch.Tensor) -> Params:
    """``_cache_write`` for a cache of DTensors, as a masked select of
    the slot: each rank writes within its own shards, whichever dims
    are sharded (DTensor's in-place ``index_copy_`` leaves a wrong
    placement on its result). The dict gets the new tensors."""
    window = cache["slot_pos"].shape[1]
    hit = torch.arange(window, device=pos.device) == pos % window
    for name, val in zip(names, values):
        arr = cache[name]
        mask = hit.reshape((1, window) + (1,) * (arr.ndim - 2))
        cache[name] = torch.where(mask, val.to(arr.dtype), arr)
    cache["slot_pos"] = torch.where(hit[None], pos.to(torch.int32),
                                    cache["slot_pos"])
    cache["next_pos"] = (pos + 1).to(cache["next_pos"].dtype)
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
    """Attention of q (B,S,H,D) over k/v (B,T,K,D). On DTensors it runs
    on each rank's sequences and heads (``shard_map``)."""
    def attend(q, k, v, q_pos, k_pos):
        probs, g = _gqa_scores_mask(q, k, q_pos, k_pos, window)
        b, s, h, _ = q.shape
        dv = v.shape[-1]
        out = torch.einsum("bkgst,btkd->bskgd", probs, v.float())
        return out.reshape(b, s, h, dv).to(q.dtype)

    heads = ("batch", None, "heads", None)
    return shard_map(attend, (heads, heads, heads, ("batch", None),
                              ("batch", None)), heads)(q, k, v, q_pos, k_pos)


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
    q = constrain(q, "batch", "seq", "heads", "head_dim")
    k = constrain(k, "batch", "seq", "kv_heads", "head_dim")

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
        raise ValueError(f"unknown pos_type {cfg.pos_type!r}")

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
    out = constrain(out, "batch", "seq", "heads", "head_dim")
    out = out.reshape(b, s, h * hd) @ p["w_o"].to(x.dtype)
    return constrain(out, "batch", "seq", "embed"), new_cache


def _flash_or_ref(cfg, q, k, v, q_pos, k_pos, window, use_flash):
    if use_flash:
        return flash_ops.flash_attention(q, k, v, causal=True,
                                         window=window or None)
    return _gqa_attend(q, k, v, q_pos, k_pos, window)


# ----------------------------------------------------------------------
# MLA forward (DeepSeek-V2)
# ----------------------------------------------------------------------

def _rms(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
         ) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale).to(x.dtype)


def mla_forward(cfg: ModelConfig, p: Params, x: torch.Tensor,
                positions: torch.Tensor,
                cache: Optional[Params] = None,
                window: int = 0
                ) -> Tuple[torch.Tensor, Optional[Params]]:
    """cache=None -> full sequence; cache given -> one-token decode that
    writes the compressed ``c_kv`` and the shared rotary key in place,
    then either expands k/v over the cache (naive) or, with
    ``cfg.mla_absorb``, attends in the compressed space."""
    b, s, _ = x.shape
    h = cfg.n_heads
    nope, rope_d, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    pos1 = positions[..., 0] if positions.dim() == 3 else positions

    # queries through the low-rank bottleneck
    cq = _rms(x @ p["w_dq"].to(x.dtype), p["q_norm_scale"])
    q = (cq @ p["w_uq"].to(x.dtype)).reshape(b, s, h, nope + rope_d)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    q_rope = apply_rope(q_rope, pos1, cfg.rope_theta)
    q = torch.cat([q_nope, q_rope], dim=-1)
    q = constrain(q, "batch", "seq", "heads", "head_dim")

    # compressed kv + shared rotary key
    dkv = x @ p["w_dkv"].to(x.dtype)                # (B,S,lora+rope)
    c_kv = _rms(dkv[..., :cfg.kv_lora_rank], p["kv_norm_scale"])
    k_rope = apply_rope(dkv[..., None, cfg.kv_lora_rank:], pos1,
                        cfg.rope_theta)             # (B,S,1,rope)

    def expand_kv(c):
        kv = (c @ p["w_ukv"].to(x.dtype)).reshape(
            c.shape[0], c.shape[1], h, nope + vd)
        return kv[..., :nope], kv[..., nope:]

    def with_rope(k_nope, kr):
        return torch.cat([k_nope, kr.expand(*k_nope.shape[:3], rope_d)],
                         dim=-1)

    if cache is None:
        k_nope, v = expand_kv(c_kv)
        out = _gqa_attend(q, with_rope(k_nope, k_rope), v, pos1, pos1,
                          window)
        new_cache = None
    else:
        if s != 1:
            raise ValueError(f"decode expects one new token, got {s}")
        new_cache = _cache_write(cache, ("c_kv", "k_rope"),
                                 (c_kv, k_rope[:, :, 0, :]), pos1[0, 0])
        ckv_cache = new_cache["c_kv"].to(x.dtype)      # (B,T,r)
        kr_cache = new_cache["k_rope"].to(x.dtype)     # (B,T,rope)
        if not cfg.mla_absorb:
            k_nope, v = expand_kv(ckv_cache)
            out = _gqa_attend(q, with_rope(k_nope, kr_cache[:, :, None, :]),
                              v, pos1, new_cache["slot_pos"], window)
        else:
            out = _mla_absorbed(cfg, p, q_nope, q_rope, ckv_cache, kr_cache,
                                pos1, new_cache["slot_pos"], window)

    out = out.reshape(b, s, h * vd) @ p["w_o"].to(x.dtype)
    return constrain(out, "batch", "seq", "embed"), new_cache


def _mla_absorbed(cfg, p, q_nope, q_rope, ckv_cache, kr_cache, q_pos, k_pos,
                  window: int) -> torch.Tensor:
    """Absorbed decode: score and attend directly in the compressed c_kv
    space. q_nope.k_nope == (q_nope W_uk).c_kv, so this is the naive
    path's math at O(kv_lora) per cached token instead of re-expanding
    k/v over the whole cache each step."""
    h, r = cfg.n_heads, cfg.kv_lora_rank
    nope, rope_d, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    dt = q_nope.dtype
    w_ukv = p["w_ukv"].to(dt).reshape(r, h, nope + vd)
    w_uk, w_uv = w_ukv[..., :nope], w_ukv[..., nope:]
    q_c = torch.einsum("bshn,rhn->bshr", q_nope, w_uk)     # (B,1,H,r)
    scores = (torch.einsum("bshr,btr->bhst", q_c.float(), ckv_cache.float())
              + torch.einsum("bshp,btp->bhst", q_rope.float(),
                             kr_cache.float()))
    scores = scores / math.sqrt(nope + rope_d)
    mask = (k_pos[:, None, :] <= q_pos[:, :, None]) & (k_pos[:, None, :] >= 0)
    if window:
        mask &= (q_pos[:, :, None] - k_pos[:, None, :]) < window
    scores = torch.where(mask[:, None, :, :], scores,
                         torch.full((), NEG_INF, device=scores.device))
    probs = torch.softmax(scores, dim=-1)                  # (B,H,1,T)
    ctx = torch.einsum("bhst,btr->bshr", probs, ckv_cache.float())
    return torch.einsum("bshr,rhv->bshv", ctx, w_uv.float()).to(dt)
