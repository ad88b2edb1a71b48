"""Per-layer blocks with a uniform (init_layer / apply_layer /
init_layer_state) interface so model.py can loop over stacked layer
params regardless of family.

Kinds:
  dense        — norm -> attention (GQA) -> norm -> gated FFN
  shared_attn  — the same block, shared by the groups of a hybrid stack
  moe          — norm -> attention (GQA or MLA) -> norm -> MoE FFN
  moe_dense    — the same with a gated FFN (DeepSeek's first-k-dense)
  mamba        — norm -> Mamba2 mixer
  mlstm/slstm  — norm -> xLSTM mixer
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .attention import (attention_forward, init_attention, init_kv_cache,
                        init_mla, init_mla_cache, mla_forward)
from .common import ModelConfig, Params, apply_norm, init_norm
from .ffn import ffn_forward, init_ffn, init_moe, moe_forward
from .ssm import init_mamba2, init_mamba_state, mamba2_forward
from .xlstm import (init_mlstm, init_mlstm_state, init_slstm,
                    init_slstm_state, mlstm_forward, slstm_forward)


def init_layer(cfg: ModelConfig, generator: Optional[torch.Generator],
               device: torch.device, kind: str) -> Params:
    if kind in ("dense", "shared_attn"):
        return {
            "ln1": init_norm(cfg, device), "ln2": init_norm(cfg, device),
            "attn": init_attention(cfg, generator, device),
            "ffn": init_ffn(cfg, generator, device),
        }
    if kind in ("moe", "moe_dense"):
        attn = (init_mla(cfg, generator, device) if cfg.use_mla
                else init_attention(cfg, generator, device))
        p = {"ln1": init_norm(cfg, device), "ln2": init_norm(cfg, device),
             "attn": attn}
        if kind == "moe":
            p["moe"] = init_moe(cfg, generator, device)
        else:
            p["ffn"] = init_ffn(cfg, generator, device, d_ff=cfg.d_ff or (
                cfg.moe_d_ff * (cfg.n_shared_experts + cfg.moe_top_k)))
        return p
    if kind == "mamba":
        return {"ln1": init_norm(cfg, device),
                "mixer": init_mamba2(cfg, generator, device)}
    if kind == "mlstm":
        return {"ln1": init_norm(cfg, device),
                "mixer": init_mlstm(cfg, generator, device)}
    if kind == "slstm":
        return {"ln1": init_norm(cfg, device),
                "mixer": init_slstm(cfg, generator, device)}
    raise ValueError(kind)


def init_layer_state(cfg: ModelConfig, kind: str, batch: int, window: int,
                     dtype, device: torch.device) -> Optional[Params]:
    """Decode-time state for one layer."""
    if kind in ("dense", "shared_attn"):
        return init_kv_cache(batch, window, cfg.n_kv_heads, cfg.head_dim,
                             dtype, device)
    if kind in ("moe", "moe_dense"):
        if cfg.use_mla:
            return init_mla_cache(cfg, batch, window, dtype, device)
        return init_kv_cache(batch, window, cfg.n_kv_heads, cfg.head_dim,
                             dtype, device)
    if kind == "mamba":
        return init_mamba_state(cfg, batch, dtype, device)
    if kind == "mlstm":
        return init_mlstm_state(cfg, batch, device)
    if kind == "slstm":
        return init_slstm_state(cfg, batch, device)
    raise ValueError(kind)


def apply_layer(cfg: ModelConfig, p: Params, x: torch.Tensor,
                positions: torch.Tensor, kind: str,
                state: Optional[Params] = None, window: int = 0,
                use_kernel: bool = False
                ) -> Tuple[torch.Tensor, Optional[Params], torch.Tensor]:
    """Returns (x_out, new_state, aux_loss)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if kind in ("dense", "shared_attn", "moe", "moe_dense"):
        h = apply_norm(cfg, p["ln1"], x)
        if cfg.use_mla and kind in ("moe", "moe_dense"):
            att, new_state = mla_forward(cfg, p["attn"], h, positions,
                                         cache=state, window=window)
        else:
            att, new_state = attention_forward(cfg, p["attn"], h, positions,
                                               cache=state, window=window,
                                               use_flash=use_kernel)
        x = x + att
        h = apply_norm(cfg, p["ln2"], x)
        if kind == "moe":
            ff, aux = moe_forward(cfg, p["moe"], h)
        else:
            ff = ffn_forward(cfg, p["ffn"], h)
        return x + ff, new_state, aux
    if kind == "mamba":
        h = apply_norm(cfg, p["ln1"], x)
        out, new_state = mamba2_forward(cfg, p["mixer"], h, state=state,
                                        use_kernel=use_kernel)
        return x + out, new_state, aux
    if kind == "mlstm":
        h = apply_norm(cfg, p["ln1"], x)
        out, new_state = mlstm_forward(cfg, p["mixer"], h, state=state)
        return x + out, new_state, aux
    if kind == "slstm":
        h = apply_norm(cfg, p["ln1"], x)
        out, new_state = slstm_forward(cfg, p["mixer"], h, state=state)
        return x + out, new_state, aux
    raise ValueError(kind)
