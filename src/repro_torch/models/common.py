"""Shared model substrate: config dataclass, initializers, norms, rotary
(RoPE, M-RoPE) and sinusoidal position encodings, gated activations.

A module is an ``init_*`` returning a params tree (nested dicts of
tensors, with the same keys and stacking as ``repro``'s JAX pytrees) and
a plain function applying it. Initializers draw from an explicit
``torch.Generator``; ``None`` means PyTorch's default generator for the
device. Their numbers differ from ``jax.random``'s for the same seed, so
parity tests carry ``repro``'s parameters across with
``model.params_from_numpy``.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

Params = Any  # nested dict of tensors


# ----------------------------------------------------------------------
# Config
# ----------------------------------------------------------------------

@dataclass(frozen=True)
class ModelConfig:
    """One config covers all assigned architecture families; unused
    fields are inert for a given ``arch_type``."""

    name: str
    arch_type: str                 # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // n_heads

    # norm / activation / embedding
    norm_type: str = "rmsnorm"     # rmsnorm | layernorm | nonparametric_ln
    act: str = "swiglu"            # swiglu | gelu
    tie_embeddings: bool = False
    pos_type: str = "rope"         # rope | mrope | sinusoidal | none
    rope_theta: float = 10_000.0
    mrope_sections: Tuple[int, ...] = (16, 24, 24)   # qwen2-vl (t, h, w)
    qkv_bias: bool = False
    sliding_window: int = 0        # 0 = full attention

    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    moe_top_k: int = 1
    moe_d_ff: int = 0
    first_k_dense: int = 0
    # per-batch-row (hierarchical) dispatch keeps routing local to the
    # data shard — removes the global-sort all-gather (see ffn.py)
    moe_local_dispatch: bool = False
    capacity_factor: float = 1.25
    router_type: str = "softmax"   # softmax | sigmoid

    # MLA (DeepSeek-V2)
    use_mla: bool = False
    # absorbed-MLA decode (DeepSeek-V2 weight absorption): attend in the
    # compressed kv space instead of expanding k/v over the whole cache
    # every step — mathematically identical, O(r) per cached token.
    mla_absorb: bool = False
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128

    # SSM (Mamba2)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 128
    n_ssm_groups: int = 1

    # hybrid (Zamba2): shared attention block applied every k SSM layers
    shared_attn_every: int = 0

    # xLSTM
    use_xlstm: bool = False
    slstm_every: int = 8           # 7:1 mLSTM:sLSTM ratio
    xlstm_proj_factor: float = 2.0
    xlstm_qk_dim: int = 256        # per-head q/k width (mLSTM)

    # audio (MusicGen): EnCodec codebooks
    n_codebooks: int = 0

    # vlm (Qwen2-VL): stub vision frontend supplies patch embeddings
    vision_stub: bool = False

    # numerics / training
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    remat: str = "none"            # none | full
    # long-context decode mode: 'window' uses sliding-window KV cache,
    # 'recurrent' means O(1) state (ssm/xlstm), 'full' keeps everything
    long_context_mode: str = "window"

    # dry-run probe: disable scan-over-layers (XLA cost analysis counts
    # a scan body once; unrolled reduced-depth probes recover true
    # per-layer costs — see launch/dryrun.py)
    force_unscanned: bool = False

    # provenance
    source: str = ""

    def __post_init__(self) -> None:
        if self.head_dim == 0 and self.n_heads:
            object.__setattr__(self, "head_dim",
                               self.d_model // max(self.n_heads, 1))

    @property
    def activation_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def is_recurrent(self) -> bool:
        return self.arch_type == "ssm" or self.use_xlstm

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


# ----------------------------------------------------------------------
# Initializers
# ----------------------------------------------------------------------

def dense_init(generator: Optional[torch.Generator], shape: Sequence[int],
               device: torch.device, in_axis: int = -2,
               dtype=torch.float32) -> torch.Tensor:
    """Truncated-normal fan-in init (matches common LM practice)."""
    fan_in = shape[in_axis] if len(shape) > 1 else shape[0]
    w = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (w * (1.0 / math.sqrt(fan_in))).to(dtype)


def embed_init(generator: Optional[torch.Generator], shape: Sequence[int],
               device: torch.device, dtype=torch.float32) -> torch.Tensor:
    w = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    return (w.normal_(generator=generator) * 0.02).to(dtype)


# ----------------------------------------------------------------------
# Norms
# ----------------------------------------------------------------------

def init_norm(cfg: ModelConfig, device: torch.device,
              d: Optional[int] = None) -> Params:
    d = d or cfg.d_model
    if cfg.norm_type == "rmsnorm":
        return {"scale": torch.ones((d,), dtype=torch.float32, device=device)}
    if cfg.norm_type == "layernorm":
        return {"scale": torch.ones((d,), dtype=torch.float32, device=device),
                "bias": torch.zeros((d,), dtype=torch.float32, device=device)}
    if cfg.norm_type == "nonparametric_ln":   # OLMo
        return {}
    raise ValueError(cfg.norm_type)


def apply_norm(cfg: ModelConfig, p: Params, x: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    if cfg.norm_type == "rmsnorm":
        var = (xf * xf).mean(-1, keepdim=True)
        out = xf * torch.rsqrt(var + eps) * p["scale"]
    else:
        mu = xf.mean(-1, keepdim=True)
        var = xf.var(-1, keepdim=True, unbiased=False)
        out = (xf - mu) * torch.rsqrt(var + eps)
        if cfg.norm_type == "layernorm":
            out = out * p["scale"] + p["bias"]
    return out.to(x.dtype)


# ----------------------------------------------------------------------
# Rotary embeddings
# ----------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float,
               device: Optional[torch.device] = None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, D); positions: broadcastable to (..., S)."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                 # (D/2,)
    angles = positions[..., None].float() * freqs          # (..., S, D/2)
    angles = angles[..., None, :]                          # (..., S, 1, D/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor, theta: float,
                sections: Tuple[int, ...]) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE.

    x: (B, S, H, D); positions3: (B, S, 3) — (temporal, height, width)
    indices. The D/2 frequency slots are partitioned into ``sections``
    (t, h, w); each section rotates by its own position stream.
    """
    d = x.shape[-1]
    if sum(sections) != d // 2:
        raise ValueError(f"mrope sections {tuple(sections)} do not sum to "
                         f"head_dim / 2 = {d // 2}")
    freqs = rope_freqs(d, theta, x.device)                 # (D/2,)
    slot_pos = torch.cat(
        [positions3[..., i, None].float().expand(*positions3.shape[:-1], sec)
         for i, sec in enumerate(sections)], dim=-1)       # (B, S, D/2)
    angles = (slot_pos * freqs)[..., None, :]              # (B, S, 1, D/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(seq_len: int, d_model: int, offset=0,
                         device: Optional[torch.device] = None
                         ) -> torch.Tensor:
    """MusicGen-style sinusoidal embeddings, (S, D). ``offset``: an int
    or a 0-d tensor added to every position."""
    pos = torch.arange(seq_len, dtype=torch.float32, device=device) + offset
    half = d_model // 2
    freqs = torch.exp(-math.log(10_000.0)
                      * torch.arange(half, dtype=torch.float32,
                                     device=device) / half)
    ang = pos[:, None] * freqs[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ----------------------------------------------------------------------
# Activations
# ----------------------------------------------------------------------

def gated_act(cfg: ModelConfig, gate: torch.Tensor,
              up: torch.Tensor) -> torch.Tensor:
    if cfg.act == "swiglu":
        return F.silu(gate) * up
    if cfg.act == "gelu":
        # jax.nn.gelu defaults to the tanh approximation
        return F.gelu(gate, approximate="tanh") * up
    raise ValueError(cfg.act)
