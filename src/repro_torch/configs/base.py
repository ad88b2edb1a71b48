"""Config helpers: smoke-variant reduction and the config registry."""
from __future__ import annotations

from typing import Dict

from repro_torch.models.common import ModelConfig


def smoke_variant(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Reduced same-family variant for CPU smoke tests: 2 layers,
    d_model <= 512, <= 4 experts, tiny vocab — structure preserved."""
    kw = dict(
        name=cfg.name + "-smoke",
        n_layers=2,
        d_model=256,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads
        else 4,
        head_dim=64,
        d_ff=512 if cfg.d_ff else 0,
        vocab_size=512,
        dtype="float32",
    )
    if cfg.n_experts:
        kw.update(n_experts=4, moe_top_k=min(cfg.moe_top_k, 2),
                  moe_d_ff=128,
                  n_shared_experts=min(cfg.n_shared_experts, 1),
                  first_k_dense=min(cfg.first_k_dense, 1))
    if cfg.use_mla:
        kw.update(q_lora_rank=96, kv_lora_rank=64, qk_nope_dim=32,
                  qk_rope_dim=16, v_head_dim=32, head_dim=48)
    if cfg.ssm_state:
        kw.update(ssm_state=16, ssm_head_dim=32, ssm_chunk=16)
    if cfg.arch_type == "ssm":      # xlstm
        kw.update(slstm_every=2, xlstm_qk_dim=32)
    if cfg.arch_type == "hybrid":
        kw.update(shared_attn_every=2)
    if cfg.pos_type == "mrope":
        kw.update(mrope_sections=(8, 12, 12))   # sums to head_dim/2 = 32
    if cfg.sliding_window:
        kw.update(sliding_window=32)
    kw.update(overrides)
    return cfg.replace(**kw)


_REGISTRY: Dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    from . import registry  # noqa: F401  (populates _REGISTRY)
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch '{name}'; the configurations are "
                       f"{sorted(_REGISTRY)}")
    return _REGISTRY[name]


def all_configs() -> Dict[str, ModelConfig]:
    from . import registry  # noqa: F401
    return dict(_REGISTRY)
