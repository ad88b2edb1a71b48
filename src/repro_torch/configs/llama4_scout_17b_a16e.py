"""llama4-scout-17b-a16e [moe] — 16 experts, top-1 routing + shared
expert, early fusion. [hf:meta-llama/Llama-4-Scout-17B-16E]"""
from repro_torch.models.common import ModelConfig
from .base import register

CONFIG = register(ModelConfig(
    name="llama4-scout-17b-a16e",
    arch_type="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=8192,                      # (dense-equivalent hidden per expert)
    vocab_size=202_048, head_dim=128,
    norm_type="rmsnorm", act="swiglu", pos_type="rope",
    rope_theta=500_000.0,
    n_experts=16, n_shared_experts=1, moe_top_k=1, moe_d_ff=8192,
    capacity_factor=1.5, router_type="sigmoid",
    moe_local_dispatch=True,   # gather-only per-row dispatch (§Perf)
    sliding_window=8192,            # chunked-attention-like long mode
    long_context_mode="window",
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
))
