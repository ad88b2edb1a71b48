"""deepseek-v2-236b [moe] — MLA (kv_lora=512), 2 shared + 160 routed
top-6 experts, first layer dense. [arXiv:2405.04434 — DeepSeek-V2]"""
from repro_torch.models.common import ModelConfig
from .base import register

CONFIG = register(ModelConfig(
    name="deepseek-v2-236b",
    arch_type="moe",
    n_layers=60, d_model=5120, n_heads=128, n_kv_heads=128,
    d_ff=12288,                    # dense FFN of the first layer
    vocab_size=102_400,
    head_dim=192,                  # qk_nope (128) + qk_rope (64)
    norm_type="rmsnorm", act="swiglu", pos_type="rope",
    rope_theta=10_000.0,
    use_mla=True, q_lora_rank=1536, kv_lora_rank=512,
    qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128,
    n_experts=160, n_shared_experts=2, moe_top_k=6, moe_d_ff=1536,
    first_k_dense=1, capacity_factor=1.25, router_type="softmax",
    sliding_window=8192,
    long_context_mode="window",
    source="arXiv:2405.04434",
))
