"""zamba2-1.2b [hybrid] — Mamba2 backbone + shared attention block.
[arXiv:2411.15242 — Zamba2 suite]"""
from repro_torch.models.common import ModelConfig
from .base import register

CONFIG = register(ModelConfig(
    name="zamba2-1.2b",
    arch_type="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab_size=32_000, head_dim=64,
    norm_type="rmsnorm", act="swiglu", pos_type="rope",
    ssm_state=64, ssm_conv=4, ssm_expand=2, ssm_head_dim=64,
    ssm_chunk=128,
    shared_attn_every=6,           # shared (tied) attn block cadence
    sliding_window=8192,           # attention part in long context
    long_context_mode="recurrent", # SSM state is O(1); attn windowed
    source="arXiv:2411.15242",
))
