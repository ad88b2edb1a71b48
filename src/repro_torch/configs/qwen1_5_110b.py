"""qwen1.5-110b [dense] — QKV bias (per Qwen1.5 family design).
[hf:Qwen/Qwen1.5-0.5B model card family]"""
from repro_torch.models.common import ModelConfig
from .base import register

CONFIG = register(ModelConfig(
    name="qwen1.5-110b",
    arch_type="dense",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=49152, vocab_size=152_064, head_dim=128,
    norm_type="rmsnorm", act="swiglu", pos_type="rope",
    rope_theta=1_000_000.0, qkv_bias=True,
    sliding_window=8192,
    long_context_mode="window",
    source="hf:Qwen/Qwen1.5-0.5B",
))
