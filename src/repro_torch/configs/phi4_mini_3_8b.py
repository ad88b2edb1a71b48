"""phi4-mini-3.8b [dense] — RoPE, SwiGLU, GQA, 200k vocab.
[arXiv:2412.08905 — Phi-4 Technical Report / phi-4-mini model card]"""
from repro_torch.models.common import ModelConfig
from .base import register

CONFIG = register(ModelConfig(
    name="phi4-mini-3.8b",
    arch_type="dense",
    n_layers=32, d_model=3072, n_heads=24, n_kv_heads=8,
    d_ff=8192, vocab_size=200_064, head_dim=128,
    norm_type="rmsnorm", act="swiglu", pos_type="rope",
    rope_theta=10_000.0,
    sliding_window=8192,          # long_500k decode variant only
    long_context_mode="window",
    source="arXiv:2412.08905",
))
