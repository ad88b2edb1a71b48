"""olmo-1b [dense] — non-parametric LayerNorm, SwiGLU.
[arXiv:2402.00838 — OLMo: Accelerating the Science of LMs]"""
from repro_torch.models.common import ModelConfig
from .base import register

CONFIG = register(ModelConfig(
    name="olmo-1b",
    arch_type="dense",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=8192, vocab_size=50_304, head_dim=128,
    norm_type="nonparametric_ln", act="swiglu", pos_type="rope",
    rope_theta=10_000.0,
    sliding_window=8192,
    long_context_mode="window",
    source="arXiv:2402.00838",
))
