"""llama3-8b [dense] — GQA kv=8, 128k vocab.
[arXiv:2407.21783 — The Llama 3 Herd of Models]"""
from repro_torch.models.common import ModelConfig
from .base import register

CONFIG = register(ModelConfig(
    name="llama3-8b",
    arch_type="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab_size=128_256, head_dim=128,
    norm_type="rmsnorm", act="swiglu", pos_type="rope",
    rope_theta=500_000.0,
    sliding_window=8192,
    long_context_mode="window",
    source="arXiv:2407.21783",
))
