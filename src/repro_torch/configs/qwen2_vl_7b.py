"""qwen2-vl-7b [vlm] — M-RoPE (t/h/w sections), dynamic resolution.
The ViT vision encoder + projector is a STUB: input_specs() provides
precomputed patch embeddings spliced over image-placeholder tokens.
[arXiv:2409.12191 — Qwen2-VL]"""
from repro_torch.models.common import ModelConfig
from .base import register

CONFIG = register(ModelConfig(
    name="qwen2-vl-7b",
    arch_type="vlm",
    n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4,
    d_ff=18944, vocab_size=152_064, head_dim=128,
    norm_type="rmsnorm", act="swiglu", pos_type="mrope",
    rope_theta=1_000_000.0, mrope_sections=(16, 24, 24),
    qkv_bias=True, vision_stub=True,
    sliding_window=8192,
    long_context_mode="window",
    source="arXiv:2409.12191",
))
