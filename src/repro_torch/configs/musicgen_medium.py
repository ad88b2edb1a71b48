"""musicgen-medium [audio] — decoder-only transformer over EnCodec
tokens (4 codebooks, 2048 entries each), sinusoidal positions, GELU.
The EnCodec conv codec frontend is a STUB: input_specs() provides
precomputed frame embeddings / token streams.
[arXiv:2306.05284 — Simple and Controllable Music Generation]"""
from repro_torch.models.common import ModelConfig
from .base import register

CONFIG = register(ModelConfig(
    name="musicgen-medium",
    arch_type="audio",
    n_layers=48, d_model=1536, n_heads=24, n_kv_heads=24,
    d_ff=6144, vocab_size=2048, head_dim=64,
    norm_type="layernorm", act="gelu", pos_type="sinusoidal",
    n_codebooks=4,
    sliding_window=8192,
    long_context_mode="window",
    source="arXiv:2306.05284",
))
