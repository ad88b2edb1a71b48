"""xlstm-1.3b [ssm] — sLSTM + mLSTM blocks (7:1 mix), matrix memory.
d_ff=0: xLSTM blocks carry their own up/down projections.
[arXiv:2405.04517 — xLSTM: Extended Long Short-Term Memory]"""
from repro_torch.models.common import ModelConfig
from .base import register

CONFIG = register(ModelConfig(
    name="xlstm-1.3b",
    arch_type="ssm",
    n_layers=48, d_model=2048, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab_size=50_304, head_dim=512,
    norm_type="layernorm", act="gelu", pos_type="none",
    use_xlstm=True, slstm_every=8, xlstm_proj_factor=2.0,
    xlstm_qk_dim=256,
    long_context_mode="recurrent",  # O(1) recurrent state
    source="arXiv:2405.04517",
))
