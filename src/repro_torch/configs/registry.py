"""Importing this module registers every architecture of ``repro``:
the dense stack (llama3-8b, phi4-mini-3.8b, qwen1.5-110b, olmo-1b), its
vlm (qwen2-vl-7b, M-RoPE) and audio (musicgen-medium) variants,
zamba2-1.2b (Mamba2 and shared attention), the MoE family
(deepseek-v2-236b with MLA, llama4-scout-17b-a16e) and xlstm-1.3b
(sLSTM and mLSTM)."""
from . import (deepseek_v2_236b, llama3_8b,  # noqa: F401
               llama4_scout_17b_a16e, musicgen_medium, olmo_1b,
               phi4_mini_3_8b, qwen1_5_110b, qwen2_vl_7b, xlstm_1_3b,
               zamba2_1_2b)

ARCH_IDS = [
    "phi4-mini-3.8b", "llama3-8b", "deepseek-v2-236b", "qwen1.5-110b",
    "zamba2-1.2b", "llama4-scout-17b-a16e", "olmo-1b", "musicgen-medium",
    "xlstm-1.3b", "qwen2-vl-7b",
]
