"""Importing this module registers every architecture whose blocks the
port has: the dense stack (llama3-8b, phi4-mini-3.8b, qwen1.5-110b,
olmo-1b), its vlm (qwen2-vl-7b, M-RoPE) and audio (musicgen-medium)
variants, zamba2-1.2b (Mamba2 and shared attention) and the MoE family
(deepseek-v2-236b with MLA, llama4-scout-17b-a16e). The xLSTM family of
``repro`` comes with its blocks."""
from . import (deepseek_v2_236b, llama3_8b,  # noqa: F401
               llama4_scout_17b_a16e, musicgen_medium, olmo_1b,
               phi4_mini_3_8b, qwen1_5_110b, qwen2_vl_7b, zamba2_1_2b)

ARCH_IDS = [
    "phi4-mini-3.8b", "llama3-8b", "deepseek-v2-236b", "qwen1.5-110b",
    "zamba2-1.2b", "llama4-scout-17b-a16e", "olmo-1b", "musicgen-medium",
    "qwen2-vl-7b",
]
