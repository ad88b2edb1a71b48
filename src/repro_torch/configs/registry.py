"""Importing this module registers every architecture whose blocks the
port has: the dense stack (llama3-8b, phi4-mini-3.8b, qwen1.5-110b,
olmo-1b), its vlm (qwen2-vl-7b, M-RoPE) and audio (musicgen-medium)
variants, and zamba2-1.2b (Mamba2 and shared attention). The MoE and
xLSTM families of ``repro`` come with their blocks."""
from . import (llama3_8b, musicgen_medium, olmo_1b,  # noqa: F401
               phi4_mini_3_8b, qwen1_5_110b, qwen2_vl_7b, zamba2_1_2b)

ARCH_IDS = [
    "phi4-mini-3.8b", "llama3-8b", "qwen1.5-110b", "zamba2-1.2b",
    "olmo-1b", "musicgen-medium", "qwen2-vl-7b",
]
