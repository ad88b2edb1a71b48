"""Blockwise (flash) causal attention as a hand-written CUDA kernel for
Hopper (K4).

Replaces the Pallas kernel ``repro/kernels/flash_attention/kernel.py::
flash_attention`` (``_flash_kernel``): causal attention with an optional
sliding window and GQA (kv head = h // (H // KH)), an online softmax
with fp32 running max, sum and accumulator, and positions ``arange``.
:func:`flash_attention` launches the kernel for CUDA tensors and takes
the plain version, :func:`flash_attention_plain` (the oracle's einsum
and softmax), only for CPU tensors; nothing falls back. The launch
counter is ``flash_attention.launches``.

The kernel is CUDA C++ in ``repro_torch/csrc/flash_attention.cu``,
compiled with ``nvcc`` for ``sm_90a`` at first use and bound with
ctypes. Bound on an H100 SXM: operations. At the zamba2 prefill shape
(B 2, S 4096, 32 heads of 64) the causal half of 4·B·H·S²·D is 0.14
TFLOP against 268 MB of q, k, v and out (fp32), so fp32 work at the 67
TFLOP/s CUDA-core rate bounds it at 2.05 ms, and bf16 work at the 989
TFLOP/s tensor-core rate at 0.14 ms. Both kernels take one block per
q tile of a (batch, head), stage k/v tiles of 64 rows with ``cp.async``
and skip k tiles that the diagonal or the window masks wholly. bf16
runs both products on the tensor cores (``mma.sync`` m16n8k16, fp32
accumulators; 4 warps of 32 q rows, Q's fragments held in registers, P
fed from registers as the A operand of P·V, k/v double-buffered). fp32
stays fp32 FMAs on the CUDA cores (no TF32: the parity tolerance is
1e-5), register-tiled: an 8 x 4 score tile and an 8 x D/16 output tile
per thread, fed by float4 reads of shared memory at under 0.25 loads
per FMA.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .._build import (Library, aligned, count_launch, load_once,
                      refuse_autograd, stream_of)
from . import ref

SOURCE = "flash_attention.cu"          # in repro_torch/csrc
HEAD_DIMS = (32, 64, 128)              # the kernel's instantiations
_TYPES = {torch.float32: 0, torch.bfloat16: 1}


@load_once
def _lib() -> Library:
    p, i = ctypes.c_void_p, ctypes.c_int
    return Library(SOURCE, {
        "flash_attention_launch": [p, p, p, p] + [i] * 9 + [p]})


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True,
                          window: Optional[int] = None) -> torch.Tensor:
    """Plain version of :func:`flash_attention`: the oracle's fp32
    einsum and softmax over the whole (S, T) score matrix."""
    return ref.attention_reference(q, k, v, causal=causal, window=window)


def _check_args(q, k, v) -> None:
    if not (q.device.type == k.device.type == v.device.type == "cuda"):
        raise ValueError("flash_attention takes q, k, v all on the CPU or "
                         f"all on a CUDA device, got {q.device}, {k.device}, "
                         f"{v.device}")
    if q.dtype not in _TYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("the CUDA flash_attention takes fp32 or bf16 q, k "
                         f"and v of one type, got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError("flash_attention takes q (B, S, H, D) and k, v "
                         f"(B, T, KH, D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, _, h, d = q.shape
    kb, _, kh, kd = k.shape
    if kb != b or kd != d or kh == 0 or h % kh:
        raise ValueError(f"q {tuple(q.shape)} and k/v {tuple(k.shape)} "
                         "disagree on batch or head width, or H % KH != 0")
    if d not in HEAD_DIMS:
        raise ValueError(f"the CUDA flash_attention takes head widths "
                         f"{HEAD_DIMS}, got {d}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """q: (B, S, H, D); k, v: (B, T, KH, D) with H % KH == 0. Returns
    (B, S, H, D) in q's type. Positions are ``arange``; ``window`` None
    or <= 0 means no window. Strided inputs are copied contiguous for
    the kernel. On the card it raises ``RuntimeError`` when grad mode is
    on and an input requires grad (the kernel has no backward); the
    plain version on the CPU is differentiable."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    refuse_autograd("flash_attention", q, k, v)
    q, k, v = (aligned(t) for t in (q, k, v))
    _check_args(q, k, v)
    b, s, h, d = q.shape
    t, kh = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    _lib().launch(
        "flash_attention_launch", q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), b, s, t, h, kh, d, int(causal), int(window or 0),
        _TYPES[q.dtype], stream_of(q))
    count_launch(flash_attention)
    return out


flash_attention.launches = 0

KERNELS = (flash_attention,)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in KERNELS}
