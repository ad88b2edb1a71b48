"""Mamba2 SSD chunked scan as a hand-written CUDA kernel for Hopper (K5).

Replaces the Pallas kernel ``repro/kernels/ssd_scan/kernel.py::
ssd_scan_kernel`` (``_ssd_kernel``), whose grid walks the chunks of one
(batch, head) in order and carries the (P, N) fp32 state in VMEM.
:func:`ssd_scan` launches the kernel for CUDA tensors and takes the
plain version, :func:`ssd_scan_plain` (the chunked oracle
``ssd_reference``), only for CPU tensors; nothing falls back. The
launch counter is ``ssd_scan.launches``.

The kernel is CUDA C++ in ``repro_torch/csrc/ssd_scan.cu``, compiled
with ``nvcc`` for ``sm_90a`` at first use and bound with ctypes. Bound
on an H100 SXM: operations. Per chunk of Q steps it needs
Q·(Q+1)·(N+P) FLOP for the causal half of the Q x Q products, the only
half it computes, plus 4·Q·N·P for the state, against 4·(2P + 2N)
bytes a step. So at the zamba2 shape (Q 128, P = N = 64, B 2, S 4096,
64 heads) 17.2 GFLOP of fp32 work bound it at 0.26 ms on the 67 TFLOP/s
CUDA cores, above the 0.16 ms that its 0.54 GB of bytes need. The design runs the chunk loop
inside one block per (head, batch) — the TPU's sequential grid axis —
with the chunk's x, B, C, its Q x Q matrix and the carried state in
dynamic shared memory, so nothing but inputs, y and the final state
touches device memory. Its B·H blocks (128 at batch 2) leave some of
the 132 SMs idle; a two-pass scan is later work.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from .._build import Library, stream_of
from . import ref

SOURCE = "ssd_scan.cu"                 # in repro_torch/csrc
_TYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _lib() -> Library:
    p, i = ctypes.c_void_p, ctypes.c_int
    return Library(SOURCE, {"ssd_scan_launch": [p] * 8 + [i] * 7 + [p]})


def ssd_scan_plain(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                   b: torch.Tensor, c: torch.Tensor, chunk: int = 64,
                   d_skip: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`ssd_scan`: the chunked oracle."""
    return ref.ssd_reference(x, dt, a, b, c, chunk=chunk, d_skip=d_skip)


def _check_args(x, dt, a, b, c, d_skip, chunk) -> None:
    named = dict(x=x, dt=dt, a=a, b=b, c=c)
    if d_skip is not None:
        named["d_skip"] = d_skip
    for name, t in named.items():
        if t.device.type != "cuda":
            raise ValueError(f"ssd_scan takes all tensors on the CPU or all "
                             f"on a CUDA device; {name} is on {t.device}")
    if x.dtype not in _TYPES or b.dtype != x.dtype or c.dtype != x.dtype:
        raise ValueError("the CUDA ssd_scan takes x, b, c of one type, fp32 "
                         f"or bf16, got {x.dtype}, {b.dtype}, {c.dtype}")
    for name in ("dt", "a", "d_skip"):
        if name in named and named[name].dtype != torch.float32:
            raise ValueError(f"the CUDA ssd_scan takes {name} in fp32, got "
                             f"{named[name].dtype}")
    if x.dim() != 4 or b.dim() != 4:
        raise ValueError(f"ssd_scan takes x (B, S, H, P) and b, c "
                         f"(B, S, H, N), got {tuple(x.shape)}, "
                         f"{tuple(b.shape)}")
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    if (c.shape != b.shape or b.shape[:3] != x.shape[:3]
            or dt.shape != x.shape[:3] or a.shape != (h,)
            or (d_skip is not None and d_skip.shape != (h,))):
        raise ValueError(
            f"ssd_scan shapes disagree: x {tuple(x.shape)}, dt "
            f"{tuple(dt.shape)}, a {tuple(a.shape)}, b {tuple(b.shape)}, "
            f"c {tuple(c.shape)}")
    if chunk < 1 or s % chunk:
        raise ValueError(f"ssd_scan needs the sequence length to be a "
                         f"multiple of the chunk: S = {s}, chunk = {chunk}")


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             b: torch.Tensor, c: torch.Tensor, chunk: int = 64,
             d_skip: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Same contract as ``ref.ssd_reference`` with no initial state.
    x: (B,S,H,P); dt: (B,S,H); a: (H,); b,c: (B,S,H,N); d_skip: (H,) or
    None; S % chunk == 0. Returns y (B,S,H,P) in x's type and the final
    state (B,H,P,N) in fp32. Strided inputs are copied contiguous for
    the kernel."""
    if x.device.type == "cpu":
        return ssd_scan_plain(x, dt, a, b, c, chunk=chunk, d_skip=d_skip)
    x, dt, a, b, c = (t.contiguous() for t in (x, dt, a, b, c))
    if d_skip is not None:
        d_skip = d_skip.contiguous()
    _check_args(x, dt, a, b, c, d_skip, chunk)
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    y = torch.empty_like(x)
    state = torch.empty((bsz, h, p, n), dtype=torch.float32, device=x.device)
    if state.numel() == 0:
        return y, state
    _lib().launch(
        "ssd_scan_launch", x.data_ptr(), dt.data_ptr(), a.data_ptr(),
        b.data_ptr(), c.data_ptr(),
        None if d_skip is None else d_skip.data_ptr(), y.data_ptr(),
        state.data_ptr(), bsz, s, h, p, n, chunk, _TYPES[x.dtype],
        stream_of(x),
        context=f"S = {s}, chunk = {chunk}, P = {p}, N = {n}; a block keeps "
        f"one chunk in shared memory, so a long chunk can ask for more than "
        f"the card allows")
    ssd_scan.launches += 1
    return y, state


ssd_scan.launches = 0

KERNELS = (ssd_scan,)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in KERNELS}
