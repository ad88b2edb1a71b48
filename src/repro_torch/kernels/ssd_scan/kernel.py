"""Mamba2 SSD chunked scan as a hand-written CUDA kernel for Hopper (K5).

Replaces the Pallas kernel ``repro/kernels/ssd_scan/kernel.py::
ssd_scan_kernel`` (``_ssd_kernel``), whose grid walks the chunks of one
(batch, head) in order and carries the (P, N) fp32 state in VMEM.
:func:`ssd_scan` launches the kernel for CUDA tensors and takes the
plain version, :func:`ssd_scan_plain` (the chunked oracle
``ssd_reference``), only for CPU tensors; nothing falls back. The
launch counter is ``ssd_scan.launches``: one a call, though a call
issues four CUDA launches.

B and C come either per head, (B, S, H, N), or per group, (B, S, G, N)
with H % G == 0, head h reading group h // (H // G). The kernel reads
them per group, so the model hands them over without broadcasting them
to the heads; the plain version broadcasts and then runs the oracle.

The kernel is CUDA C++ in ``repro_torch/csrc/ssd_scan.cu``, compiled
with ``nvcc`` for ``sm_90a`` at first use and bound with ctypes. Bound
on an H100 SXM: operations. Per chunk of Q steps and head it needs
Q·(Q+1)·(N+P) FLOP for the causal half of the Q x Q products, the only
half it computes, plus 4·Q·N·P for the state. So at the zamba2 shape
(Q 128, P = N = 64, B 2, S 4096, 64 heads, one group) 17.2 GFLOP of
fp32 work bound it at 0.257 ms on the 67 TFLOP/s CUDA cores, above the
0.08 ms its bytes need. The design is chunk-parallel, the
decomposition of the oracle in four launches: each chunk's local state
(one block per chunk, head and batch: 4096 at that shape); B and C
transposed once per group; a scan over chunks that leaves the state
entering each chunk in an fp32 scratch of B·H·(S/Q)·N·P values (67 MB
there); and each chunk's output (again one block per chunk). Every
product is a 4 x 4 register tile per thread from float4 reads of shared
memory, 0.125 loads per FMA, over the causal tiles only; a block holds
66.5 KB (state) or 100 KB (output) of shared memory, so two fit on an
SM. A chunk is refused when its output block would keep more than
Q·P = 8192 values of y in registers or ask for more shared memory than
the card has.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .._build import (Library, aligned, count_launch, load_once,
                      refuse_autograd, stream_of)
from . import ref

SOURCE = "ssd_scan.cu"                 # in repro_torch/csrc
_TYPES = {torch.float32: 0, torch.bfloat16: 1}


@load_once
def _lib() -> Library:
    p, i = ctypes.c_void_p, ctypes.c_int
    return Library(SOURCE, {"ssd_scan_launch": [p] * 11 + [i] * 8 + [p]})


def _groups(b: torch.Tensor, heads: int) -> int:
    """The number of groups of B or C, (B, S, G, N); raises unless it
    divides the heads."""
    g = b.shape[2] if b.dim() == 4 else 0
    if g == 0 or heads % g:
        raise ValueError(f"ssd_scan takes b, c per head or per group, "
                         f"(B, S, G, N) with H % G == 0: H = {heads}, b "
                         f"{tuple(b.shape)}")
    return g


def ssd_scan_plain(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                   b: torch.Tensor, c: torch.Tensor, chunk: int = 64,
                   d_skip: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`ssd_scan`: B and C broadcast to the heads,
    then the chunked oracle."""
    h = x.shape[2]
    g = _groups(b, h)
    if c.shape != b.shape:
        raise ValueError(f"ssd_scan takes b and c of one shape, got "
                         f"{tuple(b.shape)}, {tuple(c.shape)}")
    if g != h:
        b = torch.repeat_interleave(b, h // g, dim=2)
        c = torch.repeat_interleave(c, h // g, dim=2)
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
                         f"(B, S, G, N), got {tuple(x.shape)}, "
                         f"{tuple(b.shape)}")
    bsz, s, h, p = x.shape
    _groups(b, h)
    if (c.shape != b.shape or b.shape[:2] != x.shape[:2]
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
    """Same contract as ``ref.ssd_reference`` with no initial state,
    with B and C per head or per group.
    x: (B,S,H,P); dt: (B,S,H); a: (H,); b,c: (B,S,G,N) with H % G == 0
    (G == H: per head); d_skip: (H,) or None; S % chunk == 0. Returns y
    (B,S,H,P) in x's type and the final state (B,H,P,N) in fp32.
    Strided inputs are copied contiguous for the kernel. On the card it
    raises ``RuntimeError`` when grad mode is on and an input requires
    grad (the kernel has no backward); the plain version on the CPU is
    differentiable."""
    if x.device.type == "cpu":
        return ssd_scan_plain(x, dt, a, b, c, chunk=chunk, d_skip=d_skip)
    refuse_autograd("ssd_scan", x, dt, a, b, c, d_skip)
    x, b, c = (aligned(t) for t in (x, b, c))
    dt, a = dt.contiguous(), a.contiguous()
    if d_skip is not None:
        d_skip = d_skip.contiguous()
    _check_args(x, dt, a, b, c, d_skip, chunk)
    bsz, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    y = torch.empty_like(x)
    state = torch.empty((bsz, h, p, n), dtype=torch.float32, device=x.device)
    if state.numel() == 0 or s == 0:
        return y, state.zero_()
    k = s // chunk
    # the state entering each chunk (N, P), and each chunk's cum_last
    states = torch.empty((bsz, h, k, n, p), dtype=torch.float32,
                         device=x.device)
    totals = torch.empty((bsz, h, k), dtype=torch.float32, device=x.device)
    # B and C transposed per chunk, (N, chunk), in fp32
    bct = torch.empty((2, bsz, g, k, n, chunk), dtype=torch.float32,
                      device=x.device)
    _lib().launch(
        "ssd_scan_launch", x.data_ptr(), dt.data_ptr(), a.data_ptr(),
        b.data_ptr(), c.data_ptr(),
        None if d_skip is None else d_skip.data_ptr(), y.data_ptr(),
        state.data_ptr(), states.data_ptr(), totals.data_ptr(),
        bct.data_ptr(), bsz, s, h,
        g, p, n, chunk, _TYPES[x.dtype], stream_of(x),
        context=f"S = {s}, chunk = {chunk}, P = {p}, N = {n}; a block keeps "
        f"one chunk's B, C and masked matrix in shared memory and its y in "
        f"registers (chunk x P <= 8192), so a long chunk can ask for more "
        f"than the card allows")
    count_launch(ssd_scan)
    return y, state


ssd_scan.launches = 0

KERNELS = (ssd_scan,)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in KERNELS}
