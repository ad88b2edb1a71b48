"""Mamba2 mixer layer (chunked SSD) with O(1) recurrent decode state.

Used by the zamba2 configs ('hybrid' arch type). The full-sequence
scan goes through :mod:`repro_torch.kernels.ssd_scan` when
``use_kernel`` is set (the hand-written CUDA kernel on the card),
otherwise through the chunked oracle.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan import ref as ssd
from .common import ModelConfig, Params, dense_init


def mamba_dims(cfg: ModelConfig) -> Tuple[int, int, int, int]:
    d_inner = cfg.ssm_expand * cfg.d_model
    n_heads = d_inner // cfg.ssm_head_dim
    return d_inner, n_heads, cfg.ssm_state, cfg.n_ssm_groups


def init_mamba2(cfg: ModelConfig, generator: Optional[torch.Generator],
                device: torch.device) -> Params:
    d = cfg.d_model
    di, h, n, g = mamba_dims(cfg)
    conv_ch = di + 2 * g * n
    conv_w = torch.empty((cfg.ssm_conv, conv_ch), dtype=torch.float32,
                         device=device)
    return {
        # order: [z (gate), x, B, C, dt]
        "in_proj": dense_init(generator, (d, 2 * di + 2 * g * n + h), device),
        "conv_w": conv_w.normal_(generator=generator) * 0.1,
        "conv_b": torch.zeros((conv_ch,), dtype=torch.float32, device=device),
        "dt_bias": torch.zeros((h,), dtype=torch.float32, device=device),
        "a_log": torch.log(torch.linspace(1.0, 16.0, h, dtype=torch.float32,
                                          device=device)),
        "d_skip": torch.ones((h,), dtype=torch.float32, device=device),
        "norm_scale": torch.ones((di,), dtype=torch.float32, device=device),
        "out_proj": dense_init(generator, (di, d), device),
    }


def _causal_depthwise_conv(x: torch.Tensor, w: torch.Tensor,
                           b: torch.Tensor) -> torch.Tensor:
    """x: (B, S, C); w: (K, C) depthwise causal conv."""
    k = w.shape[0]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(k):  # k is tiny (4): unrolled taps, no conv op needed
        out = out + xp[:, i:i + x.shape[1], :].float() * w[i].float()
    return (out + b.float()).to(x.dtype)


def _gated_rmsnorm(x: torch.Tensor, gate: torch.Tensor, scale: torch.Tensor,
                   eps: float = 1e-6) -> torch.Tensor:
    xf = (x * F.silu(gate.float()).to(x.dtype)).float()
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale).to(x.dtype)


def _split_proj(cfg: ModelConfig, zxbcdt: torch.Tensor):
    di, h, n, g = mamba_dims(cfg)
    return torch.split(zxbcdt, [di, di, g * n, g * n, h], dim=-1)


def init_mamba_state(cfg: ModelConfig, batch: int, dtype,
                     device: torch.device) -> Params:
    di, h, n, g = mamba_dims(cfg)
    return {
        "ssm": torch.zeros((batch, h, cfg.ssm_head_dim, n),
                           dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, di + 2 * g * n),
                            dtype=dtype, device=device),
    }


def mamba2_forward(cfg: ModelConfig, p: Params, x: torch.Tensor,
                   state: Optional[Params] = None,
                   use_kernel: bool = False
                   ) -> Tuple[torch.Tensor, Optional[Params]]:
    """x: (B, S, D). state=None -> full sequence; else single-token."""
    b, s, _ = x.shape
    di, h, n, g = mamba_dims(cfg)
    hp = cfg.ssm_head_dim

    zxbcdt = x @ p["in_proj"].to(x.dtype)
    z, xc, bc, cc, dt_pre = _split_proj(cfg, zxbcdt)
    conv_in = torch.cat([xc, bc, cc], dim=-1)

    if state is None:
        conv_out = _causal_depthwise_conv(conv_in, p["conv_w"], p["conv_b"])
        new_state = None
    else:
        if s != 1:
            raise ValueError(f"decode expects one new token, got {s}")
        hist = torch.cat([state["conv"], conv_in], dim=1)
        out = torch.einsum("bkc,kc->bc", hist.float(), p["conv_w"].float()) \
            + p["conv_b"].float()
        conv_out = out[:, None, :].to(x.dtype)
        new_state = {"conv": hist[:, 1:, :]}

    conv_out = F.silu(conv_out.float()).to(x.dtype)
    xs, bs, cs = torch.split(conv_out, [di, g * n, g * n], dim=-1)
    xs = xs.reshape(b, s, h, hp)
    bs, cs = bs.reshape(b, s, g, n), cs.reshape(b, s, g, n)
    dt = F.softplus(dt_pre.float() + p["dt_bias"].float())
    a = -torch.exp(p["a_log"].float())

    if state is None and use_kernel:
        # The kernel reads B and C per group. It takes the configured
        # chunk unchanged, as repro does: S must be a multiple of it
        # (ssd_scan raises).
        y, _ = ssd_ops.ssd_scan(xs, dt, a, bs, cs, chunk=cfg.ssm_chunk,
                                d_skip=p["d_skip"])
    else:
        # group-broadcast B, C to heads
        bs = torch.repeat_interleave(bs, h // g, dim=2)
        cs = torch.repeat_interleave(cs, h // g, dim=2)
        if state is None:
            # pick the largest chunk that divides S
            chunk = max(c for c in (cfg.ssm_chunk, 64, 32, 16, 8, 4, 2, 1)
                        if s % c == 0 and c <= s)
            y, _ = ssd.ssd_reference(xs, dt, a, bs, cs, chunk=chunk,
                                     d_skip=p["d_skip"])
        else:
            y, new_ssm = ssd.ssd_step(state["ssm"], xs[:, 0], dt[:, 0],
                                      a, bs[:, 0], cs[:, 0], p["d_skip"])
            y = y[:, None]
            new_state["ssm"] = new_ssm

    y = y.reshape(b, s, di)
    y = _gated_rmsnorm(y, z, p["norm_scale"])
    return y @ p["out_proj"].to(x.dtype), new_state
