"""xLSTM blocks: mLSTM (matrix memory, parallel quadratic training form,
O(1) recurrent decode) and sLSTM (scalar memory with exponential gating,
recurrent over time). Layer pattern follows the paper's 7:1
mLSTM:sLSTM mix.

The recurrent states start with the stabiliser ``m = -inf``: the first
step takes ``max(logf + m, i) = i`` and ``exp(-inf) = 0`` times a zero
``c`` and ``n``. Every expression keeps ``repro``'s order of operations
term for term, so that no reordering forms ``-inf - -inf`` or
``0 * inf``. The full-sequence sLSTM is a Python loop over time steps
(``repro``'s ``lax.scan``) whose outputs are stacked, which keeps the
autograd graph for training.

References: Beck et al., "xLSTM: Extended Long Short-Term Memory"
(arXiv:2405.04517), stabilized exponential gating (eqs. 15-27).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.parallel.sharding import constrain, shard_map
from .common import ModelConfig, Params, dense_init

NEG_INF = -1e30


def mlstm_dims(cfg: ModelConfig) -> Tuple[int, int, int, int]:
    d_inner = int(cfg.xlstm_proj_factor * cfg.d_model)
    h = cfg.n_heads
    d_v = d_inner // h
    d_qk = cfg.xlstm_qk_dim
    return d_inner, h, d_qk, d_v


# ----------------------------------------------------------------------
# mLSTM
# ----------------------------------------------------------------------

def init_mlstm(cfg: ModelConfig, generator: Optional[torch.Generator],
               device: torch.device) -> Params:
    d = cfg.d_model
    di, h, dqk, dv = mlstm_dims(cfg)
    return {
        "w_in": dense_init(generator, (d, 2 * di), device),   # [mixer | gate]
        "w_q": dense_init(generator, (di, h * dqk), device),
        "w_k": dense_init(generator, (di, h * dqk), device),
        "w_v": dense_init(generator, (di, h * dv), device),
        "w_ig": dense_init(generator, (di, h), device),
        "w_fg": dense_init(generator, (di, h), device),
        "b_ig": torch.zeros((h,), dtype=torch.float32, device=device),
        # open forget gates
        "b_fg": torch.full((h,), 3.0, dtype=torch.float32, device=device),
        "norm_scale": torch.ones((di,), dtype=torch.float32, device=device),
        "w_out": dense_init(generator, (di, d), device),
    }


def init_mlstm_state(cfg: ModelConfig, batch: int,
                     device: torch.device) -> Params:
    _, h, dqk, dv = mlstm_dims(cfg)
    return {
        "c": torch.zeros((batch, h, dqk, dv), dtype=torch.float32,
                         device=device),
        "n": torch.zeros((batch, h, dqk), dtype=torch.float32, device=device),
        "m": torch.full((batch, h), -math.inf, dtype=torch.float32,
                        device=device),
    }


def _mlstm_parallel(q, k, v, i_pre, f_pre):
    """Stabilized parallel form. q,k: (B,S,H,Dqk); v: (B,S,H,Dv);
    i_pre,f_pre: (B,S,H) gate pre-activations."""
    b, s, h, dqk = q.shape
    logf = F.logsigmoid(f_pre.float())                        # (B,S,H)
    logf_cum = torch.cumsum(logf, dim=1)
    # D[t, s] = logf_cum[t] - logf_cum[s] + i[s]   (s <= t)
    dmat = (logf_cum[:, :, None, :] - logf_cum[:, None, :, :]
            + i_pre.float()[:, None, :, :])                   # (B,T,S,H)
    tri = torch.tril(torch.ones((s, s), dtype=torch.bool, device=q.device))
    dmat = torch.where(tri[None, :, :, None], dmat, NEG_INF)
    m = dmat.amax(dim=2)                                      # (B,T,H)
    dprime = torch.exp(dmat - m[:, :, None, :])
    scores = torch.einsum("bthd,bshd->btsh", q.float(),
                          k.float()) / math.sqrt(dqk)
    w = scores * dprime
    norm = torch.maximum(w.sum(dim=2).abs(), torch.exp(-m))   # (B,T,H)
    y = torch.einsum("btsh,bshv->bthv", w, v.float())
    y = y / (norm[..., None] + 1e-6)
    return y.to(q.dtype)


def _mlstm_step(state, q, k, v, i_pre, f_pre):
    """q,k: (B,H,Dqk); v: (B,H,Dv); gates (B,H). Returns (y, state)."""
    logf = F.logsigmoid(f_pre.float())
    m_new = torch.maximum(logf + state["m"], i_pre.float())
    fg = torch.exp(logf + state["m"] - m_new)
    ig = torch.exp(i_pre.float() - m_new)
    kq_scale = 1.0 / math.sqrt(q.shape[-1])
    c_new = state["c"] * fg[..., None, None] + \
        ig[..., None, None] * (k.float()[..., :, None]
                               * v.float()[..., None, :])
    n_new = state["n"] * fg[..., None] + ig[..., None] * k.float()
    qf = q.float() * kq_scale
    num = torch.einsum("bhd,bhdv->bhv", qf, c_new)
    den = torch.maximum(torch.einsum("bhd,bhd->bh", qf, n_new).abs(),
                        torch.exp(-m_new))
    y = (num / (den[..., None] + 1e-6)).to(q.dtype)
    return y, {"c": c_new, "n": n_new, "m": m_new}


def _rms(x, scale, eps=1e-6):
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale).to(x.dtype)


def mlstm_forward(cfg: ModelConfig, p: Params, x: torch.Tensor,
                  state: Optional[Params] = None
                  ) -> Tuple[torch.Tensor, Optional[Params]]:
    b, s, _ = x.shape
    di, h, dqk, dv = mlstm_dims(cfg)
    up = x @ p["w_in"].to(x.dtype)
    xm, gate = up.chunk(2, dim=-1)
    q = (xm @ p["w_q"].to(x.dtype)).reshape(b, s, h, dqk)
    k = (xm @ p["w_k"].to(x.dtype)).reshape(b, s, h, dqk)
    v = (xm @ p["w_v"].to(x.dtype)).reshape(b, s, h, dv)
    q = constrain(q, "batch", "seq", "heads", None)
    i_pre = xm @ p["w_ig"].to(x.dtype) + p["b_ig"].to(x.dtype)
    f_pre = xm @ p["w_fg"].to(x.dtype) + p["b_fg"].to(x.dtype)

    if state is None:
        # per sequence and head: on DTensors, on each rank's shards
        heads = ("batch", None, "heads", None)
        gates = ("batch", None, "heads")
        y = shard_map(_mlstm_parallel, (heads, heads, heads, gates, gates),
                      heads)(q, k, v, i_pre, f_pre)
        new_state = None
    else:
        if s != 1:
            raise ValueError(f"decode expects one new token, got {s}")
        y, new_state = _mlstm_step(state, q[:, 0], k[:, 0], v[:, 0],
                                   i_pre[:, 0], f_pre[:, 0])
        y = y[:, None]
    y = y.reshape(b, s, di)
    y = _rms(y, p["norm_scale"]) * F.silu(gate.float()).to(x.dtype)
    out = y @ p["w_out"].to(x.dtype)
    return constrain(out, "batch", "seq", "embed"), new_state


# ----------------------------------------------------------------------
# sLSTM
# ----------------------------------------------------------------------

def slstm_head_dim(cfg: ModelConfig) -> int:
    return cfg.d_model // cfg.n_heads


def init_slstm(cfg: ModelConfig, generator: Optional[torch.Generator],
               device: torch.device) -> Params:
    d, h = cfg.d_model, cfg.n_heads
    dh = slstm_head_dim(cfg)
    p = {"w_in": dense_init(generator, (d, 4 * d), device)}  # z, i, f, o
    for name in ("r_z", "r_i", "r_f", "r_o"):
        r = torch.empty((h, dh, dh), dtype=torch.float32, device=device)
        p[name] = r.normal_(generator=generator) / math.sqrt(dh)
    p["b_z"] = torch.zeros((d,), dtype=torch.float32, device=device)
    p["b_i"] = torch.zeros((d,), dtype=torch.float32, device=device)
    p["b_f"] = torch.full((d,), 3.0, dtype=torch.float32, device=device)
    p["b_o"] = torch.zeros((d,), dtype=torch.float32, device=device)
    p["norm_scale"] = torch.ones((d,), dtype=torch.float32, device=device)
    p["w_out"] = dense_init(generator, (d, d), device)
    return p


def init_slstm_state(cfg: ModelConfig, batch: int,
                     device: torch.device) -> Params:
    d = cfg.d_model
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "c": torch.zeros((batch, d), **f32),
        "n": torch.zeros((batch, d), **f32),
        "h": torch.zeros((batch, d), **f32),
        "m": torch.full((batch, d), -math.inf, **f32),
    }


_SLSTM_CELL_PARAMS = ("r_z", "r_i", "r_f", "r_o", "b_z", "b_i", "b_f", "b_o")


def _slstm_cell(cfg: ModelConfig, p: Params, state, zifo):
    """One timestep. zifo: (B, 4D) pre-activations from the input path."""
    b = zifo.shape[0]
    d, h = cfg.d_model, cfg.n_heads
    dh = d // h
    hprev = state["h"].reshape(b, h, dh)

    def rec(r):
        return torch.einsum("bhd,hde->bhe", hprev, r).reshape(b, d)

    z_pre, i_pre, f_pre, o_pre = zifo.float().chunk(4, dim=-1)
    z_pre = z_pre + rec(p["r_z"]) + p["b_z"]
    i_pre = i_pre + rec(p["r_i"]) + p["b_i"]
    f_pre = f_pre + rec(p["r_f"]) + p["b_f"]
    o_pre = o_pre + rec(p["r_o"]) + p["b_o"]

    logf = F.logsigmoid(f_pre)
    m_new = torch.maximum(logf + state["m"], i_pre)
    fg = torch.exp(logf + state["m"] - m_new)
    ig = torch.exp(i_pre - m_new)
    z = torch.tanh(z_pre)
    o = torch.sigmoid(o_pre)
    c_new = fg * state["c"] + ig * z
    n_new = fg * state["n"] + ig
    h_new = o * c_new / torch.clamp(n_new, min=1e-6)
    return {"c": c_new, "n": n_new, "h": h_new, "m": m_new}


def slstm_forward(cfg: ModelConfig, p: Params, x: torch.Tensor,
                  state: Optional[Params] = None
                  ) -> Tuple[torch.Tensor, Optional[Params]]:
    b, s, d = x.shape
    zifo = x @ p["w_in"].to(x.dtype)

    # the recurrence runs on each rank's sequences (``shard_map``): the
    # recurrent weights are per head and small, so they are replicated
    rec = {k: p[k] for k in _SLSTM_CELL_PARAMS}
    rec_names = tuple((None,) * p[k].ndim for k in _SLSTM_CELL_PARAMS)
    if state is None:
        def scan(zifo, *weights):
            pl = dict(zip(_SLSTM_CELL_PARAMS, weights))
            st = init_slstm_state(cfg, zifo.shape[0], zifo.device)
            hs = []
            for t in range(zifo.shape[1]):
                st = _slstm_cell(cfg, pl, st, zifo[:, t])
                hs.append(st["h"])
            return torch.stack(hs, dim=1)

        y = shard_map(scan, (("batch", None, None),) + rec_names,
                      ("batch", None, None))(zifo, *rec.values())
        y = y.to(x.dtype)                                     # (B,S,D)
        new_state = None
    else:
        if s != 1:
            raise ValueError(f"decode expects one new token, got {s}")
        keys = ("c", "n", "h", "m")

        def step(zifo_t, *rest):
            pl = dict(zip(_SLSTM_CELL_PARAMS, rest[len(keys):]))
            new = _slstm_cell(cfg, pl, dict(zip(keys, rest[:len(keys)])),
                              zifo_t)
            return tuple(new[k] for k in keys)

        row = ("batch", None)
        new_state = dict(zip(keys, shard_map(
            step, (row,) * (1 + len(keys)) + rec_names, (row,) * len(keys))(
            zifo[:, 0], *(state[k] for k in keys), *rec.values())))
        y = new_state["h"][:, None].to(x.dtype)

    y = _rms(y, p["norm_scale"])
    out = y @ p["w_out"].to(x.dtype)
    return constrain(out, "batch", "seq", "embed"), new_state


def is_slstm_layer(cfg: ModelConfig, layer_idx: int) -> bool:
    return cfg.slstm_every > 0 and layer_idx % cfg.slstm_every == 0
