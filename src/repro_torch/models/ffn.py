"""Feed-forward layers: gated dense FFN (SwiGLU/GELU) and MoE with
sort-based top-k token-choice dispatch (GShard-style capacity, no
one-hot dispatch tensors): static shapes, no value read back to the
host, so a forward on the card never waits for it.

The dispatch keeps ``repro``'s arithmetic: the same capacity
expression, a stable sort by expert id, ``searchsorted`` segment starts
and the same clipped gathers (JAX clamps an out-of-range gather index,
torch raises, so every clip of the reference is kept). The combine
gathers each token's k routed pairs back through the inverse
permutation and sums them, so the output on the card does not depend on
the order of atomic adds: every MoE layer's output feeds the next
layer's router, where a flipped bit could flip a near-tie.
On DTensors ``searchsorted`` and the global dispatch's ``index_add_``
run replicated (DTensor has no sharding rule for them), and the expert
products run on each rank's experts (``shard_map``), constrained to
the expert axis as in ``repro``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.parallel.sharding import constrain, replicated, shard_map
from .common import ModelConfig, Params, dense_init, gated_act


# ----------------------------------------------------------------------
# Dense gated FFN
# ----------------------------------------------------------------------

def init_ffn(cfg: ModelConfig, generator: Optional[torch.Generator],
             device: torch.device, d_ff: Optional[int] = None,
             d_model: Optional[int] = None) -> Params:
    d = d_model or cfg.d_model
    f = d_ff or cfg.d_ff
    return {
        "w_gate": dense_init(generator, (d, f), device),
        "w_up": dense_init(generator, (d, f), device),
        "w_down": dense_init(generator, (f, d), device),
    }


def ffn_forward(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    h = constrain(_gated_hidden(cfg, p, x), "batch", "seq", "ff")
    # DTensor places eagerly, op by op (GSPMD looks ahead): reduce the
    # down projection's partial sums here, or they ride the residual
    # stream into the LM head, which then runs unsharded over the vocab
    return constrain(h @ p["w_down"].to(x.dtype), "batch", "seq", "embed")


def _gated_hidden(cfg: ModelConfig, p: Params, x: torch.Tensor
                  ) -> torch.Tensor:
    gate = x @ p["w_gate"].to(x.dtype)
    up = x @ p["w_up"].to(x.dtype)
    return gated_act(cfg, gate, up)


def _shared_experts(cfg: ModelConfig, p: Params, x: torch.Tensor
                    ) -> torch.Tensor:
    """The shared experts' FFN over x (..., D), unconstrained as in
    ``repro``."""
    return _gated_hidden(cfg, p, x) @ p["w_down"].to(x.dtype)


# ----------------------------------------------------------------------
# Mixture of Experts
# ----------------------------------------------------------------------

def init_moe(cfg: ModelConfig, generator: Optional[torch.Generator],
             device: torch.device) -> Params:
    d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
    p: Dict[str, Any] = {
        "router": dense_init(generator, (d, e), device),
        "w_gate": dense_init(generator, (e, d, f), device),
        "w_up": dense_init(generator, (e, d, f), device),
        "w_down": dense_init(generator, (e, f, d), device),
    }
    if cfg.n_shared_experts:
        p["shared"] = init_ffn(cfg, generator, device,
                               d_ff=f * cfg.n_shared_experts)
    return p


def capacity(cfg: ModelConfig, tokens: int) -> int:
    """Slots per expert for ``tokens`` routed tokens (``repro``'s own
    expression; at least 1)."""
    return int(cfg.capacity_factor * tokens * cfg.moe_top_k
               / cfg.n_experts) + 1


def router_probs(cfg: ModelConfig, logits: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k routing. Returns (weights (..., k), expert_ids (..., k)),
    ids in descending order of their score, as ``jax.lax.top_k``."""
    if cfg.router_type == "softmax":
        probs = torch.softmax(logits.float(), dim=-1)
        w, idx = torch.topk(probs, cfg.moe_top_k, dim=-1)
        w = w / w.sum(-1, keepdim=True).clamp_min(1e-9)
    elif cfg.router_type == "sigmoid":     # llama4-style top-1 sigmoid
        score, idx = torch.topk(logits.float(), cfg.moe_top_k, dim=-1)
        w = torch.sigmoid(score)
    else:
        raise ValueError(cfg.router_type)
    return w, idx


def aux_load_balance_loss(cfg: ModelConfig, logits: torch.Tensor,
                          idx: torch.Tensor) -> torch.Tensor:
    """Switch-style load-balance loss (mean fraction * mean prob * E)."""
    e = cfg.n_experts
    probs = torch.softmax(logits.float(), dim=-1)
    me = probs.reshape(-1, e).mean(0)
    flat = replicated(idx.reshape(-1))
    # whole-number float adds: exact in any order (bincount would read
    # the largest id back to the host on the card)
    counts = me.new_zeros((e,)).index_add_(
        0, flat, flat.new_ones(flat.shape, dtype=torch.float32))
    frac = counts / counts.sum().clamp_min(1.0)
    return e * (me * frac).sum()


def moe_forward(cfg: ModelConfig, p: Params, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    if cfg.moe_local_dispatch:
        return moe_forward_local(cfg, p, x)
    return moe_forward_global(cfg, p, x)


def _experts(cfg: ModelConfig, p: Params, buf: torch.Tensor,
             names) -> torch.Tensor:
    """Every expert's gated FFN over its slots: buf (..., E, C, D) with
    logical ``names``, which also constrain the hidden activations. On
    DTensors it runs on each rank's experts (``shard_map``; the expert
    weights are gathered over their FSDP axis)."""
    def ffn(buf, w_gate, w_up, w_down):
        dt = buf.dtype
        gate = torch.einsum("...ecd,edf->...ecf", buf, w_gate.to(dt))
        up = torch.einsum("...ecd,edf->...ecf", buf, w_up.to(dt))
        h = constrain(gated_act(cfg, gate, up), *names)
        return torch.einsum("...ecf,efd->...ecd", h, w_down.to(dt))

    w = ("expert", None, None)
    return shard_map(ffn, (names, w, w, w), names)(
        buf, p["w_gate"], p["w_up"], p["w_down"])


def moe_forward_local(cfg: ModelConfig, p: Params, x: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-batch-row dispatch: route, sort and cap WITHIN each sequence,
    with gathers only (``repro``'s gather-only form)."""
    b, s, d = x.shape
    k, e = cfg.moe_top_k, cfg.n_experts
    cap = capacity(cfg, s)
    dev = x.device

    logits = x @ p["router"].to(x.dtype)                   # (B,S,E)
    w, idx = router_probs(cfg, logits)                     # (B,S,k)
    aux = aux_load_balance_loss(cfg, logits, idx)

    flat_e = idx.reshape(b, s * k)
    flat_w = w.reshape(b, s * k)
    flat_tok = torch.arange(s, device=dev).repeat_interleave(k)[None] \
        .expand(b, s * k)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    se = torch.gather(flat_e, -1, order)
    sw = torch.gather(flat_w, -1, order)
    stok = torch.gather(flat_tok, -1, order)
    seg_pos = torch.arange(s * k, device=dev)[None].expand(b, s * k)
    experts = torch.arange(e, device=dev)[None].expand(b, e).contiguous()
    se = replicated(se)
    seg_start = torch.searchsorted(se, experts, right=False)
    seg_end = torch.searchsorted(se, experts, right=True)
    counts = seg_end - seg_start                           # (B, E)
    pos_in_e = seg_pos - torch.gather(seg_start, -1, se)
    keep = pos_in_e < cap                                  # (B, S*k)

    # dispatch: slot (e, c) reads sorted pair seg_start[e] + c
    x_sorted = torch.gather(x, 1, stok[..., None].expand(b, s * k, d))
    slots = torch.arange(cap, device=dev)
    src = seg_start[:, :, None] + slots
    valid = slots < counts[:, :, None]
    src_c = src.clamp(0, s * k - 1).reshape(b, e * cap)
    buf = torch.gather(x_sorted, 1, src_c[..., None].expand(b, e * cap, d))
    buf = buf.reshape(b, e, cap, d) * valid[..., None].to(x.dtype)
    buf = constrain(buf, "batch", "expert", None, None)
    out_e = _experts(cfg, p, buf, ("batch", "expert", None, None)) \
        .reshape(b, e * cap, d)

    # combine: pair -> slot gather, weight, unsort (inverse perm), then
    # a static reshape-sum over each token's k routed pairs
    slot = se * cap + pos_in_e.clamp(0, cap - 1)           # (B, S*k)
    contrib = torch.gather(out_e, 1, slot[..., None].expand(b, s * k, d)) \
        * (sw * keep).to(x.dtype)[..., None]               # sorted order
    inv = torch.argsort(order, dim=-1)                     # inverse perm
    contrib = torch.gather(contrib, 1, inv[..., None].expand(b, s * k, d))
    out = contrib.reshape(b, s, k, d).sum(dim=2)

    if cfg.n_shared_experts:
        out = out + _shared_experts(cfg, p["shared"], x)
    return constrain(out, "batch", "seq", "embed"), aux


def moe_forward_global(cfg: ModelConfig, p: Params, x: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (out, aux_loss).

    Sort-based dispatch over all B·S tokens: stable-sort the routed pairs
    by expert id, pad each expert's segment to a static capacity C,
    batch the expert FFNs as an (E, C, D) product, and weight each pair
    by its router probability. Pairs beyond capacity fall through via
    the residual (token dropping)."""
    b, s, d = x.shape
    n = b * s
    k, e = cfg.moe_top_k, cfg.n_experts
    cap = capacity(cfg, n)
    dev = x.device

    xt = x.reshape(n, d)
    logits = xt @ p["router"].to(x.dtype)                  # (N, E)
    w, idx = router_probs(cfg, logits)                     # (N, k)
    aux = aux_load_balance_loss(cfg, logits, idx)

    flat_e = idx.reshape(-1)                               # (N*k,)
    flat_w = w.reshape(-1)
    flat_tok = torch.arange(n, device=dev).repeat_interleave(k)

    order = torch.argsort(flat_e, stable=True)             # sort by expert
    se, sw, stok = flat_e[order], flat_w[order], flat_tok[order]
    # position of each routed pair within its expert segment
    seg_pos = torch.arange(n * k, device=dev)
    se = replicated(se)
    seg_start_per_e = torch.searchsorted(
        se, torch.arange(e, device=dev), right=False)
    pos_in_e = seg_pos - seg_start_per_e[se]
    keep = pos_in_e < cap
    slot = se * cap + torch.where(keep, pos_in_e, cap - 1)  # (N*k,)

    # Scatter tokens into (E*C, D). A kept pair owns its slot; a dropped
    # pair adds an exact 0 to its expert's last slot, so the sum does
    # not depend on the order of the adds.
    kept = keep[:, None]
    gathered = xt[stok] * kept.to(x.dtype)
    buf = xt.new_zeros((e * cap, d))
    buf.index_add_(0, replicated(slot),
                   replicated(torch.where(kept, gathered, 0.0)))
    buf = constrain(buf.reshape(e, cap, d), "expert", None, "embed")
    # expert dim already consumes the model axis; ff stays unsharded
    out_e = _experts(cfg, p, buf, ("expert", None, None)) \
        .reshape(e * cap, d)

    # Combine: each pair's weighted slot, back in token order (the
    # inverse permutation), summed over the token's k pairs.
    contrib = out_e[slot] * (sw * keep).to(x.dtype)[:, None]
    inv = torch.argsort(order)
    out = contrib[inv].reshape(n, k, d).sum(dim=1)

    if cfg.n_shared_experts:
        out = out + _shared_experts(cfg, p["shared"], xt)
    return constrain(out.reshape(b, s, d), "batch", "seq", "embed"), aux
