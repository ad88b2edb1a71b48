"""Full language-model assembly: embeddings -> layer stack -> final norm
-> LM head; plus decode-state plumbing and the carrying-across of
``repro``'s parameters.

The parameters keep ``repro``'s pytree layout: a scanned segment's
leaves carry a leading layer axis, so its ``lax.scan`` becomes a Python
loop that indexes the stacked tensors. Heterogeneous patterns are loops
over *groups*:

  dense/audio/vlm : n_layers x dense (stacked)
  moe             : first_k_dense moe_dense layers (a list), then the
                    rest as moe layers (stacked)
  hybrid (zamba2) : G x [shared_attn ; k x mamba] (stacked) + leftover
                    mamba layers (a list); the attention block params are
                    SHARED, applied once at the start of each group.

The audio family (musicgen) embeds K codebook streams (tokens (B, K, S))
as the sum of K embeddings and predicts each with its own head (logits
(B, S, K, V)); its positions are sinusoidal, added at the embedding.
The vlm family (qwen2-vl) splices stub patch embeddings over the
image-placeholder positions and rotates by M-RoPE; any family takes a
stub ``embeds`` input in place of tokens.

``repro``'s ``remat`` (rematerialisation under ``jax.checkpoint``) and
``force_unscanned`` (unrolled layers for XLA cost analysis) do not apply
to an eager forward without autograd: the fields stay in the config and
are ignored here. The ssm (xLSTM) family comes with its blocks.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from .blocks import apply_layer, init_layer, init_layer_state
from .common import (ModelConfig, Params, apply_norm, embed_init, init_norm,
                     sinusoidal_positions)


# ----------------------------------------------------------------------
# Trees of tensors
# ----------------------------------------------------------------------

def tree_map(fn: Callable, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def tree_stack(trees: List):
    """Stack a list of identically shaped trees along a new leading axis."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_stack([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


def tree_leaves(tree) -> List:
    """The tensors of a tree, in ``tree_map``'s order."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def stacked_init(fn: Callable[[], Any], count: int):
    """``count`` trees from ``fn()``, drawn in order and stacked along a
    new leading axis, as ``tree_stack([fn() for _ in range(count)])``
    but holding the stack and one layer at a time: a full-width layer of
    an MoE model is gigabytes."""
    out = None
    for i in range(count):
        layer = fn()
        if out is None:
            out = tree_map(
                lambda t: t.new_empty((count,) + tuple(t.shape)), layer)
        for dst, src in zip(tree_leaves(out), tree_leaves(layer)):
            dst[i].copy_(src)
        del layer
    return out


def tree_index(tree, i: int):
    """Layer ``i`` of a stacked tree (views of the stacked tensors)."""
    return tree_map(lambda leaf: leaf[i], tree)


# ----------------------------------------------------------------------
# Layer plan
# ----------------------------------------------------------------------

@dataclass(frozen=True)
class Segment:
    kind: str          # block kind for blocks.py
    count: int         # layers in this segment
    scanned: bool      # stacked params, looped over the leading axis
    group: Tuple[str, ...] = ()   # for grouped segments: kinds within group


def layer_plan(cfg: ModelConfig) -> List[Segment]:
    at = cfg.arch_type
    if at in ("dense", "audio", "vlm"):
        return [Segment("dense", cfg.n_layers, True)]
    if at == "moe":
        segs: List[Segment] = []
        if cfg.first_k_dense:
            segs.append(Segment("moe_dense", cfg.first_k_dense, False))
        segs.append(Segment("moe", cfg.n_layers - cfg.first_k_dense, True))
        return segs
    if at == "hybrid":  # zamba2
        k = cfg.shared_attn_every
        g, rem = divmod(cfg.n_layers, k)
        segs = [Segment("hybrid_group", g, True, ("mamba",) * k)]
        if rem:
            segs.append(Segment("mamba", rem, False))
        return segs
    raise ValueError(f"arch type {at!r} is not ported yet; repro_torch has "
                     "the dense (with audio and vlm), moe and hybrid stacks")


# ----------------------------------------------------------------------
# Init
# ----------------------------------------------------------------------

def init_model(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
               device=None) -> Params:
    """Random parameters on ``device`` (None: the card), drawn from
    ``generator`` (None: PyTorch's default generator for the device).
    ``device="meta"`` gives the tree's shapes without storage."""
    device = resolve_device(device)
    d, v = cfg.d_model, cfg.vocab_size
    if cfg.arch_type == "audio":    # one embedding and head per codebook
        params: Dict[str, Any] = {
            "embed": embed_init(generator, (cfg.n_codebooks, v, d), device),
            "lm_head": embed_init(generator, (cfg.n_codebooks, d, v), device)}
    else:
        params = {"embed": embed_init(generator, (v, d), device)}
        if not cfg.tie_embeddings:
            params["lm_head"] = embed_init(generator, (d, v), device)

    seg_params = []
    for seg in layer_plan(cfg):
        if seg.kind == "hybrid_group":
            def one(seg=seg):
                return {f"{i}_{kind}": init_layer(cfg, generator, device, kind)
                        for i, kind in enumerate(seg.group)}
        else:
            def one(seg=seg):
                return init_layer(cfg, generator, device, seg.kind)
        seg_params.append(stacked_init(one, seg.count) if seg.scanned
                          else [one() for _ in range(seg.count)])
    params["segments"] = seg_params
    if cfg.arch_type == "hybrid":
        params["shared_attn"] = init_layer(cfg, generator, device,
                                           "shared_attn")
    params["final_norm"] = init_norm(cfg, device)
    return params


def params_from_numpy(cfg: ModelConfig, tree, device=None) -> Params:
    """``repro``'s parameters (nested dicts and lists of numpy arrays, as
    ``jax.tree_util.tree_map(np.asarray, params)`` gives them) as the
    port's tree on ``device``. Every leaf's shape is checked against the
    port's own ``init_model`` tree; a missing or extra key, a list of
    another length or a leaf of another shape raises ``ValueError``."""
    device = resolve_device(device)
    want = init_model(cfg, device="meta")

    def convert(node, ref, path):
        if isinstance(ref, dict):
            if not isinstance(node, dict) or set(node) != set(ref):
                got = sorted(node) if isinstance(node, dict) else type(node)
                raise ValueError(f"{path}: keys {got}, the port expects "
                                 f"{sorted(ref)}")
            return {k: convert(node[k], ref[k], f"{path}[{k!r}]")
                    for k in ref}
        if isinstance(ref, list):
            if not isinstance(node, (list, tuple)) or len(node) != len(ref):
                raise ValueError(f"{path}: expected a list of {len(ref)}")
            return [convert(n, r, f"{path}[{i}]")
                    for i, (n, r) in enumerate(zip(node, ref))]
        arr = np.asarray(node)
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(f"{path}: shape {tuple(arr.shape)}, the port "
                             f"expects {tuple(ref.shape)}")
        return torch.from_numpy(np.array(arr, dtype=np.float32)).to(
            device=device, dtype=ref.dtype)

    return convert(tree, want, "params")


# ----------------------------------------------------------------------
# Embedding / head
# ----------------------------------------------------------------------

def embed_tokens(cfg: ModelConfig, params: Params, batch: Dict) -> torch.Tensor:
    """(B, S, D) activations: a stub front end's ``embeds``, the sum of
    the codebook embeddings (audio, tokens (B, K, S)), or the token
    embeddings with the vlm's ``patch_embeds`` spliced where
    ``patch_mask`` (B, S) is set; plus sinusoidal positions from
    ``pos_offset`` (default 0) where the config has them."""
    dtype = cfg.activation_dtype
    if batch.get("embeds") is not None:
        x = batch["embeds"]
    elif cfg.arch_type == "audio":
        toks = batch["tokens"].long()                     # (B, K, S)
        emb = params["embed"]                             # (K, V, D)
        x = torch.zeros(toks.shape[:1] + toks.shape[2:] + (cfg.d_model,),
                        dtype=dtype, device=emb.device)
        for k in range(cfg.n_codebooks):
            x = x + emb[k][toks[:, k]].to(dtype)
    else:
        x = params["embed"][batch["tokens"].long()].to(dtype)
        if cfg.arch_type == "vlm" and batch.get("patch_embeds") is not None:
            pe = batch["patch_embeds"].to(dtype)
            x = torch.where(batch["patch_mask"][..., None], pe, x)
    if cfg.pos_type == "sinusoidal":
        sin = sinusoidal_positions(x.shape[1], cfg.d_model,
                                   batch.get("pos_offset", 0), x.device)
        x = x + sin[None].to(x.dtype)
    return x


def lm_logits(cfg: ModelConfig, params: Params, x: torch.Tensor) -> torch.Tensor:
    """(B, S, V) logits, or (B, S, K, V) for the audio family."""
    if cfg.arch_type == "audio":
        return torch.einsum("bsd,kdv->bskv", x, params["lm_head"].to(x.dtype))
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return x @ head.to(x.dtype)


# ----------------------------------------------------------------------
# Forward (train / prefill) and decode
# ----------------------------------------------------------------------

def _positions_from(batch: Dict, seq: int, bsz: int,
                    device: torch.device) -> torch.Tensor:
    pos = batch.get("positions")
    if pos is None:
        pos = torch.arange(seq, dtype=torch.int32,
                           device=device)[None].expand(bsz, seq)
    return pos


def _apply_group(cfg, group_kinds, gp, x, positions, states, window,
                 use_kernel, shared_attn=None):
    """One group of a grouped segment; states is a dict or None."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    new_states = {} if states is not None else None
    if shared_attn is not None:
        st = states.get("shared") if states is not None else None
        x, ns, a = apply_layer(cfg, shared_attn, x, positions,
                               "shared_attn", state=st, window=window,
                               use_kernel=use_kernel)
        aux = aux + a
        if new_states is not None:
            new_states["shared"] = ns
    for i, kind in enumerate(group_kinds):
        name = f"{i}_{kind}"
        st = states.get(name) if states is not None else None
        x, ns, a = apply_layer(cfg, gp[name], x, positions, kind,
                               state=st, window=window,
                               use_kernel=use_kernel)
        aux = aux + a
        if new_states is not None:
            new_states[name] = ns
    return x, new_states, aux


def _run_stack(cfg: ModelConfig, params: Params, x: torch.Tensor,
               positions: torch.Tensor, states: Optional[List] = None,
               window: int = 0, use_kernel: bool = False):
    """states: list matching segments (stacked trees for scanned
    segments); None for train/prefill-without-cache."""
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    new_states: Optional[List] = [] if states is not None else None
    shared = params.get("shared_attn")

    for si, (seg, sp) in enumerate(zip(layer_plan(cfg), params["segments"])):
        st_seg = states[si] if states is not None else None
        shared_for_seg = shared if seg.kind == "hybrid_group" else None
        seg_new = []
        for li in range(seg.count):
            lp = tree_index(sp, li) if seg.scanned else sp[li]
            st = None
            if st_seg is not None:
                st = tree_index(st_seg, li) if seg.scanned else st_seg[li]
            if seg.kind == "hybrid_group":
                x, ns, a = _apply_group(cfg, seg.group, lp, x, positions, st,
                                        window, use_kernel,
                                        shared_attn=shared_for_seg)
            else:
                x, ns, a = apply_layer(cfg, lp, x, positions, seg.kind,
                                       state=st, window=window,
                                       use_kernel=use_kernel)
            aux_total = aux_total + a
            seg_new.append(ns)
        if new_states is not None:
            new_states.append(tree_stack(seg_new) if seg.scanned else seg_new)

    return x, new_states, aux_total


def forward(cfg: ModelConfig, params: Params, batch: Dict,
            use_kernel: bool = False
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward (the prefill step). Returns (logits,
    aux_loss). ``use_kernel`` sends attention and the SSD scan through
    the hand-written kernels (on CUDA tensors)."""
    x = embed_tokens(cfg, params, batch)
    b, s = x.shape[:2]
    positions = _positions_from(batch, s, b, x.device)
    x, _, aux = _run_stack(cfg, params, x, positions, None,
                           cfg.sliding_window, use_kernel)
    x = apply_norm(cfg, params["final_norm"], x)
    return lm_logits(cfg, params, x), aux


def init_decode_state(cfg: ModelConfig, batch: int, window: int,
                      dtype, device=None) -> List:
    """Per-segment decode state, stacked for scanned segments."""
    device = resolve_device(device)

    def one(kind):
        return init_layer_state(cfg, kind, batch, window, dtype, device)

    def stack(tree, count):
        return tree_map(
            lambda leaf: leaf.expand((count,) + leaf.shape).clone(), tree)

    states: List[Any] = []
    for seg in layer_plan(cfg):
        if seg.kind == "hybrid_group":
            def gstate(seg=seg):
                g: Dict[str, Any] = {"shared": one("shared_attn")}
                for i, kind in enumerate(seg.group):
                    g[f"{i}_{kind}"] = one(kind)
                return g
            states.append(stack(gstate(), seg.count) if seg.scanned
                          else [gstate() for _ in range(seg.count)])
        elif seg.scanned:
            states.append(stack(one(seg.kind), seg.count))
        else:
            states.append([one(seg.kind) for _ in range(seg.count)])
    return states


def decode_step(cfg: ModelConfig, params: Params, state: List,
                batch: Dict) -> Tuple[torch.Tensor, List]:
    """One-token decode. batch['tokens']: (B, 1) (or (B, K, 1) audio);
    batch['positions']: (B, 1) absolute positions, or (B, 1, 3) under
    M-RoPE. Returns (logits, new_state); the KV caches inside ``state``
    are updated in place."""
    x = embed_tokens(cfg, params, batch)
    positions = batch["positions"]
    window = (cfg.sliding_window
              if cfg.long_context_mode == "window" else 0)
    x, new_state, _ = _run_stack(cfg, params, x, positions, state, window)
    x = apply_norm(cfg, params["final_norm"], x)
    return lm_logits(cfg, params, x), new_state
