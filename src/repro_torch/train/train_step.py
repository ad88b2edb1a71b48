"""Loss + train step (forward, backward, AdamW), grad-accum option.

Gradients come from ``torch.autograd`` on detached copies of the
parameter leaves that require grad; a leaf the loss does not reach gets
zeros, as ``jax.grad`` gives. ``use_kernel=True`` is for tensors on the
CPU (the kernels' plain versions) or for models that reach no kernel:
the CUDA kernels have no backward and raise ``RuntimeError`` when an
input requires grad.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.models import model as lm
from repro_torch.models.common import ModelConfig
from .optim import OptimConfig, adamw_update

AUX_WEIGHT = 0.01  # MoE load-balance loss weight


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """logits: (..., V); targets: int (...). Mean NLL in fp32."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    return (logz - gold).mean()


def loss_fn(cfg: ModelConfig, params: Any, batch: Dict,
            use_kernel: bool = False) -> Tuple[torch.Tensor, Dict]:
    logits, aux = lm.forward(cfg, params, batch, use_kernel=use_kernel)
    targets = batch["targets"]
    if cfg.arch_type == "audio":
        # logits (B,S,K,V); targets (B,K,S)
        targets = targets.movedim(1, 2)
    ce = cross_entropy(logits, targets)
    total = ce + AUX_WEIGHT * aux
    return total, {"loss": total, "ce": ce, "aux": aux}


def value_and_grad(cfg: ModelConfig, params: Any, batch: Dict,
                   use_kernel: bool = False
                   ) -> Tuple[Tuple[torch.Tensor, Dict], Any]:
    """``jax.value_and_grad(loss_fn, has_aux=True)``: ((loss, metrics),
    grads), the metrics detached and the grads a tree of ``params``'s
    structure."""
    live = lm.tree_map(lambda t: t.detach().requires_grad_(), params)
    leaves = lm.tree_leaves(live)
    with torch.enable_grad():
        loss, metrics = loss_fn(cfg, live, batch, use_kernel)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    metrics = {k: v.detach() for k, v in metrics.items()}
    return (loss.detach(), metrics), lm.tree_unflatten(params, grads)


def train_step(cfg: ModelConfig, opt_cfg: OptimConfig, params: Any,
               opt_state: Any, batch: Dict, use_kernel: bool = False
               ) -> Tuple[Any, Any, Dict]:
    (_, metrics), grads = value_and_grad(cfg, params, batch, use_kernel)
    new_params, new_opt, opt_metrics = adamw_update(
        opt_cfg, params, grads, opt_state)
    metrics = dict(metrics)
    metrics.update(opt_metrics)
    return new_params, new_opt, metrics


def train_step_accum(cfg: ModelConfig, opt_cfg: OptimConfig, params: Any,
                     opt_state: Any, batch: Dict, n_micro: int
                     ) -> Tuple[Any, Any, Dict]:
    """Gradient accumulation over ``n_micro`` microbatches (batch dim
    split); reduces peak activation memory at the cost of re-running the
    forward pass per microbatch."""
    def micro(i):
        return lm.tree_map(
            lambda t: t.reshape((n_micro, -1) + tuple(t.shape[1:]))[i], batch)

    gsum = lm.tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                             device=p.device), params)
    ce_sum = torch.zeros((), dtype=torch.float32,
                         device=lm.tree_leaves(params)[0].device)
    for i in range(n_micro):
        (_, metrics), g = value_and_grad(cfg, params, micro(i))
        gsum = lm.tree_map(torch.add, gsum, g)
        ce_sum = ce_sum + metrics["ce"]
    grads = lm.tree_map(lambda g: g / n_micro, gsum)
    new_params, new_opt, opt_metrics = adamw_update(
        opt_cfg, params, grads, opt_state)
    metrics = {"ce": ce_sum / n_micro}
    metrics.update(opt_metrics)
    return new_params, new_opt, metrics
