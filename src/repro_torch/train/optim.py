"""AdamW + schedules + global-norm clipping on trees of tensors.

No ``torch.optim``: the state is ``repro``'s tree (``mu``, ``nu``,
``step``) key for key, so checkpoints load across the packages, and the
arithmetic follows ``repro``'s order term for term. Decoupled weight
decay applies where ``p.ndim >= 2``, as in ``repro``: a scanned
segment stacks its norm scales and biases on a layer axis, so they are
decayed too.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Tuple

import torch

from repro_torch.models.model import tree_leaves, tree_map, tree_unflatten


@dataclass(frozen=True)
class OptimConfig:
    lr: float = 3e-4
    betas: Tuple[float, float] = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def lr_at(cfg: OptimConfig, step) -> torch.Tensor:
    """Linear warmup + cosine decay to min_lr_ratio; ``step`` an int or
    an integer tensor, the result an fp32 tensor on its device."""
    step = torch.as_tensor(step).float()
    warm = step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) \
        * 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def init_opt_state(params: Any) -> Any:
    def zeros(p):
        return torch.zeros_like(p, dtype=torch.float32)
    leaf = tree_leaves(params)[0]
    return {"mu": tree_map(zeros, params),
            "nu": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=leaf.device)}


def global_norm(tree: Any) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(leaf.float() ** 2)
                          for leaf in tree_leaves(tree)))


@torch.no_grad()
def adamw_update(cfg: OptimConfig, params: Any, grads: Any,
                 state: Any) -> Tuple[Any, Any, dict]:
    """One AdamW step: new params and state (fresh tensors; the inputs
    are left as they are) and ``{"grad_norm", "lr"}``."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    b1, b2 = cfg.betas
    lr = lr_at(cfg, step)
    c1 = 1 - b1 ** step.float()
    c2 = 1 - b2 ** step.float()

    def upd(p, g, mu, nu):
        g = g.float() * scale
        mu = b1 * mu + (1 - b1) * g
        nu = b2 * nu + (1 - b2) * g * g
        mu_hat = mu / c1
        nu_hat = nu / c2
        delta = mu_hat / (torch.sqrt(nu_hat) + cfg.eps)
        if p.dim() >= 2:  # repro's rule: stacked 1-D leaves are decayed too
            delta = delta + cfg.weight_decay * p.float()
        return (p.float() - lr * delta).to(p.dtype), mu, nu

    # each leaf's (param, mu, nu) flattens in order
    flat = tree_leaves(tree_map(upd, params, grads, state["mu"],
                                state["nu"]))
    new_params, mu, nu = (tree_unflatten(params, flat[i::3])
                          for i in range(3))
    return (new_params, {"mu": mu, "nu": nu, "step": step},
            {"grad_norm": gnorm, "lr": lr})
