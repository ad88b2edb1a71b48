"""Plain PyTorch oracle for the Mamba2 SSD (state-space dual) chunked
scan.

Semantics (per batch, head):
    S_t = exp(dt_t * A) * S_{t-1} + dt_t * x_t (outer) B_t
    y_t = C_t . S_t + D * x_t
with S in R^{P x N} (headdim x state). The chunked form computes
intra-chunk contributions with a causal quadratic form and carries
inter-chunk state with a loop over chunks — this reference is the
ground truth for the CUDA kernel and the model layer.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def segsum(log_a: torch.Tensor) -> torch.Tensor:
    """Causal segment-sum: out[..., t, s] = sum_{r=s+1..t} log_a[..., r]
    for s <= t, -inf otherwise."""
    T = log_a.shape[-1]
    cs = torch.cumsum(log_a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]          # t, s
    mask = torch.tril(torch.ones((T, T), dtype=torch.bool,
                                 device=log_a.device))
    return diff.masked_fill(~mask, float("-inf"))


def ssd_reference(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                  b: torch.Tensor, c: torch.Tensor,
                  chunk: int = 64,
                  d_skip: Optional[torch.Tensor] = None,
                  init_state: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan.

    x:  (B, S, H, P)   inputs per head
    dt: (B, S, H)      positive step sizes (already softplus'ed)
    a:  (H,)           negative decay rates (A = -exp(a_log))
    b:  (B, S, H, N)   input projections (already group-broadcast)
    c:  (B, S, H, N)   output projections
    returns y (B, S, H, P), final_state (B, H, P, N)
    """
    B_, S, H, P = x.shape
    N = b.shape[-1]
    if S % chunk:
        raise ValueError(f"ssd_scan needs the sequence length to be a "
                         f"multiple of the chunk: S = {S}, chunk = {chunk}")
    K = S // chunk
    f32 = torch.float32

    xs = x.reshape(B_, K, chunk, H, P).to(f32)
    dts = dt.reshape(B_, K, chunk, H).to(f32)
    bs = b.reshape(B_, K, chunk, H, N).to(f32)
    cs = c.reshape(B_, K, chunk, H, N).to(f32)

    log_a = dts * a.to(f32)                             # (B,K,Q,H)
    log_a = log_a.movedim(-1, -2)                       # (B,K,H,Q)
    seg = segsum(log_a)                                 # (B,K,H,Q,Q)

    # intra-chunk quadratic form
    cb = torch.einsum("bkqhn,bkshn->bkhqs", cs, bs)     # (B,K,H,Q,Q)
    m = cb * torch.exp(seg) * dts.movedim(-1, -2)[..., None, :]
    y_intra = torch.einsum("bkhqs,bkshp->bkqhp", m, xs)

    # per-chunk state contribution: decay from s to end of chunk
    cum = torch.cumsum(log_a, dim=-1)                   # (B,K,H,Q)
    total = cum[..., -1:]                               # (B,K,H,1)
    decay_to_end = torch.exp(total - cum)               # (B,K,H,Q)
    # weight x by dt, decayed from position s to the chunk end
    w = dts.movedim(-1, -2) * decay_to_end              # (B,K,H,Q)
    chunk_state = torch.einsum("bkhq,bkqhp,bkqhn->bkhpn", w, xs, bs)

    # inter-chunk recurrence over K: the state entering each chunk
    chunk_decay = torch.exp(total[..., 0])              # (B,K,H)
    s_run = (init_state.to(f32) if init_state is not None
             else torch.zeros((B_, H, P, N), dtype=f32, device=x.device))
    s_prevs = []
    for k in range(K):
        s_prevs.append(s_run)
        s_run = s_run * chunk_decay[:, k, :, None, None] + chunk_state[:, k]
    s_prev = torch.stack(s_prevs, dim=1)                # (B,K,H,P,N)

    # inter-chunk output: state entering the chunk, decayed to position t
    state_decay = torch.exp(cum)                        # (B,K,H,Q)
    y_inter = torch.einsum("bkqhn,bkhpn,bkhq->bkqhp", cs, s_prev, state_decay)

    y = (y_intra + y_inter).reshape(B_, S, H, P)
    if d_skip is not None:
        y = y + x.to(f32) * d_skip.to(f32)[None, None, :, None]
    return y.to(x.dtype), s_run


def ssd_step(state: torch.Tensor, x: torch.Tensor, dt: torch.Tensor,
             a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
             d_skip: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single decode step.

    state: (B,H,P,N); x: (B,H,P); dt: (B,H); b,c: (B,H,N)
    returns (y (B,H,P), new_state)
    """
    f32 = torch.float32
    decay = torch.exp(dt.to(f32) * a.to(f32))           # (B,H)
    upd = (dt.to(f32)[..., None, None]
           * x.to(f32)[..., :, None] * b.to(f32)[..., None, :])
    new_state = state.to(f32) * decay[..., None, None] + upd
    y = torch.einsum("bhpn,bhn->bhp", new_state, c.to(f32))
    if d_skip is not None:
        y = y + x.to(f32) * d_skip.to(f32)[None, :, None]
    return y.to(x.dtype), new_state.to(state.dtype)


def ssd_sequential_reference(x, dt, a, b, c, d_skip=None, init_state=None):
    """O(S) sequential oracle (slowest, simplest) used to validate the
    chunked form itself."""
    B_, S, H, P = x.shape
    N = b.shape[-1]
    s = (init_state if init_state is not None
         else torch.zeros((B_, H, P, N), dtype=torch.float32,
                          device=x.device))
    ys = []
    for t in range(S):
        y, s = ssd_step(s, x[:, t], dt[:, t], a, b[:, t], c[:, t], d_skip)
        ys.append(y)
    return torch.stack(ys, dim=1), s
