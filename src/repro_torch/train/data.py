"""Synthetic LM data pipeline: deterministic, shardable, host-fed.

Generates Zipf-distributed token streams (more realistic softmax stats
than uniform) with next-token targets, from numpy's ``default_rng`` as
``repro`` does: the tokens and targets equal ``repro``'s for the same
seed, and are placed on the caller's device. ``shard_batch`` puts a
batch on a device mesh as DTensors, the batch dim split over the data
axes.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.common import ModelConfig


def _zipf_tokens(rng: np.random.Generator, shape, vocab: int) -> np.ndarray:
    # Smooth Zipf via inverse-CDF on ranks (a ~ 1.1), capped at vocab.
    u = rng.uniform(size=shape)
    ranks = np.exp(u * np.log(vocab)) - 1.0
    return np.minimum(ranks.astype(np.int64), vocab - 1).astype(np.int32)


def synthetic_batches(cfg: ModelConfig, batch: int, seq: int,
                      seed: int = 0, device=None
                      ) -> Iterator[Dict[str, Any]]:
    """Infinite iterator of {tokens, targets} int32 batches on
    ``device`` (None: the card): (B, S), or (B, K, S) for audio."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    while True:
        if cfg.arch_type == "audio":
            shape = (batch, cfg.n_codebooks, seq + 1)
        else:
            shape = (batch, seq + 1)
        stream = torch.from_numpy(_zipf_tokens(rng, shape, cfg.vocab_size))
        yield {"tokens": stream[..., :-1].to(device),
               "targets": stream[..., 1:].to(device)}


def shard_batch(batch: Dict[str, Any], mesh, batch_axes=("pod", "data")):
    """Place a batch on the mesh, batch dim sharded over the data axes
    the mesh has (every rank holds the whole batch, as every rank draws
    it from the same seed; each keeps its shard)."""
    from torch.distributed.tensor import Replicate, Shard, \
        distribute_tensor
    names = tuple(mesh.mesh_dim_names)

    def put(x):
        # an axis of one rank holds the whole batch: Replicate
        placements = [Shard(0) if a in batch_axes and x.dim() >= 1
                      and n > 1 else Replicate()
                      for a, n in zip(names, mesh.shape)]
        return distribute_tensor(x, mesh, placements)

    return {k: put(v) for k, v in batch.items()}
