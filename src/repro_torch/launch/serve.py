"""Serving launcher: batched greedy decoding demo over the public API.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \
      --batch 4 --prompt-len 16 --gen 16

Runs on the card unless ``--device cpu`` is given; with no card it
raises. Parameters are random, drawn from a generator seeded with
``--seed``; the prompt comes from numpy's generator with the same seed.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.configs import get_config, smoke_variant
from repro_torch.models import model as lm
from repro_torch.device import resolve_device
from repro_torch.serve import engine


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_variant(cfg)
    cfg = cfg.replace(dtype="float32")
    params = lm.init_model(
        cfg, torch.Generator(device).manual_seed(args.seed), device)
    rng = np.random.default_rng(args.seed)
    if cfg.arch_type == "audio":    # one stream per codebook
        prompt = rng.integers(0, cfg.vocab_size,
                              (args.batch, cfg.n_codebooks, args.prompt_len))
    else:
        prompt = rng.integers(0, cfg.vocab_size,
                              (args.batch, args.prompt_len))

    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.time()
    out = engine.greedy_decode(cfg, params, prompt, steps=args.gen,
                               device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.time() - t0
    n_new = args.gen * args.batch
    print(json.dumps({
        "arch": cfg.name, "batch": args.batch,
        "prompt_len": args.prompt_len, "generated": args.gen,
        "wall_s": round(dt, 2),
        "tok_per_s": round(n_new / dt, 1),
        "output_shape": list(out.shape),
    }))
    if out.shape[-1] != args.prompt_len + args.gen:
        raise RuntimeError(f"greedy_decode returned {tuple(out.shape)}")


if __name__ == "__main__":
    main()
