#!/usr/bin/env python3
"""Batched serving demo on the port: KV-cache greedy decode of the
llama3-8b smoke model, then its sliding-window variant.

    python3 examples_torch/serve_batch.py                 # the card
    python3 examples_torch/serve_batch.py --device cpu    # the host
"""
import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch

    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.device import resolve_device
    from repro_torch.models import model as lm
    from repro_torch.serve import engine

    device = resolve_device(args.device)
    cfg = smoke_variant(get_config("llama3-8b")).replace(dtype="float32")
    params = lm.init_model(cfg, torch.Generator(device).manual_seed(0),
                           device)
    rng = np.random.default_rng(0)
    batch, prompt_len, gen = 8, 32, 32
    prompts = rng.integers(0, cfg.vocab_size, (batch, prompt_len))
    t0 = time.time()
    out = engine.greedy_decode(cfg, params, prompts, steps=gen,
                               device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.time() - t0
    print(f"served {batch} requests x {gen} new tokens in {dt:.1f}s "
          f"({batch * gen / dt:.1f} tok/s on {device.type})")
    print("first output:", out[0, prompt_len:prompt_len + 8].tolist())
    # sliding-window variant (long-context serving mode)
    cfg_w = cfg.replace(sliding_window=16)
    out_w = engine.greedy_decode(cfg_w, params, prompts, steps=4,
                                 window=16, device=device)
    print("sliding-window decode ok:", tuple(out_w.shape))


if __name__ == "__main__":
    main()
