#!/usr/bin/env python3
"""Quickstart on the port: train the olmo-1b smoke model for 10 steps,
then generate greedily.

    python3 examples_torch/quickstart.py                  # the card
    python3 examples_torch/quickstart.py --device cpu     # the host
"""
import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.device import resolve_device
    from repro_torch.models import model as lm
    from repro_torch.serve import engine
    from repro_torch.train.data import synthetic_batches
    from repro_torch.train.optim import OptimConfig, init_opt_state
    from repro_torch.train.train_step import train_step

    device = resolve_device(args.device)
    cfg = smoke_variant(get_config("olmo-1b")).replace(dtype="float32")
    params = lm.init_model(cfg, torch.Generator(device).manual_seed(0),
                           device)
    opt_cfg = OptimConfig(lr=3e-3, warmup_steps=2, total_steps=20)
    opt = init_opt_state(params)
    data = synthetic_batches(cfg, batch=4, seq=64, seed=0, device=device)
    history = []
    for i in range(10):
        params, opt, m = train_step(cfg, opt_cfg, params, opt, next(data))
        history.append(float(m["ce"]))
        print(f"step {i}: ce={history[-1]:.3f} "
              f"grad_norm={float(m['grad_norm']):.2f}")
    prompt = [[1, 2, 3, 4, 5, 6, 7, 8]]
    out = engine.greedy_decode(cfg, params, prompt, steps=8, device=device)
    print("generated:", out[0, 8:].tolist())
    return history, out


if __name__ == "__main__":
    main()
