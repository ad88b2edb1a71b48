"""Training launcher: end-to-end training over the synthetic pipeline.

  PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \
      --smoke --steps 50 --batch 8 --seq 128

Runs on the card unless ``--device cpu`` is given; with no card it
raises. One device: ``repro``'s ``--mesh`` (data x model over local
devices) comes with the port of ``parallel/``. Parameters are random,
drawn from a generator seeded with ``--seed``; the data comes from
numpy's generator with the same seed, as ``repro``'s. Prints the
reference's JSON history lines and fails if training diverged.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch.configs import get_config, smoke_variant
from repro_torch.device import resolve_device
from repro_torch.models import model as lm
from repro_torch.train.checkpoint import save_checkpoint
from repro_torch.train.data import synthetic_batches
from repro_torch.train.optim import OptimConfig, init_opt_state
from repro_torch.train.train_step import train_step


def main(argv=None) -> list:
    """Returns the history lines it printed."""
    ap = argparse.ArgumentParser(
        description="Train on one device; --mesh (data x model over "
        "several devices) is not ported yet.")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--d-model", type=int, default=0,
                    help="override smoke d_model (e.g. ~100M params)")
    ap.add_argument("--n-layers", type=int, default=0)
    ap.add_argument("--ckpt", type=str, default="")
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_variant(cfg)
    over = {}
    if args.d_model:
        over["d_model"] = args.d_model
    if args.n_layers:
        over["n_layers"] = args.n_layers
    if over:
        cfg = cfg.replace(**over)
    cfg = cfg.replace(dtype="float32")  # repro's numerics

    params = lm.init_model(
        cfg, torch.Generator(device).manual_seed(args.seed), device)
    n_params = sum(t.numel() for t in lm.tree_leaves(params))
    print(f"arch={cfg.name} params={n_params/1e6:.1f}M "
          f"layers={cfg.n_layers} d={cfg.d_model}")

    opt_cfg = OptimConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 1),
                          total_steps=args.steps)
    opt_state = init_opt_state(params)

    data = synthetic_batches(cfg, args.batch, args.seq, seed=args.seed,
                             device=device)
    t0 = time.time()
    history = []
    for i in range(args.steps):
        params, opt_state, m = train_step(cfg, opt_cfg, params, opt_state,
                                          next(data))
        if i % args.log_every == 0 or i == args.steps - 1:
            history.append({"step": i, "ce": float(m["ce"]),
                            "lr": float(m["lr"]),
                            "grad_norm": float(m["grad_norm"]),
                            "elapsed_s": round(time.time() - t0, 1)})
            print(json.dumps(history[-1]), flush=True)
    if args.ckpt:
        save_checkpoint(args.ckpt, params, opt_state, step=args.steps,
                        meta={"arch": cfg.name, "ce": history[-1]["ce"]})
        print(f"saved checkpoint to {args.ckpt}")
    if not history[-1]["ce"] < history[0]["ce"] + 0.5:
        raise AssertionError("training diverged")
    return history


if __name__ == "__main__":
    main()
