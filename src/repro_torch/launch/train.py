"""Training launcher: end-to-end training over the synthetic pipeline.

  PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \
      --smoke --steps 50 --batch 8 --seq 128

Runs on the card unless ``--device cpu`` is given; with no card it
raises. Parameters are random, drawn from a generator seeded with
``--seed``; the data comes from numpy's generator with the same seed,
as ``repro``'s. Prints the reference's JSON history lines and fails if
training diverged.

``--mesh DxM`` trains on a data x model mesh over the ranks of the
process group: the params are DTensors placed by the sharding rules,
each batch is sharded over ``data``, and the step runs under the rules.
Start several ranks with ``torchrun --nproc-per-node N -m
repro_torch.launch.train --mesh ...``; without ``torchrun`` the launcher
starts a process group of one rank itself (NCCL on the card, gloo on
``--device cpu``). A mesh larger than the group raises. Only rank 0
prints.
"""
from __future__ import annotations

import argparse
import json
import time

import torch
import torch.distributed as dist

from repro_torch.configs import get_config, smoke_variant
from repro_torch.device import resolve_device
from repro_torch.models import model as lm
from repro_torch.parallel.sharding import (distribute_params, full_tensor,
                                           logical_rules, rules_for)
from repro_torch.train.checkpoint import save_checkpoint
from repro_torch.train.data import shard_batch, synthetic_batches
from repro_torch.train.optim import OptimConfig, init_opt_state
from repro_torch.train.train_step import train_step
from .mesh import ensure_process_group, make_mesh


def main(argv=None) -> list:
    """Returns the history lines it printed."""
    ap = argparse.ArgumentParser(
        description="Train on one device, or with --mesh on a data x "
        "model mesh over the process group's ranks.")
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
    ap.add_argument("--mesh", type=str, default="",
                    help="e.g. '4x2' => data x model over the process "
                    "group's ranks")
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

    created = ensure_process_group(device) if args.mesh else False
    try:
        return _train(args, cfg, device)
    finally:
        if created:
            dist.destroy_process_group()


def _train(args, cfg, device) -> list:
    mesh = rules = None
    lead = True
    if args.mesh:
        shape = tuple(int(x) for x in args.mesh.split("x"))
        mesh = make_mesh(shape, ("data", "model")[:len(shape)], device)
        rules = rules_for(mesh)
        lead = dist.get_rank() == 0

    params = lm.init_model(
        cfg, torch.Generator(device).manual_seed(args.seed), device)
    n_params = sum(t.numel() for t in lm.tree_leaves(params))
    if lead:
        print(f"arch={cfg.name} params={n_params/1e6:.1f}M "
              f"layers={cfg.n_layers} d={cfg.d_model}")

    opt_cfg = OptimConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 1),
                          total_steps=args.steps)
    if mesh is not None:
        params = distribute_params(params, mesh, rules,
                                   n_expert_hint=cfg.n_experts)
    opt_state = init_opt_state(params)

    data = synthetic_batches(cfg, args.batch, args.seq, seed=args.seed,
                             device=device)
    t0 = time.time()
    history = []
    for i in range(args.steps):
        batch = next(data)
        if mesh is not None:
            batch = shard_batch(batch, mesh)
        with logical_rules(rules):
            params, opt_state, m = train_step(cfg, opt_cfg, params,
                                              opt_state, batch)
        if i % args.log_every == 0 or i == args.steps - 1:
            history.append({"step": i, "ce": float(full_tensor(m["ce"])),
                            "lr": float(full_tensor(m["lr"])),
                            "grad_norm": float(full_tensor(m["grad_norm"])),
                            "elapsed_s": round(time.time() - t0, 1)})
            if lead:
                print(json.dumps(history[-1]), flush=True)
    if args.ckpt:
        if mesh is not None:        # every rank takes part in the gather
            params = lm.tree_map(full_tensor, params)
            opt_state = lm.tree_map(full_tensor, opt_state)
        if lead:
            save_checkpoint(args.ckpt, params, opt_state, step=args.steps,
                            meta={"arch": cfg.name,
                                  "ce": history[-1]["ce"]})
            print(f"saved checkpoint to {args.ckpt}")
    if not history[-1]["ce"] < history[0]["ce"] + 0.5:
        raise AssertionError("training diverged")
    return history


if __name__ == "__main__":
    main()
