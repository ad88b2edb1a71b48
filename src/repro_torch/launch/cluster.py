"""RFold-scheduled multi-tenant cluster driver — the paper's technique
as a first-class feature of the training framework.

Jobs (arch + parallelism shape) are submitted to an RFold scheduler
managing a (simulated) reconfigurable torus. Each admitted job gets a
folded, contention-free allocation; the launcher then builds a device
mesh whose rank order follows the allocation's ring traversal
(mesh_from_allocation), and runs training steps for the job on that
mesh. The scheduler's placement search runs on the port's fitmask
engine (the card's kernels by default). Here the torus XPUs are
placeholder ranks of the process group, taken in index order; a
deployment maps each torus coordinate to its rank.

Every rank runs the same program and makes the same (deterministic)
placement decisions, so every rank builds every job's mesh (building a
mesh is collective); a rank outside a job's mesh skips its steps.

  PYTHONPATH=src python -m repro_torch.launch.cluster --jobs 4 --steps 3
  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.cluster
"""
from __future__ import annotations

import argparse
import json
from typing import Dict, List, Optional

import torch
import torch.distributed as dist

from repro_torch.configs import get_config, smoke_variant
from repro_torch.core.allocator import RFoldPolicy
from repro_torch.core.engineconfig import EngineConfig
from repro_torch.core.geometry import JobShape
from repro_torch.device import resolve_device
from repro_torch.models import model as lm
from repro_torch.parallel.sharding import (distribute_params, full_tensor,
                                           logical_rules, rules_for)
from repro_torch.train.data import shard_batch, synthetic_batches
from repro_torch.train.optim import OptimConfig, init_opt_state
from repro_torch.train.train_step import train_step
from .mesh import ensure_process_group, mesh_from_allocation

SUBMISSIONS = (
    ("olmo-1b", JobShape((2, 2, 1))),
    ("llama3-8b", JobShape((4, 1, 1))),
    ("xlstm-1.3b", JobShape((2, 1, 1))),
    ("musicgen-medium", JobShape((2, 2, 1))),
    ("zamba2-1.2b", JobShape((6, 1, 1))),
)


class RFoldCluster:
    """Thin runtime wrapper: RFold placement -> device mesh -> job steps.

    ``engine``: the placement search's fitmask engine (an
    ``EngineConfig``, a registry name, or None for the card's kernels);
    ``device``: where the jobs train (None: the card). A process group
    must be up (``launch.mesh.ensure_process_group``)."""

    def __init__(self, num_xpus: int = 64, cube_n: int = 2, engine=None,
                 device=None):
        self.policy = RFoldPolicy(num_xpus=num_xpus, cube_n=cube_n,
                                  engine=engine)
        self.num_xpus = num_xpus
        self.device = resolve_device(device)
        self.jobs: Dict[int, dict] = {}

    def submit(self, job_id: int, arch: str, shape: JobShape,
               seed: int = 0) -> Optional[dict]:
        placement = self.policy.try_place(job_id, shape)
        if placement is None:
            return None
        # Device mesh: (data, model) = (product of non-model dims, model)
        # The fold's ring order is the rank order, so the model axis
        # ring maps onto torus-neighbour links.
        dims = sorted(shape.dims, reverse=True)
        model_par = dims[1] if dims[1] > 1 else 1
        data_par = shape.size // model_par
        mesh = mesh_from_allocation(
            [(0, 0, i) for i in range(shape.size)],  # placeholder coords
            (data_par, model_par), ("data", "model"), device=self.device)
        cfg = smoke_variant(get_config(arch)).replace(dtype="float32")
        # drawn on the host: a job's weights do not depend on its device
        params = lm.tree_map(
            lambda t: t.to(self.device),
            lm.init_model(cfg, torch.Generator().manual_seed(seed), "cpu"))
        params = distribute_params(params, mesh, rules_for(mesh),
                                   n_expert_hint=cfg.n_experts)
        job = {
            "id": job_id, "arch": arch, "shape": str(shape),
            "placement": placement.meta, "mesh": mesh, "cfg": cfg,
            "params": params,
            "opt": init_opt_state(params),
            "opt_cfg": OptimConfig(lr=1e-3, warmup_steps=1,
                                   total_steps=100),
            "data": synthetic_batches(cfg, batch=max(data_par, 1),
                                      seq=32, seed=seed,
                                      device=self.device),
        }
        self.jobs[job_id] = job
        return job

    def run_steps(self, job_id: int, steps: int) -> List[float]:
        """The job's CE per step; [] on a rank outside its mesh."""
        job = self.jobs[job_id]
        cfg, mesh = job["cfg"], job["mesh"]
        if mesh.get_coordinate() is None:
            return []
        rules = rules_for(mesh)
        losses = []
        for _ in range(steps):
            batch = shard_batch(next(job["data"]), mesh)
            with logical_rules(rules):
                job["params"], job["opt"], m = train_step(
                    cfg, job["opt_cfg"], job["params"], job["opt"], batch)
            losses.append(float(full_tensor(m["ce"])))
        return losses

    def finish(self, job_id: int) -> None:
        self.policy.release(job_id)
        self.jobs.pop(job_id, None)

    def utilization(self) -> float:
        return self.policy.utilization()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--jobs", type=int, default=3)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--num-xpus", type=int, default=0,
                    help="default: the process group's world size, "
                    "rounded up to whole cubes")
    ap.add_argument("--cube-n", type=int, default=2)
    ap.add_argument("--engine", default=None,
                    help="fitmask engine (default: the card's kernels)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    created = ensure_process_group(args.device)
    try:
        n_dev = dist.get_world_size()
        lead = dist.get_rank() == 0
        # repro takes num_xpus = n_dev, which raises below one cube
        # (num_xpus must be a multiple of cube_n**3); whole cubes here
        vol = args.cube_n ** 3
        num_xpus = args.num_xpus or -(-n_dev // vol) * vol
        cluster = RFoldCluster(
            num_xpus=num_xpus, cube_n=args.cube_n,
            engine=EngineConfig(args.engine, device=args.device),
            device=args.device)
        for jid, (arch, shape) in enumerate(SUBMISSIONS[:args.jobs]):
            if shape.size > n_dev:
                if lead:
                    print(f"job {jid}: {arch} {shape} skipped (needs "
                          f"{shape.size} devices, have {n_dev})")
                continue
            job = cluster.submit(jid, arch, shape, seed=jid)
            if job is None:
                if lead:
                    print(f"job {jid}: {arch} {shape} -> queued "
                          f"(no allocation)")
                continue
            if lead:
                print(f"job {jid}: {arch} shape={shape} -> fold="
                      f"{job['placement'].get('fold')} cubes="
                      f"{job['placement'].get('num_cubes')} "
                      f"util={cluster.utilization():.2f}")
            losses = cluster.run_steps(jid, args.steps)
            if lead:
                print(f"  losses: {[round(l, 3) for l in losses]}")
            cluster.finish(jid)
        if lead:
            print(json.dumps({"final_utilization": cluster.utilization()}))
    finally:
        if created:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
