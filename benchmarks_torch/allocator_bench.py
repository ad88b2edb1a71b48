#!/usr/bin/env python3
"""Allocator / simulator performance benchmark on the port (placement
hot path).

Per policy, the end-to-end simulation wall-clock and the placement rate
(scheduled jobs per second of allocator time) at 80- and 200-job scale
on the paper's 4096-XPU cluster, plus the retained naive RFold path as
the speedup anchor. The policies, scales, seed, trace and keys are
those of ``benchmarks/allocator_bench.py``; placements and JCR equal
the reference's on every engine.

The engine is ``cuda`` on the card unless ``--engine``/``--device`` ask
for another (``--engine numpy``: the host); without a card the default
exits non-zero. On the card one untimed query at the bench's start
builds and loads the fitmask kernels and starts the CUDA context
(``ready_card``), so no row carries nvcc's build. Each timed run is
bracketed by ``torch.cuda.synchronize()``.

The naive anchor (``use_naive``) never queries the engine: its
``place_fold_naive`` scan is pure Python on the host. On ``cuda``,
``speedup_vs_naive`` therefore compares the card's engine with a host
scan; the JSON says so beside it (``naive_engine``).

    python3 benchmarks_torch/allocator_bench.py [--job-scales 80 200]
        [--skip-naive] [--engine cuda] [--device cuda] [--out PATH]

The JSON goes to ``--out`` (default
``experiments/allocator_bench_torch.json``; '' disables), never to the
committed BENCH_*.json snapshots.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path
from typing import Dict

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmarks_torch.crash_loop import (add_engine_args,  # noqa: E402
                                         engine_from_args)

POLICIES = [
    ("firstfit_16c", "firstfit", dict(dims=(16, 16, 16))),
    ("folding_16c", "folding", dict(dims=(16, 16, 16))),
    ("reconfig_4c", "reconfig", dict(num_xpus=4096, cube_n=4)),
    ("rfold_4c", "rfold", dict(num_xpus=4096, cube_n=4)),
    ("rfold_be_4c", "rfold_be", dict(num_xpus=4096, cube_n=4)),
]
NAIVE_ENGINE = ("host: place_fold_naive is pure Python and queries no "
                "engine")


def on_card(engine) -> bool:
    """Whether ``engine`` (an ``EngineConfig``) runs on a CUDA device."""
    import torch

    return engine.resolve_name() != "numpy" and torch.device(
        engine.device or "cuda").type == "cuda"


def ready_card(engine) -> None:
    """On the card: one untimed query through ``engine`` (a multi-box
    and a counts launch on one 2^3 grid), which builds the fitmask
    kernels (an nvcc build takes tens of seconds on a fresh ``build/``),
    loads them and starts the CUDA context, so that no timed run carries
    any of it. Elsewhere: nothing."""
    if not on_card(engine):
        return
    import numpy as np
    import torch

    fitmask = engine.get_engine()
    occ = np.zeros((1, 2, 2, 2), dtype=bool)
    fitmask.multibox(occ, [(1, 1, 1)])
    fitmask.free_counts(occ)
    torch.cuda.synchronize()


def sync(engine) -> None:
    """``torch.cuda.synchronize()`` where ``engine`` runs on the card."""
    if on_card(engine):
        import torch

        torch.cuda.synchronize()


def _run_once(name: str, kw: dict, num_jobs: int, seed: int,
              naive: bool = False, gated: bool = True,
              engine=None) -> Dict:
    """One seeded simulation of policy ``name`` on ``engine`` (an engine
    name or ``EngineConfig``; None: the card): its wall, placements,
    placement rate and JCR, under the reference's keys."""
    from repro_torch.core.allocator import make_policy
    from repro_torch.core.engineconfig import EngineConfig
    from repro_torch.sim.simulator import Simulator
    from repro_torch.traces.generator import TraceConfig, generate_trace

    engine = EngineConfig.coerce(engine)
    pol = make_policy(name, engine=engine, **kw)
    if naive:
        pol.use_naive = True
    jobs = generate_trace(TraceConfig(num_jobs=num_jobs, seed=seed,
                                      target_load=1.5))
    sync(engine)
    t0 = time.perf_counter()
    res = Simulator(pol, jobs, gated=gated).run()
    sync(engine)
    wall = time.perf_counter() - t0
    placed = sum(1 for j in res.jobs if j.scheduled)
    return {
        "sim_seconds": round(wall, 4),
        "placements": placed,
        "placements_per_sec": round(placed / wall, 1) if wall else None,
        "jcr": round(res.jcr, 4),
    }


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(prog="allocator_bench")
    ap.add_argument("--out", type=str, default=os.path.join(
        "experiments", "allocator_bench_torch.json"),
        help="JSON output ('' disables); never a committed BENCH_*.json")
    ap.add_argument("--job-scales", type=int, nargs="+", default=[80, 200])
    ap.add_argument("--seed", type=int, default=100)
    ap.add_argument("--skip-naive", action="store_true",
                    help="skip the slow naive-RFold baseline run")
    add_engine_args(ap)
    args = ap.parse_args(argv)
    engine, card = engine_from_args(ap, args)
    ready_card(engine)

    results: Dict = {"policies": {}, "baseline": {},
                     "engine": engine.resolve_name(), "device": args.device,
                     "card": card}
    for scale in args.job_scales:
        print(f"# allocator bench @ {scale} jobs on {engine.resolve_name()} "
              f"(policy,sim_seconds,placements_per_sec,jcr)")
        for label, name, kw in POLICIES:
            r = _run_once(name, kw, scale, args.seed, engine=engine)
            results["policies"].setdefault(label, {})[str(scale)] = r
            print("%s,%.3f,%.0f,%.3f" % (label, r["sim_seconds"],
                                         r["placements_per_sec"], r["jcr"]))

    if not args.skip_naive:
        # Speedup anchor: the retained naive engine + ungated drain on the
        # acceptance workload (RFold 4^3, 80 jobs).
        naive = _run_once("rfold", dict(num_xpus=4096, cube_n=4), 80,
                          args.seed, naive=True, gated=False, engine=engine)
        fast = results["policies"]["rfold_4c"]["80"]
        results["baseline"] = {
            "naive_rfold_80": naive,
            "speedup_vs_naive": round(
                naive["sim_seconds"] / fast["sim_seconds"], 1),
            "naive_engine": NAIVE_ENGINE,
        }
        print("naive_rfold_80,%.3f  speedup %.1fx (%s against the naive "
              "host scan)" % (naive["sim_seconds"],
                              results["baseline"]["speedup_vs_naive"],
                              engine.resolve_name()))

    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
        print(f"# wrote {args.out}")
    return results


if __name__ == "__main__":
    main()
