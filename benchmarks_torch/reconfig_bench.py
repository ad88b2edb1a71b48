#!/usr/bin/env python3
"""Reconfiguration plan-search benchmark on the port: batched engine vs
naive oracle.

The claim under test is the batched plan search itself: pre-scored
per-fold offset tables + the vectorized single-cube search + fresh-bound
pruning + dirty-cube cache refresh must beat the retained pure-python
offset scan at every cube granularity the paper evaluates (2^3 / 4^3 /
8^3 on the 4096-XPU cluster). Both engines run under the same gated
drain so the delta is the plan search, not the simulator; JCR equality
doubles as an in-bench parity check. Cube sizes, trace, seed, keys and
headline are those of ``benchmarks/reconfig_bench.py``.

The engine is ``cuda`` on the card unless ``--engine``/``--device`` ask
for another (``--engine numpy``: the host); without a card the default
exits non-zero. On ``cuda`` the batched search's mask queries go to the
card while the naive scan stays on the host (it queries no engine), so
the speedups compare the card's query path with a host scan. One
untimed query at the bench's start builds and loads the fitmask kernels
and starts the CUDA context (``allocator_bench.ready_card``). As in the
reference, the bench reports the headline and does not gate on it.

    python3 benchmarks_torch/reconfig_bench.py [--quick] [--num-jobs 120]
        [--engine cuda] [--device cuda] [--out PATH]

The JSON goes to ``--out`` (default
``experiments/reconfig_bench_torch.json``; '' disables), never to the
committed BENCH_*.json snapshots.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path
from typing import Dict

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmarks_torch.allocator_bench import (_run_once,  # noqa: E402
                                              ready_card)
from benchmarks_torch.crash_loop import (add_engine_args,  # noqa: E402
                                         engine_from_args)

CUBE_SIZES = (8, 4, 2)


def _run(cube_n: int, num_jobs: int, seed: int, naive: bool,
         engine=None) -> Dict:
    return _run_once("rfold", dict(num_xpus=4096, cube_n=cube_n), num_jobs,
                     seed, naive=naive, gated=True, engine=engine)


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(prog="reconfig_bench")
    ap.add_argument("--out", type=str, default=os.path.join(
        "experiments", "reconfig_bench_torch.json"),
        help="JSON output ('' disables); never a committed BENCH_*.json")
    ap.add_argument("--num-jobs", type=int, default=120)
    ap.add_argument("--seed", type=int, default=100)
    ap.add_argument("--quick", action="store_true",
                    help="CI-sized run (60 jobs)")
    add_engine_args(ap)
    args = ap.parse_args(argv)
    engine, card = engine_from_args(ap, args)
    ready_card(engine)
    num_jobs = 60 if args.quick else args.num_jobs

    results: Dict = {"config": {"num_jobs": num_jobs, "seed": args.seed,
                                "num_xpus": 4096, "policy": "rfold"},
                     "cube_sizes": {},
                     "engine": engine.resolve_name(), "device": args.device,
                     "card": card}
    print(f"# reconfig plan-search bench, rfold @ {num_jobs} jobs, batched "
          f"on {engine.resolve_name()} (cube,batched_s,naive_s,speedup,jcr)")
    for cube_n in CUBE_SIZES:
        fast = _run(cube_n, num_jobs, args.seed, False, engine)
        naive = _run(cube_n, num_jobs, args.seed, True, engine)
        assert fast["jcr"] == naive["jcr"], (cube_n, fast, naive)
        speedup = round(naive["sim_seconds"] / fast["sim_seconds"], 2) \
            if fast["sim_seconds"] else None
        results["cube_sizes"][f"{cube_n}^3"] = {
            "batched": fast, "naive": naive, "speedup": speedup}
        print("%d^3,%.3f,%.3f,%.1fx,%.3f" % (
            cube_n, fast["sim_seconds"], naive["sim_seconds"], speedup,
            fast["jcr"]))

    speedups = {k: v["speedup"] for k, v in results["cube_sizes"].items()}
    results["headline"] = {
        "criterion": "batched plan search beats the naive oracle at "
                     "every cube size (>= 2x at 8^3)",
        "speedups": speedups,
        "pass": all(s and s > 1.0 for s in speedups.values())
                and speedups["8^3"] >= 2.0,
    }
    print(f"# headline: {speedups} pass={results['headline']['pass']}")
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
        print(f"# wrote {args.out}")
    return results


if __name__ == "__main__":
    main()
