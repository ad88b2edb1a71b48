#!/usr/bin/env python3
"""Benchmark orchestrator on the port: one section per paper table/figure
plus the framework microbenches (``name,us_per_call,derived`` CSV) and the
roofline summary, in ``benchmarks/run.py``'s order, through the port's
benches in ``benchmarks_torch/``.

    python3 benchmarks_torch/run.py            # CI-sized, on the card
    python3 benchmarks_torch/run.py --full     # paper-scale
    python3 benchmarks_torch/run.py --engine numpy   # on the host

``--engine``/``--device`` go to every bench that takes them; with
neither, each bench runs on the card and exits non-zero without one.
The fitmask kernel bench runs on the card only, so ``--engine numpy`` or
``--device cpu`` skips its section. Every output goes to
``experiments/*_torch*.json`` (``--full`` too, where the reference writes
the committed BENCH_*.json snapshots); the roofline section reads the
dry-run JSONs of ``python -m repro_torch.launch.dryrun`` in
``experiments/dryrun_torch``.
"""
from __future__ import annotations

import argparse
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

EXP = "experiments"


def _out(name: str, full: bool) -> str:
    """``experiments/<name>.json``, or ``<name>_quick.json`` for the
    CI-sized run."""
    return os.path.join(EXP, f"{name}{'' if full else '_quick'}.json")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="run")
    ap.add_argument("--full", action="store_true",
                    help="paper-scale averaging (100 runs)")
    ap.add_argument("--runs", type=int, default=2)
    ap.add_argument("--num-jobs", type=int, default=120)
    ap.add_argument("--workers", type=int, default=None,
                    help="eval process-pool width (default: paper_eval's)")
    ap.add_argument("--engine", type=str, default=None,
                    help="fitmask engine of every bench (default: cuda)")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device of a tensor engine (default: the "
                         "card)")
    ap.add_argument("--skip-paper", action="store_true")
    ap.add_argument("--skip-micro", action="store_true")
    ap.add_argument("--skip-alloc", action="store_true")
    ap.add_argument("--skip-fitmask", action="store_true")
    ap.add_argument("--skip-reconfig", action="store_true")
    ap.add_argument("--skip-fleet", action="store_true")
    ap.add_argument("--skip-service", action="store_true")
    ap.add_argument("--skip-chaos", action="store_true")
    ap.add_argument("--skip-crash", action="store_true")
    ap.add_argument("--skip-failover", action="store_true")
    args = ap.parse_args(argv)
    t0 = time.time()

    from benchmarks_torch import (allocator_bench, chaos_bench, crash_loop,
                                  failover_drill, fitmask_bench, fleet_bench,
                                  kernels_bench, paper_eval, reconfig_bench,
                                  roofline, service_bench)

    eng = []
    if args.engine is not None:
        eng += ["--engine", args.engine]
    if args.device is not None:
        eng += ["--device", args.device]
    import torch

    on_card = args.engine != "numpy" and torch.device(
        args.device or "cuda").type == "cuda"
    full = args.full

    os.makedirs(EXP, exist_ok=True)
    if not args.skip_paper:
        print("=" * 70)
        print("## Paper evaluation (Table 1 / Fig 3 / Fig 4)")
        eval_args = ["--runs", str(args.runs),
                     "--num-jobs", str(args.num_jobs)]
        if full:
            eval_args = ["--full"]
        if args.workers is not None:
            eval_args += ["--workers", str(args.workers)]
        # paper_eval fans the run x policy matrix across the eval runner
        # with per-run checkpointing (see repro_torch.eval); wall-clock
        # stats land beside the allocator bench's JSON.
        paper_eval.main(eval_args + eng + [
            "--out", os.path.join(EXP, "paper_eval_torch.json"),
            "--bench-out", os.path.join(EXP, "paper_eval_torch_bench.json")])

    if not args.skip_alloc:
        print("=" * 70)
        print("## Allocator / placement-engine benchmark")
        allocator_bench.main(eng + ["--out", os.path.join(
            EXP, "allocator_bench_torch.json")])

    if not args.skip_reconfig:
        print("=" * 70)
        print("## Reconfiguration plan-search benchmark (batched vs naive)")
        reconfig_bench.main(([] if full else ["--quick"]) + eng + [
            "--out", _out("reconfig_bench_torch", full)])

    if not args.skip_fleet:
        print("=" * 70)
        print("## Fleet-batched eval benchmark (broker-coalesced vs "
              "sequential)")
        fleet_bench.main(([] if full else ["--quick"]) + eng + [
            "--out", _out("fleet_bench_torch", full)])

    if not args.skip_service:
        print("=" * 70)
        print("## Allocator-service benchmark (daemon parity / p99 "
              "latency / admission)")
        service_bench.main(([] if full else ["--quick"]) + eng + [
            "--out", _out("service_bench_torch", full)])

    if not args.skip_chaos:
        print("=" * 70)
        print("## Chaos benchmark (scenario x policy degradation matrix)")
        chaos_bench.main(([] if full else ["--quick"]) + eng + [
            "--out", _out("chaos_bench_torch", full)])

    if not args.skip_crash:
        print("=" * 70)
        print("## Crash-loop drill (SIGKILL recovery, digest-identical "
              "replay)")
        crash_loop.main(([] if full else ["--quick"]) + eng + [
            "--out", _out("crash_loop_torch", full)])

    if not args.skip_failover:
        print("=" * 70)
        print("## Failover drill (kill -9 primary, fenced promotion, "
              "replication lag)")
        failover_drill.main(([] if full else ["--quick"]) + eng + [
            "--out", _out("failover_drill_torch", full)])

    if not args.skip_fitmask:
        print("=" * 70)
        print("## Fitmask kernel benchmark (multi-box vs single-box)")
        if on_card:
            rc = fitmask_bench.main(([] if full else ["--quick"]) + [
                "--out", _out("fitmask_bench_torch", full)])
            if rc:
                raise SystemExit(rc)
        else:
            print("(skipped: the fitmask kernels run on the card only)")

    if not args.skip_micro:
        print("=" * 70)
        print("## Microbenchmarks (plain versions; the card's kernels "
              "beside them on a CUDA device)")
        kernels_bench.main(eng)

    print("=" * 70)
    print("## Roofline summary (from dry-run artifacts, H100 terms)")
    dryrun_dir = os.path.join(EXP, "dryrun_torch")
    if os.path.isdir(dryrun_dir) and os.listdir(dryrun_dir):
        roofline.main(["--dryrun-dir", dryrun_dir, "--mesh", "single",
                       "--out", os.path.join(EXP, "roofline_torch.json")])
    else:
        print("(no dry-run artifacts yet: run "
              "`python -m repro_torch.launch.dryrun --all --mesh both`)")

    print(f"# benchmarks total {time.time() - t0:.0f}s")


if __name__ == "__main__":
    main()
