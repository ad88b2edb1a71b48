#!/usr/bin/env python3
"""Beyond-paper scheduler extensions on the port (paper §5 future
directions): aggressive backfill and best-effort scatter placement,
compared against the faithful RFold baseline on identical traces. The
variants, seeds, loads, CSV rows and aggregates are those of
``benchmarks/beyond.py``.

The engine is ``cuda`` on the card unless ``--engine``/``--device`` ask
for another (``--engine numpy``: the host); without a card the default
exits non-zero. On the card one untimed query at the bench's start
builds and loads the fitmask kernels (``allocator_bench.ready_card``).

    python3 benchmarks_torch/beyond.py [--runs 3] [--num-jobs 200]
        [--engine cuda] [--device cuda] [--out PATH]

The JSON goes to ``--out`` (default ``experiments/beyond_torch.json``;
'' disables), never to the committed BENCH_*.json snapshots.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmarks_torch.allocator_bench import ready_card  # noqa: E402
from benchmarks_torch.crash_loop import (add_engine_args,  # noqa: E402
                                         engine_from_args)

VARIANTS = [
    ("rfold (paper FIFO)", "rfold", {}, dict(backfill=False)),
    ("rfold + backfill", "rfold", {}, dict(backfill=True)),
    ("rfold + best-effort", "rfold_be", {}, dict(backfill=False)),
    ("rfold + both", "rfold_be", {}, dict(backfill=True)),
]


def run_variants(runs: int, num_jobs: int, load: float, engine=None,
                 emit=print) -> dict:
    """Each variant's aggregate over ``runs`` seeded traces on ``engine``
    (an engine name or ``EngineConfig``; None: the card), by label;
    emits the reference's CSV rows."""
    from repro_torch.core.allocator import make_policy
    from repro_torch.sim.metrics import aggregate, summarize
    from repro_torch.sim.simulator import Simulator
    from repro_torch.traces.generator import TraceConfig, generate_trace

    emit("variant,jcr,jct_p50,jct_p90,jct_p99,util_mean")
    results = {}
    for label, name, pkw, skw in VARIANTS:
        sums = []
        for r in range(runs):
            cfg = TraceConfig(num_jobs=num_jobs, seed=500 + r,
                              target_load=load)
            pol = make_policy(name, num_xpus=4096, cube_n=4, engine=engine,
                              **pkw)
            res = Simulator(pol, generate_trace(cfg), **skw).run()
            sums.append(summarize(res))
        agg = aggregate(sums)
        results[label] = agg
        emit("%s,%.3f,%.0f,%.0f,%.0f,%.3f" % (
            label, agg["jcr"], agg["jct_p50"], agg["jct_p90"],
            agg["jct_p99"], agg["util_mean"]))
    return results


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="beyond")
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--num-jobs", type=int, default=200)
    ap.add_argument("--load", type=float, default=1.5)
    ap.add_argument("--out", default=os.path.join(
        "experiments", "beyond_torch.json"),
        help="JSON output ('' disables); never a committed BENCH_*.json")
    add_engine_args(ap)
    args = ap.parse_args(argv)
    engine, _ = engine_from_args(ap, args)
    ready_card(engine)
    results = run_variants(args.runs, args.num_jobs, args.load, engine)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)


if __name__ == "__main__":
    main()
