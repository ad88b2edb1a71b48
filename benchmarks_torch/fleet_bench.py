#!/usr/bin/env python3
"""Fleet-batched eval benchmark of the port: one engine, many simulators.

    python3 benchmarks_torch/fleet_bench.py [--quick] [--out PATH]
        [--engine cuda] [--device cuda] [--inflight 1 2]
        [--quorum auto] [--timeout auto] [--profile]

Three sections, as ``benchmarks/fleet_bench.py`` has them:

* **Parity + host headline.** The CI-sized eval matrix (3 runs x 200
  jobs x the 8 Table 1 / Fig 3 configurations; ``--quick`` shrinks it)
  runs per-task (``fleet_size=0``, the runner's default on ``numpy``)
  and as fleets of ``PARITY_FLEET_SIZE``, both on the host ``numpy``
  engine at ``workers=0``, after an
  untimed first pass and then in turns. Records
  and the Table 1 / Fig 3 / Fig 4 aggregates must be byte-identical;
  ``pass_numpy`` also asks the fleet side to be no slower
  (``NUMPY_FLOOR``).

* **Engine replay.** An eval-shaped query stream (per round, each of N
  simulators submits one multibox over its own 16^3 occupancy against
  a shared set of 20 boxes, then one free-counts query: the
  static-torus epoch pattern) goes through the real broker under the
  fleet's flush policy, one thread per simulator, on ``--engine``
  (default ``cuda``, on the card), at each ``--inflight`` lane count
  (default 1 and 2). The same stream is then answered by per-simulator
  batch-1 calls, each copied to the host as the inline mask client
  copies it. Answers must agree; ``pass_engine`` asks the broker to be
  ``ENGINE_FLOOR`` times faster, with batched calls.

* **Eval on the engine.** The parity matrix per task on numpy and on
  ``--engine``, and as fleets on ``--engine`` at each ``--inflight``
  lane count, in turns (every path, then every path again in reverse
  order), each with records equal to per-task numpy's, with the broker's flush
  triggers and where its time went (``park_s``: seconds queries sat
  parked, summed; ``engine_s``: seconds in engine calls, copies
  included). Skipped for ``--engine numpy``. ``--quorum`` and
  ``--timeout`` (default ``auto``: the fleet's engine-aware policy) set
  the broker's flush policy here and in the replay.

* **Canary drill.** A broker on ``--engine`` (``cuda``) gets two
  injected faults, fails over to the next engine of the chain on the
  same device (``torch`` on the card), and the first post-failover
  flushes are checked against the host numpy oracle: 0 mismatches.
  Skipped for ``--engine numpy``, the chain's floor (nothing to fail
  over to).

``--profile`` adds a cProfile of one per-task run of ``PROFILE_CONFIG``
(the configuration with the most mask queries, 200 jobs) on
``--engine`` and on numpy: the host functions that take the time, top
15 by own time.

The pass fields are reported as found; the bench fails only where an
answer differs. Prints the card's name and power limit when the engine
runs on the card, and writes its JSON to ``--out`` (default
``experiments/fleet_bench_torch.json``; ``''`` writes nothing).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path
from typing import Dict

import numpy as np

ROOT = Path(__file__).resolve().parents[1]

# The reference bench's floors: fleet mode may not slow the host path
# down, and must beat per-sim batch-1 driving on a device engine by 5x.
NUMPY_FLOOR = 1.0
ENGINE_FLOOR = 5.0

# Fleets of the parity section: what fleet_size "auto" gives a device
# engine for the CI-sized matrix (24 tasks) at workers=0.
PARITY_FLEET_SIZE = 6

# benchmarks/paper_eval.py: TABLE1_CONFIGS + FIG3_EXTRA_CONFIGS.
EVAL_CONFIGS = [
    ("FirstFit (16^3)", "firstfit", dict(dims=(16, 16, 16))),
    ("Folding (16^3)", "folding", dict(dims=(16, 16, 16))),
    ("Reconfig (8^3)", "reconfig", dict(num_xpus=4096, cube_n=8)),
    ("RFold (8^3)", "rfold", dict(num_xpus=4096, cube_n=8)),
    ("Reconfig (4^3)", "reconfig", dict(num_xpus=4096, cube_n=4)),
    ("RFold (4^3)", "rfold", dict(num_xpus=4096, cube_n=4)),
    ("Reconfig (2^3)", "reconfig", dict(num_xpus=4096, cube_n=2)),
    ("RFold (2^3)", "rfold", dict(num_xpus=4096, cube_n=2)),
]

PROFILE_CONFIG = "RFold (8^3)"

# The static-torus epoch pattern: K = 20 candidate boxes, the scale a
# folding policy's fold enumeration produces per step.
REPLAY_BOXES = ((1, 1, 8), (1, 2, 4), (1, 4, 8), (2, 2, 2), (2, 2, 8),
                (2, 4, 2), (2, 4, 8), (2, 8, 4), (4, 2, 2), (4, 4, 1),
                (4, 4, 4), (4, 8, 2), (8, 2, 1), (8, 4, 4), (8, 8, 2),
                (8, 8, 8), (16, 1, 1), (16, 2, 2), (16, 4, 1),
                (16, 16, 1))


def strip(records):
    return [{k: v for k, v in r.items() if k != "sim_s"} for r in records]


def figures(records) -> Dict:
    from repro_torch.eval import aggregate_by_label, fig3, fig4, table1
    aggs = aggregate_by_label(records)
    return {"table1": table1(aggs), "fig3": fig3(aggs), "fig4": fig4(aggs)}


def same_figures(a, b) -> bool:
    """Records (``sim_s`` aside) and Table 1 / Fig 3 / Fig 4 equal."""
    return strip(a) == strip(b) and (
        json.dumps(figures(a), sort_keys=True, default=float)
        == json.dumps(figures(b), sort_keys=True, default=float))


def parity_section(runs: int, num_jobs: int, seed0: int) -> Dict:
    """Per-task oracle against fleets, both on the host numpy engine,
    after one untimed per-task pass (the first pass in a process fills
    the fold and plan caches and runs about twice as long), then in
    turns: per task, fleet, fleet, per task."""
    from repro_torch.core.engineconfig import EngineConfig
    from repro_torch.eval import EvalRunner, make_tasks

    tasks = make_tasks(EVAL_CONFIGS, runs=runs, num_jobs=num_jobs,
                       load=1.5, seed0=seed0)
    seq_cfg, fleet_cfg = (EngineConfig("numpy", fleet_size=0),
                          EngineConfig("numpy",
                                       fleet_size=PARITY_FLEET_SIZE))
    t0 = time.perf_counter()
    want = EvalRunner(workers=0, engine=seq_cfg).run(tasks)
    warm_s = time.perf_counter() - t0
    walls = {"sequential": [], "fleet": []}
    identical, fleet = True, None
    for name, cfg in (("sequential", seq_cfg), ("fleet", fleet_cfg),
                      ("fleet", fleet_cfg), ("sequential", seq_cfg)):
        runner = EvalRunner(workers=0, engine=cfg)
        t0 = time.perf_counter()
        records = runner.run(tasks)
        walls[name].append(time.perf_counter() - t0)
        identical = identical and same_figures(records, want)
        fleet = runner.last_stats.get("fleet") or fleet
    seq_s, fleet_s = (sum(w) / len(w) for w in walls.values())
    return {
        "runs": runs, "num_jobs": num_jobs, "configs": len(EVAL_CONFIGS),
        "tasks": len(tasks), "identical": identical, "warm_up_s": warm_s,
        "sequential_walls_s": walls["sequential"],
        "fleet_walls_s": walls["fleet"],
        "sequential_s": seq_s, "fleet_s": fleet_s,
        "numpy_speedup": seq_s / fleet_s if fleet_s else None,
        "fleet": fleet,
    }, want


def sync(device) -> None:
    import torch
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def engine_section(sims: int, rounds: int, seed0: int, engine: str,
                   device, max_inflight: int, quorum="auto",
                   timeout="auto", passes: int = 3) -> Dict:
    """Replay ``rounds`` rounds of ``sims`` simulators' queries through
    the broker (the fleet's flush policy, ``max_inflight`` lanes)
    against per-simulator batch-1 calls; best of ``passes`` each."""
    from repro_torch.core.engineconfig import EngineConfig
    from repro_torch.core.maskquery import to_numpy
    from repro_torch.kernels.fitmask import kernel, ops
    from repro_torch.sim.fleet import Fleet

    cfg = EngineConfig(engine, device=device, max_inflight=max_inflight,
                       quorum=quorum, timeout=timeout)
    eng = ops.get_engine(engine, device=device)
    rng = np.random.default_rng(seed0)
    occ = rng.random((sims, rounds, 1, 16, 16, 16)) < \
        rng.uniform(0.1, 0.6, size=(sims, rounds, 1, 1, 1, 1))

    def drive_sequential():
        return [[(to_numpy(eng.multibox(occ[s, t], REPLAY_BOXES)),
                  to_numpy(eng.free_counts(occ[s, t])))
                 for t in range(rounds)] for s in range(sims)]

    def drive_fleet():
        broker = Fleet(cfg).broker
        out = [[None] * rounds for _ in range(sims)]

        def sim(s):
            try:
                for t in range(rounds):
                    out[s][t] = (broker.multibox(occ[s, t], REPLAY_BOXES),
                                 broker.free_counts(occ[s, t]))
            finally:
                broker.deactivate()

        for _ in range(sims):
            broker.register()
        threads = [threading.Thread(target=sim, args=(s,), daemon=True)
                   for s in range(sims)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        if any(th.is_alive() for th in threads):
            raise RuntimeError("replay: a simulator thread did not finish")
        return out, broker.stats

    def best(fn):
        fn()                                   # warm
        kept = None
        for _ in range(passes):
            kernel.reset_launch_counts()
            sync(device)
            t0 = time.perf_counter()
            out = fn()
            sync(device)
            dt = time.perf_counter() - t0
            if kept is None or dt < kept[0]:
                kept = (dt, out, kernel.launch_counts())
        return kept

    fleet_s, (fleet_out, stats), fleet_launches = best(drive_fleet)
    seq_s, seq_out, seq_launches = best(drive_sequential)
    identical = all(
        np.array_equal(a[0] != 0, b[0] != 0) and np.array_equal(a[1], b[1])
        for srow, frow in zip(seq_out, fleet_out) for a, b in zip(srow, frow))
    return {
        "engine": engine, "device": str(device), "max_inflight": max_inflight,
        "sims": sims, "rounds": rounds, "k_boxes": len(REPLAY_BOXES),
        "grid": "16^3", "queries": sims * rounds * 2, "identical": identical,
        "sequential_s": seq_s, "fleet_s": fleet_s,
        "speedup": seq_s / fleet_s if fleet_s else None,
        "fleet_launches": fleet_launches, "sequential_launches": seq_launches,
        "broker": stats.as_dict(),
    }


def eval_section(runs: int, num_jobs: int, seed0: int, engine: str, device,
                 inflight, want, quorum="auto", timeout="auto") -> Dict:
    """The parity matrix per task on numpy and on ``engine``, and as
    fleets on ``engine`` at each lane count in ``inflight``, run in turns
    (each path, then each again in reverse order) so that a drift of the
    host's speed over the run shows; records checked against ``want``."""
    from repro_torch.core.engineconfig import EngineConfig
    from repro_torch.eval import EvalRunner, make_tasks
    from repro_torch.kernels.fitmask import kernel

    tasks = make_tasks(EVAL_CONFIGS, runs=runs, num_jobs=num_jobs,
                       load=1.5, seed0=seed0)
    paths = [("numpy per task", EngineConfig("numpy", fleet_size=0)),
             (f"{engine} per task", EngineConfig(engine, device=device,
                                                 fleet_size=0))]
    paths += [(f"{engine} fleet, max_inflight {lanes}",
               EngineConfig(engine, device=device, max_inflight=lanes,
                            quorum=quorum, timeout=timeout))
              for lanes in inflight]
    out = {name: {"wall_s": [], "identical": True} for name, _ in paths}
    for name, cfg in paths + paths[::-1]:
        runner = EvalRunner(workers=0, engine=cfg)
        kernel.reset_launch_counts()
        sync(device)
        t0 = time.perf_counter()
        records = runner.run(tasks)
        sync(device)
        row = out[name]
        row["wall_s"].append(time.perf_counter() - t0)
        row["identical"] = row["identical"] and same_figures(records, want)
        row["launches"] = kernel.launch_counts()
        row["fleet"] = runner.last_stats.get("fleet")
    return out


def profile_section(label: str, num_jobs: int, seed0: int, engine: str,
                    device, top: int = 15) -> Dict:
    """cProfile of one per-task run of ``label`` on ``engine`` and on
    numpy, each after an untimed run: the ``top`` host functions by own
    time."""
    import cProfile
    import pstats

    from repro_torch.core.engineconfig import EngineConfig
    from repro_torch.eval import make_tasks, run_task

    (task,) = make_tasks([c for c in EVAL_CONFIGS if c[0] == label],
                         runs=1, num_jobs=num_jobs, load=1.5, seed0=seed0)
    out = {"config": label, "num_jobs": num_jobs}
    for name in (engine, "numpy"):
        cfg = EngineConfig(name, device=device)
        run_task(task, engine=cfg)                       # warm
        prof = cProfile.Profile()
        sync(device)
        t0 = time.perf_counter()
        prof.enable()
        run_task(task, engine=cfg)
        sync(device)
        prof.disable()
        wall = time.perf_counter() - t0
        st = pstats.Stats(prof)
        rows = sorted(st.stats.items(), key=lambda kv: -kv[1][2])[:top]
        out[name] = {"wall_s": wall, "total_tt_s": st.total_tt, "top": [
            {"function": f"{os.path.basename(f)}:{line}({fn})",
             "ncalls": nc, "tottime_s": tt, "cumtime_s": ct}
            for (f, line, fn), (_cc, nc, tt, ct, _callers) in rows]}
    return out


def canary_section(seed0: int, engine: str, device, flushes: int = 6) -> Dict:
    """Two injected faults fail ``engine`` over to the next engine of the
    chain on the same device; the first post-failover flushes are
    checked against the host numpy oracle."""
    from repro_torch.core.engineconfig import EngineConfig
    from repro_torch.sim.fleet import QueryBroker

    broker = QueryBroker(EngineConfig(engine, device=device),
                         failover=True)
    broker.inject_engine_faults(2)
    rng = np.random.default_rng(seed0)
    boxes = ((2, 2, 2), (4, 2, 1), (3, 3, 1))
    for _ in range(flushes):
        broker.multibox(rng.random((2, 16, 16, 16)) < 0.35, boxes)
    st = broker.stats
    return {
        "start_engine": engine, "adopted_engine": broker.engine_name,
        "device": str(broker.device), "flushes": flushes,
        "engine_failovers": st.engine_failovers,
        "canary_checks": st.canary_checks,
        "canary_mismatches": st.canary_mismatches,
        "pass": bool(st.engine_failovers >= 1 and st.canary_checks >= 1
                     and st.canary_mismatches == 0),
    }


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join(
        "experiments", "fleet_bench_torch.json"))
    ap.add_argument("--seed0", type=int, default=100)
    ap.add_argument("--quick", action="store_true",
                    help="smaller matrix and replay")
    ap.add_argument("--engine", default="cuda",
                    help="engine of the replay and the canary drill")
    ap.add_argument("--device", default=None,
                    help="torch device of that engine (default: the card)")
    ap.add_argument("--inflight", type=int, nargs="+", default=[1, 2],
                    help="broker lanes to replay and run the eval at")
    ap.add_argument("--quorum", default="auto",
                    help="broker quorum for the replay and the eval "
                         "(a fraction; 0 is drain mode)")
    ap.add_argument("--timeout", default="auto",
                    help="broker deadline in seconds ('none': no deadline)")
    ap.add_argument("--profile", action="store_true",
                    help="cProfile one per-task run on the engine and on "
                         "numpy")
    args = ap.parse_args(argv)
    quorum = args.quorum if args.quorum == "auto" else float(args.quorum)
    timeout = {"auto": "auto", "none": None}.get(args.timeout, args.timeout)
    timeout = timeout if timeout in ("auto", None) else float(timeout)
    if args.out and os.path.basename(args.out).startswith("BENCH_"):
        ap.error("the committed BENCH_*.json snapshots are the reference "
                 "package's; write the port's JSON elsewhere")

    sys.path.insert(0, str(ROOT / "src"))
    import torch
    on_card = args.engine != "numpy" and torch.device(
        args.device or "cuda").type == "cuda"
    card = None
    if on_card:
        if not torch.cuda.is_available():
            print("fleet_bench: no CUDA device", file=sys.stderr)
            raise SystemExit(1)
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", "0"],
            capture_output=True, text=True, check=True).stdout.strip()
        print(card)

    runs, num_jobs = (2, 60) if args.quick else (3, 200)
    sims, rounds = (6, 80) if args.quick else (8, 120)
    print(f"# fleet bench: parity {runs}x{num_jobs}x{len(EVAL_CONFIGS)} "
          f"(numpy), replay {sims} sims x {rounds} rounds ({args.engine}, "
          f"lanes {args.inflight}, quorum {quorum}, timeout {timeout})")
    par, want = parity_section(runs, num_jobs, args.seed0)
    print(f"# parity: identical={par['identical']} untimed first pass "
          f"{par['warm_up_s']}s, then in turns seq="
          f"{par['sequential_walls_s']}s fleet={par['fleet_walls_s']}s "
          f"(numpy, {par['numpy_speedup']}x on the means)")
    replays = []
    for lanes in args.inflight:
        eng = engine_section(sims, rounds, args.seed0, args.engine,
                             args.device, lanes, quorum, timeout)
        replays.append(eng)
        b = eng["broker"]
        print(f"# replay, max_inflight {lanes}: identical={eng['identical']}"
              f" seq={eng['sequential_s']}s fleet={eng['fleet_s']}s -> "
              f"{eng['speedup']}x; flushes {b['flushes']} (all parked "
              f"{b['flush_all_parked']}, quorum {b['flush_quorum']}, timeout"
              f" {b['flush_timeout']}), mean_grids_per_call "
              f"{b['mean_grids_per_call']}, fc_cache_hits "
              f"{b['fc_cache_hits']}, launches fleet {eng['fleet_launches']}"
              f" / batch-1 {eng['sequential_launches']}")
    ev = None
    if args.engine != "numpy":
        ev = eval_section(runs, num_jobs, args.seed0, args.engine,
                          args.device, args.inflight, want, quorum, timeout)
        for name, row in ev.items():
            line = (f"# eval, {name}: walls {row['wall_s']} s in turns "
                    f"(identical={row['identical']})")
            if row["fleet"]:
                b = row["fleet"]["broker"]
                line += (f"; flushes {b['flushes']} (all parked "
                         f"{b['flush_all_parked']}, quorum "
                         f"{b['flush_quorum']}, timeout "
                         f"{b['flush_timeout']}), mean_grids_per_call "
                         f"{b['mean_grids_per_call']}, park_s {b['park_s']},"
                         f" engine_s {b['engine_s']}")
            print(line + f"; launches {row['launches']}")
    prof = None
    if args.profile:
        prof = profile_section(PROFILE_CONFIG, num_jobs, args.seed0,
                               args.engine, args.device)
        for name in (args.engine, "numpy"):
            p = prof[name]
            print(f"# profile {PROFILE_CONFIG} on {name}: wall "
                  f"{p['wall_s']}s under cProfile, own time "
                  f"{p['total_tt_s']}s")
            for row in p["top"]:
                print(f"profile,{name},{row['tottime_s']},"
                      f"{row['cumtime_s']},{row['ncalls']},"
                      f"{row['function']}")
    from repro_torch.core.engineconfig import failover_candidates
    can = None
    if failover_candidates(args.engine):
        can = canary_section(args.seed0, args.engine, args.device)
        print(f"# canary: {can['start_engine']} -> {can['adopted_engine']} "
              f"on {can['device']} after {can['engine_failovers']} "
              f"failover(s), {can['canary_checks']} checks "
              f"{can['canary_mismatches']} mismatches (pass={can['pass']})")
    else:
        print(f"# canary: skipped ({args.engine} is the failover chain's "
              "floor)")

    pass_numpy = bool(par["identical"] and par["numpy_speedup"]
                      and par["numpy_speedup"] >= NUMPY_FLOOR)
    pass_engine = {
        e["max_inflight"]: bool(
            e["identical"] and e["speedup"] and e["speedup"] >= ENGINE_FLOOR
            and e["broker"]["batched_calls"] > 0
            and e["broker"]["mean_grids_per_call"] > 1)
        for e in replays}
    results = {
        "config": {"quick": args.quick, "seed0": args.seed0,
                   "engine": args.engine, "device": args.device,
                   "quorum": quorum, "timeout": timeout, "card": card},
        "parity": par, "engine": replays, "eval": ev, "profile": prof,
        "canary": can,
        "headline": {
            "numpy_speedup": par["numpy_speedup"],
            "engine_speedup": {e["max_inflight"]: e["speedup"]
                               for e in replays},
            "pass_numpy": pass_numpy, "pass_engine": pass_engine,
            "pass_canary": can and can["pass"],
            "pass": (pass_numpy and all(pass_engine.values())
                     and (can is None or can["pass"])),
        },
    }
    print("# headline: " + json.dumps(results["headline"]))
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1, default=str)
        print(f"# wrote {args.out}")
    wrong = [name for name, ok in (
        ("parity", par["identical"]),
        ("canary", can is None or can["canary_mismatches"] == 0),
        *((f"replay lanes {e['max_inflight']}", e["identical"])
          for e in replays),
        *((f"eval, {name}", row["identical"])
          for name, row in (ev or {}).items())) if not ok]
    if wrong:
        raise SystemExit(f"fleet_bench: answers differ in {wrong}")
    return results


if __name__ == "__main__":
    main()
