#!/usr/bin/env python3
"""Allocator-service benchmark on the port: parity, placement latency,
admission, resilience.

The sections of ``benchmarks/service_bench.py``, over ``repro_torch``'s
live daemon (``repro_torch.serve.scheduler``):

* **Parity.** A Poisson trace is simulated twice — in-process policy
  vs the daemon driven through :class:`RemotePolicy` over TCP — and
  the per-job schedules must be **byte-identical** on every policy.

* **Latency.** The wall-clock of each ``submit`` RPC while replaying a
  Poisson arrival trace against the daemon at the paper's 4096 XPUs
  (completions retired between arrivals, so the occupancy grid churns
  like a loaded cluster's). The same op stream is replayed against an
  in-process :class:`AllocatorCore` — the identical state machine
  minus the socket and event loop — so the difference isolates what
  the service layer owns: protocol encode/decode, the loop hop, and
  event fan-out. ``overhead_p99_ms <= --threshold-ms`` is reported as
  ``latency_pass``; it is a host-clock number and gates nothing.

* **Admission under overload.** Flood a one-cube cluster (bounded
  queue) with more feasible jobs than it can hold: every overflow
  submit must be REJECTED statelessly, the queue depth must never
  exceed the bound, and the daemon must still answer ``status``.

* **Resilience.** ``crash_loop.py``'s drill: the daemon is killed at
  seeded points mid-churn, recovers from snapshot + WAL tail, absorbs
  the resent in-flight ops through the journal-persisted dedup cache,
  and must land on a final state digest byte-identical to an
  uninterrupted control run.

Every daemon and core places on ``cuda`` on the card unless
``--engine``/``--device`` ask for another (``--engine numpy``: the
host). Prints the card's name and power limit when the engine runs on
the card. Exits 1 when parity, admission or resilience fails (an answer
differs); the JSON goes to ``--out`` (default ``''``: none), never to
the committed BENCH_*.json snapshots.

    python3 benchmarks_torch/service_bench.py [--quick] [--engine cuda]
        [--device cuda] [--threshold-ms 25] [--out PATH]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from heapq import heappop, heappush
from pathlib import Path
from typing import Dict, List

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmarks_torch.crash_loop import (add_engine_args,  # noqa: E402
                                         engine_from_args)

OVERHEAD_THRESHOLD_MS = 25.0
LATENCY_KW = dict(num_xpus=4096, cube_n=4)

PARITY_CONFIGS = [
    ("FirstFit (8^3)", "firstfit", dict(dims=(8, 8, 8))),
    ("Folding (8^3)", "folding", dict(dims=(8, 8, 8))),
    ("Reconfig (4^3)", "reconfig", dict(num_xpus=512, cube_n=4)),
    ("RFold (4^3)", "rfold", dict(num_xpus=512, cube_n=4)),
    ("RFold-BE (4^3)", "rfold_be", dict(num_xpus=512, cube_n=4)),
]


def _job_record(jobs) -> str:
    return json.dumps(
        [[j.job_id, j.start, j.finish, j.dropped, j.slowdown,
          j.placement_meta] for j in jobs],
        sort_keys=True, default=list)


def parity_section(num_jobs: int, seed: int, engine=None) -> Dict:
    """Drive the same trace through the in-process policy and through
    the daemon (simulator-as-client), both on ``engine``; schedules
    and summary metrics must match byte for byte."""
    from repro_torch.api import (Scheduler, SchedulerConfig, Simulator,
                                 TraceConfig, generate_trace, make_policy,
                                 summarize)

    trace_cfg = TraceConfig(num_jobs=num_jobs, cluster_xpus=512,
                            size_max=512, seed=seed)
    rows = []
    for label, policy, kw in PARITY_CONFIGS:
        local = Simulator(make_policy(policy, engine=engine, **kw),
                          generate_trace(trace_cfg)).run()
        t0 = time.perf_counter()
        with Scheduler(SchedulerConfig(policy=policy, policy_kw=kw,
                                       engine=engine)) as s:
            remote = Simulator(s.remote_policy(),
                               generate_trace(trace_cfg)).run()
        remote_s = time.perf_counter() - t0
        identical = (
            _job_record(local.jobs) == _job_record(remote.jobs)
            and json.dumps(summarize(local), sort_keys=True)
            == json.dumps(summarize(remote), sort_keys=True))
        rows.append({"label": label, "identical": identical,
                     "jobs": num_jobs, "remote_s": remote_s})
    return {"configs": rows,
            "identical": all(r["identical"] for r in rows)}


def _replay(jobs, submit, done) -> Dict:
    """Poisson replay: retire completions between arrivals, time every
    submit. ``submit``/``done`` are callables returning reply dicts —
    the daemon client or the in-process core speak the same shape."""
    from repro_torch.serve.scheduler import PLACED

    submit_ms: List[float] = []
    done_ms: List[float] = []
    outcomes: Dict[str, int] = {}
    finishing: List = []  # (finish_time, job_id) min-heap
    duration = {j.job_id: j.duration for j in jobs}
    for job in jobs:
        now = job.arrival
        while finishing and finishing[0][0] <= now:
            _, jid = heappop(finishing)
            t0 = time.perf_counter()
            d = done(jid)
            done_ms.append((time.perf_counter() - t0) * 1e3)
            for st in d["started"]:
                if st["outcome"] == PLACED:
                    heappush(finishing,
                             (now + duration[st["job_id"]],
                              st["job_id"]))
        t0 = time.perf_counter()
        r = submit(job)
        submit_ms.append((time.perf_counter() - t0) * 1e3)
        outcomes[r["outcome"]] = outcomes.get(r["outcome"], 0) + 1
        if r["outcome"] == PLACED:
            heappush(finishing, (now + job.duration, job.job_id))
    arr = np.asarray(submit_ms)
    return {
        "outcomes": outcomes,
        "submit_p50_ms": float(np.percentile(arr, 50)),
        "submit_p99_ms": float(np.percentile(arr, 99)),
        "submit_max_ms": float(arr.max()),
        "done_p99_ms": (float(np.percentile(done_ms, 99))
                        if done_ms else None),
        "rpcs": len(submit_ms) + len(done_ms),
    }


def latency_section(num_jobs: int, seed: int, engine=None) -> Dict:
    """The same Poisson op stream against the in-process core and the
    live daemon, both on ``engine``; the difference in p99 is the
    service layer's bill. Outcomes must agree."""
    from repro_torch.api import (Scheduler, SchedulerConfig, TraceConfig,
                                 generate_trace)
    from repro_torch.serve.scheduler import AllocatorCore

    trace_cfg = TraceConfig(num_jobs=num_jobs, seed=seed)
    cfg = SchedulerConfig(policy="rfold", policy_kw=dict(LATENCY_KW),
                          engine=engine)

    def core_replay(core):
        return _replay(
            generate_trace(trace_cfg),
            lambda job: core.apply({"op": "submit", "job_id": job.job_id,
                                    "shape": list(job.shape.dims)})[0],
            lambda jid: core.apply({"op": "done", "job_id": jid})[0])

    # Warm-up pass on a throwaway core: fold enumeration and shape
    # factorization caches are process-global LRUs (and the kernels'
    # first launches build and load them), and whichever side runs
    # first would otherwise pay every miss for both.
    core_replay(AllocatorCore(cfg))
    local = core_replay(AllocatorCore(cfg))

    with Scheduler(cfg) as sched:
        remote = _replay(
            generate_trace(trace_cfg),
            lambda job: sched.submit(job.shape, job_id=job.job_id),
            sched.done)

    return {
        "jobs": num_jobs,
        "num_xpus": LATENCY_KW["num_xpus"],
        "outcomes": remote["outcomes"],
        "outcomes_equal": remote["outcomes"] == local["outcomes"],
        "local": local,
        "remote": remote,
        "overhead_p50_ms": (remote["submit_p50_ms"]
                            - local["submit_p50_ms"]),
        "overhead_p99_ms": (remote["submit_p99_ms"]
                            - local["submit_p99_ms"]),
    }


def admission_section(flood: int, engine=None) -> Dict:
    """Overload a one-cube cluster with a bounded queue: overflow must
    be rejected statelessly and the daemon must stay responsive."""
    from repro_torch.api import Scheduler, SchedulerConfig
    from repro_torch.serve.scheduler import PLACED, QUEUED, REJECTED

    max_queue = 8
    cfg = SchedulerConfig(policy="rfold",
                          policy_kw=dict(num_xpus=64, cube_n=4),
                          max_queue=max_queue, engine=engine)
    counts = {PLACED: 0, QUEUED: 0, REJECTED: 0}
    depth_ok = True
    with Scheduler(cfg) as sched:
        for _ in range(flood):
            r = sched.submit((4, 4, 4))  # whole-cube: one fits at a time
            counts[r["outcome"]] += 1
            depth_ok &= sched.status()["queue_depth"] <= max_queue
        t0 = time.perf_counter()
        st = sched.status()
        status_ms = (time.perf_counter() - t0) * 1e3
        journal_ops = st["journal_ops"]
    expected_rejects = flood - 1 - max_queue
    return {
        "flood": flood, "max_queue": max_queue, "counts": counts,
        "depth_bounded": depth_ok,
        "rejects_stateless": journal_ops == 1 + max_queue,
        "status_under_load_ms": status_ms,
        "pass": (counts[REJECTED] == expected_rejects and depth_ok
                 and journal_ops == 1 + max_queue),
    }


def resilience_section(num_jobs: int, seed: int, kills: int,
                       engine=None) -> Dict:
    """Crash-loop drill + the recovered daemon's resilience counters
    (dedup hits, WAL tail length, recovered op count)."""
    from benchmarks_torch.crash_loop import run_drill

    drill = run_drill(num_jobs, seed, kills, engine)
    return {
        "ops": drill["ops"], "kills": drill["kills"],
        "identical": drill["identical"],
        "resends_clean": drill["crash"]["resends_clean"],
        "counters": drill["crash"]["resilience"],
        "pass": drill["pass"],
    }


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(prog="service_bench")
    ap.add_argument("--quick", action="store_true",
                    help="CI-sized: 50-job parity, 150-job latency")
    ap.add_argument("--threshold-ms", type=float,
                    default=OVERHEAD_THRESHOLD_MS,
                    help="p99 service overhead vs in-process reported "
                         "as latency_pass")
    add_engine_args(ap)
    ap.add_argument("--out", default="",
                    help="JSON output ('' disables); never a committed "
                         "BENCH_*.json")
    args = ap.parse_args(argv)
    engine, card = engine_from_args(ap, args)

    parity_jobs = 50 if args.quick else 120
    latency_jobs = 150 if args.quick else 500
    flood = 40 if args.quick else 200
    drill_jobs, drill_kills = (36, 3) if args.quick else (60, 5)

    print(f"# service bench on {engine.resolve_name()}: parity "
          f"{parity_jobs} jobs x {len(PARITY_CONFIGS)} policies, latency "
          f"{latency_jobs} jobs at {LATENCY_KW['num_xpus']} XPUs, "
          f"admission flood {flood}, crash drill {drill_jobs} jobs / "
          f"{drill_kills} kills")

    par = parity_section(parity_jobs, seed=3, engine=engine)
    for row in par["configs"]:
        print(f"  parity {row['label']:16s} identical={row['identical']} "
              f"({row['remote_s']} s remote)")

    lat = latency_section(latency_jobs, seed=11, engine=engine)
    print(f"  latency: remote p50 {lat['remote']['submit_p50_ms']} ms "
          f"p99 {lat['remote']['submit_p99_ms']} ms | in-process p50 "
          f"{lat['local']['submit_p50_ms']} ms p99 "
          f"{lat['local']['submit_p99_ms']} ms | service overhead p99 "
          f"{lat['overhead_p99_ms']} ms ({lat['remote']['rpcs']} RPCs)")

    adm = admission_section(flood, engine=engine)
    print(f"  admission: {adm['counts']} depth_bounded="
          f"{adm['depth_bounded']} stateless={adm['rejects_stateless']}")

    res = resilience_section(drill_jobs, 17, drill_kills, engine=engine)
    print(f"  resilience: kills at {res['kills']} identical="
          f"{res['identical']} dedup_hits="
          f"{res['counters']['dedup_hits']} "
          f"wal_tail={res['counters']['wal_tail_ops']}")

    headline = {
        "p99_ms": lat["remote"]["submit_p99_ms"],
        "local_p99_ms": lat["local"]["submit_p99_ms"],
        "overhead_p99_ms": lat["overhead_p99_ms"],
        "threshold_ms": args.threshold_ms,
        "latency_pass": lat["overhead_p99_ms"] <= args.threshold_ms,
        "parity": par["identical"],
        "outcomes_equal": lat["outcomes_equal"],
        "admission": adm["pass"],
        "resilience": res["pass"],
    }
    headline["pass"] = (par["identical"] and lat["outcomes_equal"]
                        and adm["pass"] and res["pass"])
    bench = {"engine": engine.resolve_name(), "device": args.device,
             "card": card, "parity": par, "latency": lat,
             "admission": adm, "resilience": res, "headline": headline}
    print(f"# headline: p99 {headline['p99_ms']} ms, service overhead "
          f"{headline['overhead_p99_ms']} ms (latency_pass="
          f"{headline['latency_pass']} at {headline['threshold_ms']} ms) "
          f"parity={headline['parity']} admission={headline['admission']} "
          f"resilience={headline['resilience']} pass={headline['pass']}")
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(bench, f, indent=1)
        print(f"# wrote {args.out}")
    if not headline["pass"]:
        raise SystemExit(1)
    return bench


if __name__ == "__main__":
    main()
