#!/usr/bin/env python3
"""Crash-loop drill on the port: the daemon dies 5 times mid-stream, the
state doesn't.

The drill of ``benchmarks/crash_loop.py`` on ``repro_torch``'s daemon.
A deterministic op stream is derived from the ``node_churn`` chaos
scenario — the trace's submits, a retire-every-3rd ``done`` rule, and
the scenario's seeded fault/repair schedule, merged in time order —
and replayed against the allocator daemon twice:

* **Control run**: uninterrupted; the final ``state_digest`` is the
  oracle.
* **Crash run**: at 5 seeded points the daemon is ``kill``-ed (no
  final checkpoint — recovery is snapshot + WAL tail replay), a fresh
  daemon recovers on the same checkpoint dir, and the op that was in
  flight at the kill is **resent with its original request_id** — the
  journal-persisted dedup cache must absorb the retry (the state
  digest must not move), exactly what a reconnecting client does.

Pass criterion: the crash run's final digest and journal length are
byte-identical to the control run's, every resend was a no-op, and at
least one resend was answered from the dedup cache. At the default
512 XPUs the stream, the digests and the journal are the reference
drill's; ``--num-xpus 4096`` runs it at the paper's cluster size.

The daemon places on ``cuda`` on the card unless ``--engine``/
``--device`` ask for another (``--engine numpy``: the host); without a
card the default raises. The JSON goes to ``--out`` (default ``''``:
none), never to the committed BENCH_*.json snapshots.

    python3 benchmarks_torch/crash_loop.py [--kills 5] [--quick]
        [--num-xpus 512] [--engine cuda] [--device cuda] [--out PATH]
"""
from __future__ import annotations

import argparse
import json
import math
import os
import random
import shutil
import sys
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

ROOT = Path(__file__).resolve().parents[1]

POLICY_KW = dict(num_xpus=512, cube_n=4)


def policy_kw_for(num_xpus: int) -> dict:
    return dict(POLICY_KW, num_xpus=num_xpus)


def build_op_stream(num_jobs: int, seed: int,
                    scenario: str = "node_churn", policy: str = "rfold",
                    policy_kw: Optional[dict] = None) -> List[Dict]:
    """The deterministic op list both runs replay: submits at arrival,
    a ``done`` for the oldest-submitted job after every 3rd submit
    (already-finished/dropped targets answer a stateless error —
    deterministic either way), and the scenario's fault/repair events
    at their scheduled times, drawn against ``policy``'s model (the
    reference's: RFold on 512 XPUs in 4^3 cubes)."""
    from repro_torch.core.allocator import make_policy
    from repro_torch.sim.scenarios import SCENARIOS, fault_schedule
    from repro_torch.traces.generator import TraceConfig, generate_trace

    policy_kw = dict(POLICY_KW if policy_kw is None else policy_kw)
    num_xpus = int(policy_kw.get("num_xpus")
                   or math.prod(policy_kw["dims"]))
    sc = SCENARIOS[scenario]
    cfg = TraceConfig(num_jobs=num_jobs, seed=seed, cluster_xpus=num_xpus,
                      size_max=num_xpus, **sc.trace_kw)
    jobs = generate_trace(cfg)
    # Geometry only: the schedule places nothing, so the host engine.
    pol = make_policy(policy, engine="numpy", **policy_kw)
    model = getattr(pol, "torus", None) or pol.cluster
    faults = fault_schedule(sc, model, jobs, seed)

    timeline: List[Tuple[float, int, Dict]] = []
    fifo: List[int] = []
    for n, job in enumerate(jobs, start=1):
        timeline.append((job.arrival, len(timeline),
                         {"op": "submit", "job_id": job.job_id,
                          "shape": list(job.shape.dims)}))
        fifo.append(job.job_id)
        if n % 3 == 0:
            timeline.append((job.arrival, len(timeline),
                             {"op": "done", "job_id": fifo.pop(0)}))
    for ev in faults:
        timeline.append((ev.time, len(timeline),
                         {"op": ev.action, "kind": ev.kind,
                          "targets": [list(t) if isinstance(t, tuple)
                                      else t for t in ev.targets]}))
    timeline.sort(key=lambda e: (e[0], e[1]))
    return [msg for _, _, msg in timeline]


class RawClient:
    """Fixed-identity wire client: op ``i`` always goes out as
    ``request_id <cid>:<i>`` — across daemon restarts too — so a
    resend after a crash is the genuine idempotent-retry path."""

    def __init__(self, address, cid: str = "crash"):
        from repro_torch.serve.scheduler import SchedulerClient

        self._c = SchedulerClient(address, client_id=cid, max_retries=0)
        self._cid = cid

    def send(self, i: int, msg: Dict) -> Dict:
        from repro_torch.serve.scheduler import protocol

        wire = dict(msg, seq=i, client=self._cid,
                    request_id=f"{self._cid}:{i}")
        self._c._sock.sendall(protocol.encode(wire))
        return self._c._await_reply(i, 60.0)

    def close(self) -> None:
        self._c.close()


def _run_stream(ops: List[Dict], ckpt_dir: str,
                kill_at: Optional[List[int]] = None, engine=None,
                policy_kw: Optional[dict] = None) -> Dict:
    """Replay ``ops`` against a daemon on ``ckpt_dir``; with
    ``kill_at``, crash + recover + resend-at-same-rid at those op
    indices. Returns the final digest/journal plus drill stats."""
    from repro_torch.serve.scheduler import Scheduler, SchedulerConfig

    cfg = SchedulerConfig(policy="rfold",
                          policy_kw=dict(policy_kw or POLICY_KW),
                          engine=engine, checkpoint_dir=ckpt_dir,
                          checkpoint_every=7)
    kill_at = sorted(kill_at or [])
    sched = Scheduler(cfg).start()
    client = RawClient(sched.address)
    resends_clean = True
    try:
        for i, msg in enumerate(ops):
            client.send(i, msg)
            if kill_at and i == kill_at[0]:
                kill_at.pop(0)
                client.close()
                sched.kill()  # crash: no final checkpoint
                sched = Scheduler(cfg).start()
                client = RawClient(sched.address)
                # The retry a real client would issue after losing the
                # ack: same request_id. Journaled ops must dedup;
                # either way the state digest must not move.
                before = client.send(10_000_000 + i, {"op": "status"})
                client.send(i, msg)
                after = client.send(20_000_000 + i, {"op": "status"})
                resends_clean &= (before["state_digest"]
                                  == after["state_digest"])
        st = client.send(len(ops), {"op": "status"})
        return {"digest": st["state_digest"],
                "journal_ops": st["journal_ops"],
                "resilience": st["resilience"],
                "resends_clean": resends_clean}
    finally:
        client.close()
        sched.stop()


def run_drill(num_jobs: int, seed: int, kills: int, engine=None,
              num_xpus: int = 512) -> Dict:
    policy_kw = policy_kw_for(num_xpus)
    ops = build_op_stream(num_jobs, seed, policy_kw=policy_kw)
    # Kill only right after submits: submits journal (unless rejected),
    # so the resent op exercises the dedup cache, not just statelessness.
    submit_idx = [i for i, m in enumerate(ops) if m["op"] == "submit"]
    kill_at = sorted(random.Random(seed).sample(
        submit_idx[1:], min(kills, max(0, len(submit_idx) - 1))))

    tmp = tempfile.mkdtemp(prefix="crash_loop_")
    try:
        t0 = time.perf_counter()
        control = _run_stream(ops, tmp + "/control", engine=engine,
                              policy_kw=policy_kw)
        crash = _run_stream(ops, tmp + "/crash", kill_at=kill_at,
                            engine=engine, policy_kw=policy_kw)
        wall = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    identical = (control["digest"] == crash["digest"]
                 and control["journal_ops"] == crash["journal_ops"])
    return {
        "ops": len(ops), "num_jobs": num_jobs, "seed": seed,
        "num_xpus": num_xpus, "kills": kill_at,
        "control": control, "crash": crash,
        "identical": identical,
        "wall_s": wall,
        "pass": (identical and crash["resends_clean"]
                 and crash["resilience"]["dedup_hits"] >= 1),
    }


def engine_from_args(ap: argparse.ArgumentParser, args):
    """The service benchmarks' shared ``--engine``/``--device``
    handling: puts ``src`` on the path, refuses a committed BENCH_*.json
    output, and returns ``(EngineConfig, card)`` — ``card`` is
    nvidia-smi's name and power limit when the engine runs on the card,
    else None."""
    if getattr(args, "out", "") and \
            os.path.basename(args.out).startswith("BENCH_"):
        ap.error("the committed BENCH_*.json snapshots are the reference "
                 "package's; write the port's JSON elsewhere")
    for p in (str(ROOT), str(ROOT / "src")):
        if p not in sys.path:
            sys.path.insert(0, p)
    import subprocess

    import torch

    from repro_torch.core.engineconfig import EngineConfig

    engine = EngineConfig(args.engine, device=args.device)
    if engine.resolve_name() == "numpy" or torch.device(
            args.device or "cuda").type != "cuda":
        return engine, None
    if not torch.cuda.is_available():
        print(f"{ap.prog}: no CUDA device", file=sys.stderr)
        raise SystemExit(1)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    return engine, card


def add_engine_args(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--engine", type=str, default=None,
                    help="fitmask engine (default: the registry's, cuda)")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device of a tensor engine (default: the "
                         "card)")


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(prog="crash_loop")
    ap.add_argument("--num-jobs", type=int, default=60)
    ap.add_argument("--seed", type=int, default=17)
    ap.add_argument("--kills", type=int, default=5)
    ap.add_argument("--num-xpus", type=int, default=512,
                    help="RFold cluster size in 4^3 cubes (the paper's: "
                         "4096)")
    ap.add_argument("--quick", action="store_true",
                    help="smaller stream for CI smoke")
    add_engine_args(ap)
    ap.add_argument("--out", default="",
                    help="JSON output ('' disables); never a committed "
                         "BENCH_*.json")
    args = ap.parse_args(argv)
    engine, card = engine_from_args(ap, args)
    if args.quick:
        args.num_jobs = min(args.num_jobs, 36)
        args.kills = min(args.kills, 3)

    res = run_drill(args.num_jobs, args.seed, args.kills, engine,
                    args.num_xpus)
    res.update(engine=engine.resolve_name(), device=args.device, card=card)
    print(f"# crash loop: {res['ops']} ops at {args.num_xpus} XPUs on "
          f"{res['engine']}, kills at {res['kills']}")
    print(f"  control digest {res['control']['digest'][:16]}... "
          f"({res['control']['journal_ops']} journal ops)")
    print(f"  crash   digest {res['crash']['digest'][:16]}... "
          f"({res['crash']['journal_ops']} journal ops, "
          f"recovered {res['crash']['resilience']['recovered_ops']} at "
          f"last boot, {res['crash']['resilience']['dedup_hits']} dedup "
          f"hits, wal tail {res['crash']['resilience']['wal_tail_ops']})")
    print(f"# identical={res['identical']} "
          f"resends_clean={res['crash']['resends_clean']} "
          f"pass={res['pass']} ({res['wall_s']} s)")
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
        print(f"# wrote {args.out}")
    if not res["pass"]:
        raise SystemExit(1)
    return res


if __name__ == "__main__":
    main()
