#!/usr/bin/env python3
"""Partition/failover drill on the port: kill -9 the primary, promote the
warm standby, lose nothing.

The drill of ``benchmarks/failover_drill.py`` on ``repro_torch``'s
daemon. Three sections, one JSON result:

* **failover** — the acceptance scenario. The same deterministic
  ``node_churn`` op stream as ``crash_loop.py`` is replayed twice:
  once against an uninterrupted in-process daemon (the control
  oracle), and once against a *replicated pair* — the primary runs as
  a real subprocess (sync ack mode: every op is standby-durable
  before its ack) and a warm standby tails its journal over the wire.
  Mid-stream, right after a submit's ack, the primary is SIGKILLed,
  the standby is promoted (minting fencing epoch 2), the killed op's
  request_id is **resent** (the replicated dedup cache must absorb
  it), and the stream finishes against the new leader. Pass: the
  final state digest is byte-identical to the control, the resend
  moved nothing, and zero acked ops were missing from the standby at
  promotion. RTO (SIGKILL → resent op acked by the new leader) and
  the replication lag at the kill are the headline latencies.

* **resurrection** — the split-brain case. The dead primary is
  restarted from its own checkpoint store (it recovers to its
  pre-kill state, epoch 1, believing it leads). A client that has
  witnessed epoch 2 stamps it on its requests: the stale primary must
  fence itself and refuse (journal side), and a failover client must
  discard/redirect and land the op on the real leader exactly once
  (client side). Pass: **zero** fenced writes reach the stale
  journal.

* **ack_overhead** — sync vs async ack modes on a live pair: p50/p99
  submit latency, plus the fraction of sync acks that were actually
  standby-durable (must be 1.0 with a healthy follower).

Every daemon, the subprocess primary included, places on ``cuda`` on
the card unless ``--engine``/``--device`` ask for another
(``--engine numpy``: the host); the primary's script gets the drill's
engine and device on its command line. The JSON goes to
``--out`` (default ``''``: none), never to the committed BENCH_*.json
snapshots. Exits 1 unless every check passes.

    python3 benchmarks_torch/failover_drill.py [--num-jobs 60] [--quick]
        [--engine cuda] [--device cuda] [--out PATH]
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Tuple

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmarks_torch.crash_loop import (POLICY_KW,  # noqa: E402
                                         add_engine_args, build_op_stream,
                                         engine_from_args)

REPL_KW = dict(checkpoint_every=7, repl_poll=0.1,
               ack_mode="sync", sync_timeout=2.0)

# argv: checkpoint dir, engine ('' = the registry's), device ('' = the
# card).
_PRIMARY = """\
import sys, time
from repro_torch.api import EngineConfig, Scheduler, SchedulerConfig
engine = EngineConfig(sys.argv[2] or None, device=sys.argv[3] or None)
cfg = SchedulerConfig(policy="rfold",
                      policy_kw=dict(num_xpus=512, cube_n=4),
                      engine=engine,
                      checkpoint_dir=sys.argv[1], checkpoint_every=7,
                      repl_poll=0.1, ack_mode="sync", sync_timeout=2.0)
s = Scheduler(cfg).start()
print("ADDR", s.address[0], s.address[1], flush=True)
while True:
    time.sleep(1)
"""


def _scheduler(engine, **kw):
    """A started daemon of the drill: RFold on 512 XPUs in 4^3 cubes on
    ``engine``."""
    from repro_torch.serve.scheduler import Scheduler, SchedulerConfig

    return Scheduler(SchedulerConfig(policy="rfold",
                                     policy_kw=dict(POLICY_KW),
                                     engine=engine, **kw)).start()


def _spawn_primary(engine, ckpt_dir: str, script_dir: str):
    """The primary as a real OS process, so the kill is a genuine
    ``kill -9`` — no in-process shortcuts. It imports this checkout's
    ``repro_torch`` and places on the drill's engine and device."""
    import repro_torch

    script = os.path.join(script_dir, "primary.py")
    with open(script, "w") as f:
        f.write(_PRIMARY)
    src = os.path.dirname(list(repro_torch.__path__)[0])
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (src, env.get("PYTHONPATH")) if p)
    proc = subprocess.Popen(
        [sys.executable, script, ckpt_dir, engine.engine or "",
         "" if engine.device is None else str(engine.device)],
        stdout=subprocess.PIPE, text=True, env=env)
    for line in proc.stdout:
        if line.startswith("ADDR"):
            _, host, port = line.split()
            return proc, (host, int(port))
    proc.wait(timeout=30)
    proc.stdout.close()
    raise RuntimeError("primary subprocess never printed its address "
                       f"(exit {proc.returncode})")


def _drive(client, i: int, msg: Dict) -> Dict:
    """One stream op under its stable request_id ``drill:<i>`` — the
    id a resend must reuse for the retry to be idempotent."""
    fields = {k: v for k, v in msg.items() if k != "op"}
    return client._request(msg["op"], request_id=f"drill:{i}", **fields)


def _run_control(engine, ops: List[Dict], ckpt_dir: str) -> Dict:
    from repro_torch.serve.scheduler import SchedulerClient

    sched = _scheduler(engine, checkpoint_dir=ckpt_dir, checkpoint_every=7)
    client = SchedulerClient(sched.address, client_id="drill")
    try:
        for i, msg in enumerate(ops):
            _drive(client, i, msg)
        st = client.status()
        return {"digest": st["state_digest"],
                "journal_ops": st["journal_ops"],
                "data_ops": (st["journal_ops"]
                             - st["resilience"]["promotions"])}
    finally:
        client.close()
        sched.stop()


def _await_follower(client, deadline: float = 15.0):
    t0 = time.monotonic()
    while time.monotonic() - t0 < deadline:
        if client.status()["repl"]["follower_live"]:
            return
        time.sleep(0.05)
    raise RuntimeError("standby never pulled from the primary")


def run_failover(engine, ops: List[Dict],
                 tmp: str) -> Tuple[Dict, object]:
    """The kill -9 → promote → resend → digest-identical scenario.

    Returns the result dict plus the promoted standby, still live —
    the resurrection section needs it as the rightful leader."""
    from repro_torch.serve.scheduler import SchedulerClient

    pri_ckpt = os.path.join(tmp, "primary")
    proc, pri_addr = _spawn_primary(engine, pri_ckpt, tmp)
    standby = client = None
    try:
        standby = _scheduler(
            engine,
            checkpoint_dir=os.path.join(tmp, "standby"),
            role="standby", replicate_from=pri_addr, **REPL_KW)
        client = SchedulerClient([pri_addr, standby.address],
                                 client_id="drill", op_timeout=20.0,
                                 max_retries=8, backoff=0.05)
        submit_idx = [i for i, m in enumerate(ops) if m["op"] == "submit"]
        kill_at = submit_idx[int(len(submit_idx) * 0.6)]
        acked = 0
        sync_acked = 0
        _await_follower(client)
        rto_ms = lag_at_kill = acked_ops_lost = None
        resend_clean = resend_dedup = False
        for i, msg in enumerate(ops):
            r = _drive(client, i, msg)
            acked += 1
            sync_acked += bool(r.get("replicated"))
            if i == kill_at:
                pri_ops = client.status()["journal_ops"]
                lag_at_kill = standby.status()["repl"]["lag"]
                t_kill = time.perf_counter()
                os.kill(proc.pid, signal.SIGKILL)
                proc.wait(timeout=30)
                promoted = standby.promote()
                if promoted["epoch"] != 2:
                    raise RuntimeError(f"promotion minted {promoted}")
                # The standby must already hold every acked op — sync
                # acks made them standby-durable before the client
                # ever saw them.
                acked_ops_lost = max(
                    0, pri_ops - standby.status()["resilience"]
                    ["repl_applied"])
                # Resend the killed op's rid: the client that never
                # saw its ack retries against the new leader, which
                # answers from the replicated dedup cache.
                before = client.status()
                r2 = _drive(client, i, msg)
                rto_ms = (time.perf_counter() - t_kill) * 1e3
                after = client.status()
                resend_clean = (before["state_digest"]
                                == after["state_digest"]
                                and r2.get("job_id") == r.get("job_id"))
                resend_dedup = (after["resilience"]["dedup_hits"]
                                > before["resilience"]["dedup_hits"])
        st = client.status()
        return ({
            "digest": st["state_digest"],
            "journal_ops": st["journal_ops"],
            "data_ops": (st["journal_ops"]
                         - st["resilience"]["promotions"]),
            "epoch": st["epoch"],
            "kill_at_op": kill_at,
            "ops_acked": acked,
            "sync_acked_frac": sync_acked / max(1, acked),
            "rto_ms": rto_ms,
            "repl_lag_at_kill": lag_at_kill,
            "acked_ops_lost": acked_ops_lost,
            "resend_clean": resend_clean,
            "resend_dedup": resend_dedup,
            "client_redirects": client.redirects,
            "client_retries": client.retries,
        }, standby)
    except BaseException:
        if standby is not None:
            standby.kill()
        raise
    finally:
        if client is not None:
            client.close()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        proc.stdout.close()


def run_resurrection(engine, tmp: str, new_leader,
                     epoch: int) -> Dict:
    """Restart the dead primary from its own store: it recovers to
    its pre-kill state believing it still leads — and must land zero
    writes once fenced."""
    from repro_torch.serve.scheduler import SchedulerClient

    stale = _scheduler(engine, checkpoint_dir=os.path.join(tmp, "primary"),
                       checkpoint_every=7)
    try:
        at_boot = stale.status()
        # Journal side: a request stamped with the new epoch makes
        # the stale primary fence itself and refuse.
        c1 = SchedulerClient(stale.address, client_id="stale-probe",
                             max_retries=1, backoff=0.01)
        c1.epoch_seen = epoch
        journal_refused = False
        try:
            c1._request("submit", shape=[2, 2, 2])
        except (ConnectionError, TimeoutError):
            journal_refused = True
        c1.close()
        # Client side: a failover client that witnessed the new epoch
        # rejects the stale leader and lands the op on the real one —
        # exactly once.
        leader_ops = new_leader.status()["journal_ops"]
        c2 = SchedulerClient([stale.address, new_leader.address],
                             client_id="resurrect", backoff=0.02,
                             max_retries=6)
        c2.epoch_seen = epoch
        landed = c2._request("submit", request_id="resurrect:1",
                             shape=[2, 2, 2])
        redirected = c2.redirects + c2.stale_rejections
        c2.close()
        st = stale.status()
        return {
            "journal_ops_at_boot": at_boot["journal_ops"],
            "recovered_digest": at_boot["state_digest"],
            "journal_refused": journal_refused,
            "fenced": st["fenced"],
            "fenced_rejections": st["repl"]["fenced_rejections"],
            "fenced_writes_landed": (st["journal_ops"]
                                     - at_boot["journal_ops"]),
            "landed_on_leader": bool(landed.get("ok"))
            and landed.get("epoch") == epoch
            and new_leader.status()["journal_ops"] == leader_ops + 1,
            "client_rejections": redirected,
        }
    finally:
        stale.stop()


def run_ack_overhead(engine, n: int, tmp: str) -> Dict:
    """p50/p99 submit latency, async vs sync ack mode, live pair."""
    from repro_torch.serve.scheduler import SchedulerClient

    out: Dict[str, Dict] = {}
    for mode in ("async", "sync"):
        kw = dict(REPL_KW, ack_mode=mode)
        pri = _scheduler(
            engine, checkpoint_dir=os.path.join(tmp, f"ack-{mode}-p"), **kw)
        sby = _scheduler(
            engine, checkpoint_dir=os.path.join(tmp, f"ack-{mode}-s"),
            role="standby", replicate_from=pri.address, **kw)
        client = SchedulerClient(pri.address, client_id=f"ack-{mode}")
        try:
            _await_follower(client)
            lat: List[float] = []
            replicated = 0
            for i in range(n):
                t0 = time.perf_counter()
                r = client.submit((2, 2, 2), job_id=i)
                lat.append((time.perf_counter() - t0) * 1e3)
                replicated += bool(r.get("replicated"))
                client.done(i)
            lat.sort()
            out[mode] = {
                "n": n,
                "p50_ms": statistics.median(lat),
                "p99_ms": lat[min(len(lat) - 1, int(len(lat) * 0.99))],
                "replicated_frac": replicated / n,
            }
        finally:
            client.close()
            sby.stop()
            pri.stop()
    out["overhead_p50_ms"] = out["sync"]["p50_ms"] - out["async"]["p50_ms"]
    return out


def run_drill(num_jobs: int, seed: int, ack_n: int, engine=None) -> Dict:
    from repro_torch.core.engineconfig import EngineConfig

    engine = EngineConfig.coerce(engine)
    ops = build_op_stream(num_jobs, seed)
    tmp = tempfile.mkdtemp(prefix="failover_drill_")
    standby = None
    try:
        t0 = time.perf_counter()
        control = _run_control(engine, ops, os.path.join(tmp, "control"))
        failover, standby = run_failover(engine, ops, tmp)
        resurrection = run_resurrection(engine, tmp, standby,
                                        failover["epoch"])
        standby.stop()
        standby = None
        ack = run_ack_overhead(engine, ack_n, tmp)
        wall = time.perf_counter() - t0
    finally:
        if standby is not None:
            standby.kill()
        shutil.rmtree(tmp, ignore_errors=True)

    digest_identical = (control["digest"] == failover["digest"]
                        and control["data_ops"] == failover["data_ops"])
    headline = {
        "ops": len(ops),
        "digest_identical": digest_identical,
        "acked_ops_lost": failover["acked_ops_lost"],
        "resend_exactly_once": (failover["resend_clean"]
                                and failover["resend_dedup"]),
        "fenced_writes_landed": resurrection["fenced_writes_landed"],
        "fenced_client_and_journal": (resurrection["journal_refused"]
                                      and resurrection["fenced"]
                                      and resurrection[
                                          "landed_on_leader"]),
        "rto_ms": failover["rto_ms"],
        "repl_lag_at_kill": failover["repl_lag_at_kill"],
        "sync_overhead_p50_ms": ack["overhead_p50_ms"],
        "sync_replicated_frac": ack["sync"]["replicated_frac"],
    }
    headline["pass"] = bool(
        digest_identical
        and failover["acked_ops_lost"] == 0
        and headline["resend_exactly_once"]
        and resurrection["fenced_writes_landed"] == 0
        and headline["fenced_client_and_journal"]
        and ack["sync"]["replicated_frac"] == 1.0)
    return {"num_jobs": num_jobs, "seed": seed,
            "control": control, "failover": failover,
            "resurrection": resurrection, "ack_overhead": ack,
            "wall_s": wall, "headline": headline,
            "pass": headline["pass"]}


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(prog="failover_drill")
    ap.add_argument("--num-jobs", type=int, default=60)
    ap.add_argument("--seed", type=int, default=17)
    ap.add_argument("--ack-n", type=int, default=40)
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
        args.ack_n = min(args.ack_n, 20)

    res = run_drill(args.num_jobs, args.seed, args.ack_n, engine)
    res.update(engine=engine.resolve_name(), device=args.device, card=card)
    h = res["headline"]
    print(f"# failover drill: {h['ops']} ops on {res['engine']}, SIGKILL "
          f"at op {res['failover']['kill_at_op']}")
    print(f"  control  digest {res['control']['digest']} "
          f"({res['control']['data_ops']} data ops)")
    print(f"  failover digest {res['failover']['digest']} "
          f"({res['failover']['data_ops']} data ops, epoch "
          f"{res['failover']['epoch']})")
    print(f"  RTO {h['rto_ms']} ms, repl lag at kill "
          f"{h['repl_lag_at_kill']} ops, acked lost "
          f"{h['acked_ops_lost']}")
    print(f"  resurrection: fenced_writes_landed="
          f"{h['fenced_writes_landed']} "
          f"(journal+client fencing: "
          f"{h['fenced_client_and_journal']})")
    print(f"  ack overhead: sync p50 "
          f"{res['ack_overhead']['sync']['p50_ms']} ms vs async p50 "
          f"{res['ack_overhead']['async']['p50_ms']} ms "
          f"(+{h['sync_overhead_p50_ms']} ms, replicated "
          f"{h['sync_replicated_frac']:.0%})")
    print(f"# digest_identical={h['digest_identical']} "
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
