#!/usr/bin/env python3
"""Markdown tables from the port's artifacts under ``experiments/``: the
dry-run JSONs of ``python -m repro_torch.launch.dryrun``, the roofline
JSON, the paper eval and the port's benches (``*_torch*.json``). The
tables are those of ``benchmarks/report.py``; fed the same JSON, every
table whose input keys the two packages share gives the reference's
text. The defaults never point at the committed BENCH_*.json snapshots
(the reference's records); any path can be passed to a table function.

Where the port's artifacts differ, its tables read the port's keys:
``dryrun_table`` shows the trace's wall (``lower_s``: the port's dry-run
runs eagerly and writes ``compile_s`` 0) under "trace s";
``fitmask_table`` reads ``benchmarks_torch/fitmask_bench.py``'s sweep
(one K1 launch against K launches of K3, device ms); ``fleet_table``
takes ``benchmarks_torch/fleet_bench.py``'s replay per lane count, its
eval section and a skipped canary drill. Host only: reads JSON.

    python3 benchmarks_torch/report.py [--which all]
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
EXP = "experiments"
# Each artifact's default: the port bench's full-size output, then the
# quick one that benchmarks_torch/run.py writes without --full.
DEFAULTS = {
    "dryrun": [os.path.join(EXP, "dryrun_torch")],
    "roofline": [os.path.join(EXP, "roofline_torch.json")],
    "paper": [os.path.join(EXP, "paper_eval_torch.json")],
    "alloc": [os.path.join(EXP, "allocator_bench_torch.json")],
    "eval": [os.path.join(EXP, "paper_eval_torch_bench.json")],
    "fitmask": [os.path.join(EXP, f"fitmask_bench_torch{q}.json")
                for q in ("", "_quick")],
    "reconfig": [os.path.join(EXP, f"reconfig_bench_torch{q}.json")
                 for q in ("", "_quick")],
    "fleet": [os.path.join(EXP, f"fleet_bench_torch{q}.json")
              for q in ("", "_quick")],
    "service": [os.path.join(EXP, f"service_bench_torch{q}.json")
                for q in ("", "_quick")],
    "chaos": [os.path.join(EXP, f"chaos_bench_torch{q}.json")
              for q in ("", "_quick")],
    "crash": [os.path.join(EXP, f"crash_loop_torch{q}.json")
              for q in ("", "_quick")],
    "failover": [os.path.join(EXP, f"failover_drill_torch{q}.json")
                 for q in ("", "_quick")],
}


def default_path(kind: str) -> str:
    """The first of ``kind``'s default paths that exists, else the first."""
    paths = DEFAULTS[kind]
    return next((p for p in paths if os.path.exists(p)), paths[0])

ARCH_ORDER = [
    "phi4-mini-3.8b", "llama3-8b", "deepseek-v2-236b", "qwen1.5-110b",
    "zamba2-1.2b", "llama4-scout-17b-a16e", "olmo-1b", "musicgen-medium",
    "xlstm-1.3b", "qwen2-vl-7b",
]
SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def _fmt_bytes(b):
    if b is None:
        return "-"
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if abs(b) < 1024:
            return f"{b:.1f}{unit}"
        b /= 1024
    return f"{b:.1f}PB"


def dryrun_table(dryrun_dir: str) -> str:
    rows = {}
    for path in glob.glob(os.path.join(dryrun_dir, "*.json")):
        with open(path) as f:
            r = json.load(f)
        rows[(r["arch"], r["shape"], r["mesh"])] = r
    lines = ["| arch | shape | 16x16 trace s | 2x16x16 trace s | "
             "collective bytes/chip (1-pod) | coll ops |",
             "|---|---|---|---|---|---|"]
    n_ok = 0
    for a in ARCH_ORDER:
        for s in SHAPE_ORDER:
            r1 = rows.get((a, s, "single"))
            r2 = rows.get((a, s, "multi"))
            if r1:
                n_ok += 1
            coll = r1["collectives"]["total_bytes"] if r1 else None
            cnt = r1["collectives"]["total_count"] if r1 else "-"
            lines.append(
                f"| {a} | {s} | "
                f"{'%.0fs' % r1['lower_s'] if r1 else 'MISSING'} | "
                f"{'%.0fs' % r2['lower_s'] if r2 else 'MISSING'} | "
                f"{_fmt_bytes(coll)} | {cnt} |")
    lines.append(f"\n{n_ok}/40 single-pod + "
                 f"{sum(1 for k in rows if k[2] == 'multi')}/40 multi-pod "
                 "combinations traced.")
    return "\n".join(lines)


def roofline_table(path: str) -> str:
    with open(path) as f:
        rows = json.load(f)
    by_key = {(r["arch"], r["shape"]): r for r in rows}
    lines = ["| arch | shape | compute (ms) | memory (ms) | "
             "collective (ms) | dominant | useful ratio |",
             "|---|---|---|---|---|---|---|"]
    for a in ARCH_ORDER:
        for s in SHAPE_ORDER:
            r = by_key.get((a, s))
            if not r:
                continue
            lines.append(
                "| %s | %s | %.2f | %.2f | %.2f | **%s** | %.2f |" % (
                    a, s, 1e3 * r["t_compute_s"], 1e3 * r["t_memory_s"],
                    1e3 * r["t_collective_s"], r["dominant"],
                    r["useful_ratio"]))
    # summary of dominant terms
    counts = defaultdict(int)
    for r in rows:
        counts[r["dominant"]] += 1
    lines.append("\nDominant-term census: " + ", ".join(
        f"{k}: {v}" for k, v in sorted(counts.items())))
    return "\n".join(lines)


def paper_table(path: str) -> str:
    with open(path) as f:
        res = json.load(f)
    out = []
    if "table1" in res:
        # Paper reference numbers: read from the artifact itself (new
        # eval subsystem embeds them as table1_deltas); fall back to
        # the canonical dict for pre-subsystem JSONs.
        if "table1_deltas" in res:
            paper = {k: v["paper_jcr_pct"]
                     for k, v in res["table1_deltas"].items()}
        else:
            if str(ROOT / "src") not in sys.path:
                sys.path.insert(0, str(ROOT / "src"))
            from repro_torch.eval.aggregate import PAPER_TABLE1 as paper
        out.append("| Policy | Paper JCR % | Ours JCR % |")
        out.append("|---|---|---|")
        for k, v in res["table1"].items():
            out.append(f"| {k} | {paper[k]} | {100 * v['jcr']:.1f} |")
    if "fig3" in res:
        out.append("\n| Policy | JCT p50 | p90 | p99 |")
        out.append("|---|---|---|---|")
        for k, v in res["fig3"].items():
            out.append(f"| {k} | {v['jct_p50']:.0f} | {v['jct_p90']:.0f} "
                       f"| {v['jct_p99']:.0f} |")
    if "fig4" in res:
        out.append("\n| Policy | util mean | p50 | p90 |")
        out.append("|---|---|---|---|")
        for k, v in res["fig4"].items():
            a = v["agg"]
            out.append(f"| {k} | {a['util_mean']:.3f} | {a['util_p50']:.3f}"
                       f" | {a['util_p90']:.3f} |")
    return "\n".join(out)


def fitmask_table(path: str) -> str:
    """Single-pass sweep of ``benchmarks_torch/fitmask_bench.py``: one
    multi-box launch (K1) for K boxes vs K single-box launches (K3),
    device time on the card, with the host numpy engine for scale."""
    with open(path) as f:
        bench = json.load(f)
    lines = ["| grid | batch | K | K1 ms | K x K3 ms | speedup | numpy ms |",
             "|---|---|---|---|---|---|---|"]
    for r in bench.get("sweep", []):
        numpy = r.get("numpy_ms")
        lines.append(
            f"| {r['grid']} | {r['batch']} | {r['k']} | "
            f"{r['multibox_ms']:.4f} | {r['singlepass_ms']:.4f} | "
            f"{r['speedup']:.2f}x | "
            f"{'not measured' if numpy is None else f'{numpy:.4f}'} |")
    head = bench.get("headline", {})
    if head:
        lines.append(
            f"\nHeadline ({head.get('criterion')}): "
            f"{head.get('min_speedup'):.2f}x-{head.get('max_speedup'):.2f}x, "
            f"pass={head.get('pass')}")
    if bench.get("card"):
        lines.append(f"\nCard: {bench['card']}")
    return "\n".join(lines)


def reconfig_table(path: str) -> str:
    """Batched plan search vs the naive oracle per cube granularity."""
    with open(path) as f:
        bench = json.load(f)
    lines = ["| cube | batched s | naive s | speedup | jcr |",
             "|---|---|---|---|---|"]
    for cube, r in bench.get("cube_sizes", {}).items():
        lines.append(
            f"| {cube} | {r['batched']['sim_seconds']:.2f} | "
            f"{r['naive']['sim_seconds']:.2f} | {r['speedup']}x | "
            f"{r['batched']['jcr']:.3f} |")
    head = bench.get("headline", {})
    if head:
        lines.append(f"\nHeadline ({head.get('criterion')}): "
                     f"{head.get('speedups')}, pass={head.get('pass')}")
    return "\n".join(lines)


def fleet_table(path: str) -> str:
    """Fleet-batched eval: broker-coalesced engine calls vs the
    sequential single-sim oracle (parity + dual headline). The port's
    bench replays once per broker lane count (``engine`` is a list, each
    with its ``max_inflight``) and adds the eval on the engine."""
    with open(path) as f:
        bench = json.load(f)
    lines = []
    par = bench.get("parity", {})
    if par:
        lines.append(
            f"Parity: {par.get('runs')}x{par.get('num_jobs')}x"
            f"{par.get('configs')} matrix identical="
            f"{par.get('identical')} — sequential "
            f"{par.get('sequential_s')}s vs fleet {par.get('fleet_s')}s "
            f"on the numpy host engine ({par.get('numpy_speedup')}x)")
    eng = bench.get("engine", {})
    replays = eng if isinstance(eng, list) else [eng] if eng else []
    if replays:
        lines.append(
            "\n| engine | sims | rounds | queries | sequential s | "
            "fleet s | speedup | mean B | batched calls |")
        lines.append("|---|---|---|---|---|---|---|---|---|")
    for e in replays:
        b = e.get("broker", {})
        lanes = (f", max_inflight {e['max_inflight']}"
                 if "max_inflight" in e else "")
        lines.append(
            f"| {e.get('engine')} ({e.get('grid')}, "
            f"K={e.get('k_boxes')}{lanes}) | {e.get('sims')} | "
            f"{e.get('rounds')} | {e.get('queries')} | "
            f"{e.get('sequential_s')} | {e.get('fleet_s')} | "
            f"{e.get('speedup')}x | {b.get('mean_grids_per_call')} | "
            f"{b.get('batched_calls')}/{b.get('engine_calls')} |")
    for e in replays:
        b = e.get("broker", {})
        if not b:
            continue
        lanes = (f" (max_inflight {e['max_inflight']})"
                 if "max_inflight" in e else "")
        pad = (f", pad waste B={b.get('b_pad_waste')} "
               f"K={b.get('k_pad_waste')}" if "b_pad_waste" in b else "")
        lines.append(
            f"\nBroker{lanes}: flush triggers all_parked="
            f"{b.get('flush_all_parked')} quorum="
            f"{b.get('flush_quorum')} timeout="
            f"{b.get('flush_timeout')}, requeued="
            f"{b.get('requeued')}{pad}, "
            f"free-count cache hits={b.get('fc_cache_hits')}")
        if "engine_failovers" in b:
            lines.append(
                f"\nResilience: steppers reaped="
                f"{b.get('steppers_reaped')}, engine retries="
                f"{b.get('engine_retries')}, failovers="
                f"{b.get('engine_failovers')} "
                f"(to {b.get('failover_engine')}), canary checks="
                f"{b.get('canary_checks')} mismatches="
                f"{b.get('canary_mismatches')}")
    ev = bench.get("eval")
    if ev:
        lines.append("\n| eval path | walls s (in turns) | identical |")
        lines.append("|---|---|---|")
        for name, row in ev.items():
            walls = ", ".join(f"{w:.2f}" for w in row["wall_s"])
            lines.append(f"| {name} | {walls} | {row['identical']} |")
    can = bench.get("canary", {})
    if can:
        lines.append(
            f"\nCanary drill: {can.get('start_engine')} -> "
            f"{can.get('adopted_engine')} after "
            f"{can.get('engine_failovers')} failover(s), "
            f"{can.get('canary_checks')} post-failover flushes "
            f"parity-checked, {can.get('canary_mismatches')} "
            f"mismatches (gate: must be 0)")
    head = bench.get("headline", {})
    if head:
        lines.append(
            f"\nHeadline: numpy {head.get('numpy_speedup')}x "
            f"(pass={head.get('pass_numpy')}), engine "
            f"{head.get('engine_speedup')}x "
            f"(pass={head.get('pass_engine')}), canary mismatches "
            f"{head.get('canary_mismatches')} "
            f"(pass={head.get('pass_canary')}) -> "
            f"pass={head.get('pass')}")
    return "\n".join(lines)


def service_table(path: str) -> str:
    """Allocator service: daemon parity, p99 placement latency under
    Poisson load, admission under overload."""
    with open(path) as f:
        bench = json.load(f)
    lines = []
    par = bench.get("parity", {})
    if par.get("configs"):
        lines.append("| policy | jobs | byte-identical | remote s |")
        lines.append("|---|---|---|---|")
        for r in par["configs"]:
            lines.append(f"| {r['label']} | {r['jobs']} | "
                         f"{r['identical']} | {r['remote_s']} |")
    lat = bench.get("latency", {})
    if lat:
        rem, loc = lat.get("remote", {}), lat.get("local", {})
        lines.append(
            f"\nLatency ({lat.get('jobs')} Poisson jobs, "
            f"{rem.get('rpcs')} RPCs): remote submit p50 "
            f"{rem.get('submit_p50_ms')}ms / p99 "
            f"{rem.get('submit_p99_ms')}ms vs in-process p99 "
            f"{loc.get('submit_p99_ms')}ms -> service overhead p99 "
            f"{lat.get('overhead_p99_ms')}ms")
    adm = bench.get("admission", {})
    if adm:
        c = adm.get("counts", {})
        lines.append(
            f"\nAdmission (flood {adm.get('flood')}, queue cap "
            f"{adm.get('max_queue')}): {c.get('placed')} placed / "
            f"{c.get('queued')} queued / {c.get('rejected')} rejected, "
            f"depth bounded={adm.get('depth_bounded')}, rejects "
            f"stateless={adm.get('rejects_stateless')}, status under "
            f"load {adm.get('status_under_load_ms')}ms")
    res = bench.get("resilience", {})
    if res:
        cnt = res.get("counters", {})
        lines.append(
            f"\nResilience crash drill ({res.get('ops')} ops, kills at "
            f"{res.get('kills')}): digest identical="
            f"{res.get('identical')}, resends clean="
            f"{res.get('resends_clean')}, dedup hits "
            f"{cnt.get('dedup_hits')}, WAL tail {cnt.get('wal_tail_ops')} "
            f"ops, recovered {cnt.get('recovered_ops')} ops at last boot, "
            f"lease expiries {cnt.get('lease_expiries')}")
    head = bench.get("headline", {})
    if head:
        line = (
            f"\nHeadline: p99 {head.get('p99_ms')}ms, service overhead "
            f"{head.get('overhead_p99_ms')}ms "
            f"(<= {head.get('threshold_ms')}ms), "
            f"parity={head.get('parity')}, "
            f"admission={head.get('admission')}")
        if "resilience" in head:
            line += f", resilience={head.get('resilience')}"
        lines.append(line + f" -> pass={head.get('pass')}")
    return "\n".join(lines)


def chaos_table(path: str) -> str:
    """Scenario x policy degradation/recovery matrix from the chaos
    bench (dip depth, recovered utilization, victim dispositions)."""
    with open(path) as f:
        bench = json.load(f)
    lines = ["| scenario | policy | jcr | util | dip | recovered util | "
             "preempted | migrated | deterministic |",
             "|---|---|---|---|---|---|---|---|---|"]
    for scenario in sorted(bench.get("scenarios", {})):
        for pol, cell in bench["scenarios"][scenario].items():
            ch = cell["chaos"]
            lines.append(
                f"| {scenario} | {cell.get('label', pol)} | "
                f"{cell['summary']['jcr']:.3f} | "
                f"{ch['util_overall']:.3f} | {ch['dip_depth']:.3f} | "
                f"{ch['recovered_util']:.3f} | {ch['preempted']} | "
                f"{ch['migrated']} | {cell['deterministic']} |")
    head = bench.get("headline", {})
    if head:
        lines.append(
            f"\nHeadline ({head.get('criterion')}): rfold util "
            f"{head.get('rfold_util')} vs static best "
            f"{head.get('static_best_util')}, recovered="
            f"{head.get('rfold_recovered')}, deterministic="
            f"{head.get('deterministic')} -> pass={head.get('pass')}")
    return "\n".join(lines)


def crash_table(path: str) -> str:
    """Crash-loop drill: SIGKILLed daemon vs uninterrupted control —
    the replay must be byte-identical and every resend a dedup hit."""
    with open(path) as f:
        bench = json.load(f)
    cnt = bench.get("crash", {}).get("resilience", {})
    lines = [
        f"Stream: {bench.get('ops')} ops, SIGKILL at {bench.get('kills')}",
        "\n| run | digest | journal ops |",
        "|---|---|---|",
        f"| control | `{bench.get('control', {}).get('digest', '')[:16]}` "
        f"| {bench.get('control', {}).get('journal_ops')} |",
        f"| crash-loop | `{bench.get('crash', {}).get('digest', '')[:16]}` "
        f"| {bench.get('crash', {}).get('journal_ops')} |",
        f"\nRecovery: {cnt.get('recovered_ops')} ops at last boot "
        f"({cnt.get('wal_tail_ops')} from the WAL tail), "
        f"{cnt.get('dedup_hits')} dedup hits on resend, identical="
        f"{bench.get('identical')} -> pass={bench.get('pass')}",
    ]
    return "\n".join(lines)


def failover_table(path: str) -> str:
    """Failover drill: kill -9 the primary mid-stream, promote the
    standby, fence the resurrected stale primary."""
    with open(path) as f:
        bench = json.load(f)
    h = bench.get("headline", {})
    fo = bench.get("failover", {})
    ack = bench.get("ack_overhead", {})
    lines = [
        "| run | digest | data ops | epoch |",
        "|---|---|---|---|",
        f"| control | `{bench.get('control', {}).get('digest', '')}` | "
        f"{bench.get('control', {}).get('data_ops')} | 1 |",
        f"| failover | `{fo.get('digest', '')}` | {fo.get('data_ops')} | "
        f"{fo.get('epoch')} |",
        f"\nFailover ({h.get('ops')} ops, SIGKILL at op "
        f"{fo.get('kill_at_op')}): RTO {h.get('rto_ms')}ms, replication "
        f"lag at kill {h.get('repl_lag_at_kill')} ops, acked ops lost "
        f"{h.get('acked_ops_lost')}, resend exactly-once="
        f"{h.get('resend_exactly_once')}",
        f"\nFencing: stale-primary writes landed "
        f"{h.get('fenced_writes_landed')} (journal+client sides="
        f"{h.get('fenced_client_and_journal')})",
    ]
    if ack:
        lines.append(
            f"\nAck modes: sync p50 "
            f"{ack.get('sync', {}).get('p50_ms')}ms vs async p50 "
            f"{ack.get('async', {}).get('p50_ms')}ms "
            f"(+{ack.get('overhead_p50_ms')}ms; sync standby-durable "
            f"frac {ack.get('sync', {}).get('replicated_frac')})")
    lines.append(f"\nHeadline: digest_identical={h.get('digest_identical')}"
                 f" -> pass={bench.get('pass')}")
    return "\n".join(lines)


def bench_table(alloc_path: str, eval_path: str) -> str:
    """Perf trajectory: placement-engine rates (``allocator_bench``)
    alongside end-to-end eval wall-clock (``paper_eval``'s bench JSON)."""
    out = []
    if os.path.exists(alloc_path):
        with open(alloc_path) as f:
            alloc = json.load(f)
        out.append("| policy bench | scale | sim s | placements/s | JCR |")
        out.append("|---|---|---|---|---|")
        for label, scales in alloc.get("policies", {}).items():
            for scale, r in scales.items():
                out.append(f"| {label} | {scale} | {r['sim_seconds']:.2f} "
                           f"| {r['placements_per_sec']:.0f} "
                           f"| {r['jcr']:.3f} |")
        base = alloc.get("baseline", {})
        if "speedup_vs_naive" in base:
            out.append(f"\nIncremental engine speedup vs naive RFold "
                       f"baseline: {base['speedup_vs_naive']:.1f}x")
    if os.path.exists(eval_path):
        with open(eval_path) as f:
            ev = json.load(f)
        cfg, pool = ev.get("config", {}), ev.get("pool", {})
        out.append(f"\nPaper eval ({cfg.get('runs')} runs x "
                   f"{cfg.get('num_jobs')} jobs): {ev.get('wall_s')}s "
                   f"wall on {pool.get('workers')} workers "
                   f"({pool.get('sim_s_total')}s sim total, "
                   f"{pool.get('reused_from_checkpoint')}/"
                   f"{pool.get('tasks')} from checkpoints)")
        per_pol = ev.get("per_policy_sim_s", {})
        if per_pol:
            out.append("\n| policy | total sim s |")
            out.append("|---|---|")
            for label, s in sorted(per_pol.items(), key=lambda kv: -kv[1]):
                out.append(f"| {label} | {s:.1f} |")
    return "\n".join(out) if out else "(no bench artifacts yet)"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="report")
    ap.add_argument("--which", default="all",
                    choices=["all", "dryrun", "roofline", "paper", "bench",
                             "fitmask", "reconfig", "fleet", "service",
                             "chaos", "crash", "failover"])
    args = ap.parse_args(argv)
    which = args.which
    if which in ("all", "dryrun"):
        print("### Dry-run matrix\n")
        print(dryrun_table(default_path("dryrun")))
    if which in ("all", "roofline") and \
            os.path.exists(default_path("roofline")):
        print("\n### Roofline baseline (H100 data-sheet terms)\n")
        print(roofline_table(default_path("roofline")))
    if which in ("all", "paper") and os.path.exists(default_path("paper")):
        print("\n### Paper validation\n")
        print(paper_table(default_path("paper")))
    if which in ("all", "bench"):
        print("\n### Perf trajectory (the port's benches)\n")
        print(bench_table(default_path("alloc"), default_path("eval")))
    for kind, title, table in (
            ("fitmask", "Fitmask multi-box kernel", fitmask_table),
            ("reconfig", "Reconfiguration plan search", reconfig_table),
            ("fleet", "Fleet-batched eval", fleet_table),
            ("service", "Allocator service", service_table),
            ("chaos", "Chaos layer", chaos_table),
            ("crash", "Crash-loop drill", crash_table),
            ("failover", "Failover drill", failover_table)):
        path = default_path(kind)
        if which in ("all", kind) and os.path.exists(path):
            print(f"\n### {title} ({path})\n")
            print(table(path))


if __name__ == "__main__":
    main()
