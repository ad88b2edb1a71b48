#!/usr/bin/env python3
"""Roofline analysis on the port from the dry-run JSON artifacts of
``python -m repro_torch.launch.dryrun``.

Per (arch x shape x mesh), on one NVIDIA H100 SXM's data-sheet peaks
(``repro_torch.launch.perf``: ``PEAK_FLOPS``, ``HBM_BW``, ``NVLINK_BW``):
  compute    = FLOPs_per_chip / PEAK_FLOPS[activation dtype]   [s]
  memory     = bytes_per_chip / HBM_BW                         [s]
  collective = collective_bytes_per_chip / NVLINK_BW           [s]
The counts are the probes' extrapolation where the JSON has one (see
``launch/dryrun.py``), else the full-depth counts.

What the counts are differs from ``benchmarks/roofline.py``'s, which
reads XLA's cost analysis of the compiled SPMD step: here the per-chip
FLOPs are the local ops DTensor runs on one rank's shards, and the bytes
are the sum over unfused eager aten ops of their inputs and outputs, so
the memory term is an upper bound against the reference's fused count
(``src/repro_torch/launch/dryrun.py``'s docstring).

MODEL_FLOPS = 6*N*D for training (2*N*D forward-only for prefill/decode),
with N = active params for MoE. The ratio MODEL_FLOPS / FLOPs exposes
remat / redundant compute.

    python3 benchmarks_torch/roofline.py [--dryrun-dir experiments/dryrun_torch]
        [--mesh single] [--out experiments/roofline_torch.json]
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from pathlib import Path
from typing import Any, Dict, List, Optional

ROOT = Path(__file__).resolve().parents[1]

SUGGESTIONS = {
    "compute": ("compute-bound: raise tensor-core utilization (bigger "
                "per-chip tiles, fused kernels, bf16 GEMMs) or add chips"),
    "memory": ("HBM-bound: cut activation traffic (fusion, remat policy, "
               "bf16 masters) or raise arithmetic intensity with larger "
               "microbatches"),
    "collective": ("NVLink-bound: reshard to cut cross-chip traffic "
                   "(fewer all-gathers per layer, overlap collectives "
                   "with compute, or shrink the sharded axis)"),
}


def _src_on_path() -> None:
    if str(ROOT / "src") not in sys.path:
        sys.path.insert(0, str(ROOT / "src"))


def model_param_counts(arch: str):
    """(total_params, active_params) from the real param tree, built on
    the meta device (shapes, no storage): routed-expert leaves are those
    under a ``"moe"`` key with a dim equal to ``n_experts``."""
    _src_on_path()
    from repro_torch.configs import get_config
    from repro_torch.models import model as lm
    cfg = get_config(arch)
    counts = {"total": 0, "routed": 0}

    def count(path, leaf):
        n = leaf.numel()
        counts["total"] += n
        if cfg.n_experts and "moe" in path and any(
                dim == cfg.n_experts for dim in leaf.shape):
            counts["routed"] += n

    lm.tree_map_with_path(count, lm.init_model(cfg, device="meta"))
    total, routed = counts["total"], counts["routed"]
    if cfg.n_experts:
        active = total - routed + routed * (cfg.moe_top_k / cfg.n_experts)
    else:
        active = total
    return float(total), float(active)


def tokens_for(shape_name: str) -> float:
    _src_on_path()
    from repro_torch.configs.shapes import SHAPES
    sh = SHAPES[shape_name]
    if sh.kind in ("train", "prefill"):
        return float(sh.global_batch * sh.seq_len)
    return float(sh.global_batch)  # decode: one token per sequence


def roofline_row(res: Dict[str, Any],
                 counts_cache: Dict[str, Any]) -> Dict[str, Any]:
    _src_on_path()
    from repro_torch.configs import get_config
    from repro_torch.launch.perf import HBM_BW, NVLINK_BW, PEAK_FLOPS
    arch, shape_name = res["arch"], res["shape"]
    chips = res["chips"]
    probes = res.get("probes") or {}
    ex = probes.get("extrapolated") or {
        "flops": res.get("flops") or 0.0,
        "bytes": res.get("bytes_accessed") or 0.0,
        "collective_bytes": res["collectives"]["total_bytes"],
    }
    t_compute = ex["flops"] / PEAK_FLOPS[get_config(arch).dtype]
    t_memory = ex["bytes"] / HBM_BW
    t_coll = ex["collective_bytes"] / NVLINK_BW
    terms = {"compute": t_compute, "memory": t_memory,
             "collective": t_coll}
    dominant = max(terms, key=terms.get)

    if arch not in counts_cache:
        counts_cache[arch] = model_param_counts(arch)
    total_p, active_p = counts_cache[arch]
    toks = tokens_for(shape_name)
    mult = 6.0 if shape_name.startswith("train") else 2.0
    model_flops_per_chip = mult * active_p * toks / chips
    ratio = model_flops_per_chip / ex["flops"] if ex["flops"] else 0.0

    return {
        "arch": arch, "shape": shape_name, "mesh": res["mesh"],
        "chips": chips,
        "t_compute_s": t_compute, "t_memory_s": t_memory,
        "t_collective_s": t_coll,
        "dominant": dominant,
        "model_flops_per_chip": model_flops_per_chip,
        "hlo_flops_per_chip": ex["flops"],
        "useful_ratio": ratio,
        "suggestion": SUGGESTIONS[dominant],
        "compile_s": res.get("compile_s"),
    }


def load_rows(dryrun_dir: str, mesh: Optional[str] = "single"
              ) -> List[Dict[str, Any]]:
    counts: Dict[str, Any] = {}
    rows = []
    for path in sorted(glob.glob(os.path.join(dryrun_dir, "*.json"))):
        with open(path) as f:
            res = json.load(f)
        if mesh and res.get("mesh") != mesh:
            continue
        rows.append(roofline_row(res, counts))
    return rows


def format_table(rows: List[Dict[str, Any]]) -> str:
    hdr = ("arch,shape,mesh,t_compute_ms,t_memory_ms,t_collective_ms,"
           "dominant,useful_ratio")
    lines = [hdr]
    for r in rows:
        lines.append(
            "%s,%s,%s,%.3f,%.3f,%.3f,%s,%.2f" % (
                r["arch"], r["shape"], r["mesh"],
                1e3 * r["t_compute_s"], 1e3 * r["t_memory_s"],
                1e3 * r["t_collective_s"], r["dominant"],
                r["useful_ratio"]))
    return "\n".join(lines)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="roofline")
    ap.add_argument("--dryrun-dir", default=os.path.join(
        "experiments", "dryrun_torch"))
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--out", default=os.path.join(
        "experiments", "roofline_torch.json"),
        help="JSON output ('' disables); never a committed BENCH_*.json")
    args = ap.parse_args(argv)
    if args.out and os.path.basename(args.out).startswith("BENCH_"):
        ap.error("the committed BENCH_*.json snapshots are the reference "
                 "package's; write the port's JSON elsewhere")
    rows = load_rows(args.dryrun_dir, args.mesh or None)
    print(format_table(rows))
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1, default=float)
        print(f"# wrote {args.out} ({len(rows)} rows)")


if __name__ == "__main__":
    main()
