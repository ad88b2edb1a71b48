r"""Perf-iteration harness (§Perf): run named optimization variants of a
(arch x shape) pair through the dry-run cost pipeline and report the
three roofline terms per variant, so each hypothesis -> change ->
before/after cycle is one CLI call.

  PYTHONPATH=src python -m repro_torch.launch.perf --arch qwen1.5-110b \
      --shape train_4k --variants baseline,remat_full,no_fsdp

The terms are estimates: per-rank counts of the dry-run (a fake process
group of 256 ranks, ``launch.dryrun``) over the data-sheet peaks of one
NVIDIA H100 SXM (dense, 700 W): the activation dtype's tensor-core or
CUDA-core rate, HBM3's bandwidth and NVLink's per-direction bandwidth.
``repro``'s are TPU v5e's. A variant changes the config or the rule
table, which ``build_dryrun`` takes as an argument.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Any, Callable, Dict

import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.configs.shapes import SHAPES
from repro_torch.launch import dryrun as dr
from repro_torch.parallel.sharding import rules_for
from .mesh import make_production_mesh

# NVIDIA H100 SXM data sheet (dense, no sparsity; at the 700 W limit)
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}
HBM_BW = 3.35e12             # HBM3, bytes/s
NVLINK_BW = 450e9            # NVLink 4, bytes/s a direction


def _v_baseline(cfg, rules):
    return cfg, rules


def _v_remat_full(cfg, rules):
    """Hypothesis: full activation remat cuts HBM traffic (memory term)
    at ~+1/3 compute."""
    return cfg.replace(remat="full"), rules


def _v_no_fsdp(cfg, rules):
    """Hypothesis: replicating params over the data axis removes the
    per-layer all-gathers (collective term) at the cost of per-chip
    parameter memory."""
    rules = dict(rules)
    rules["fsdp"] = None
    return cfg, rules


def _v_seq_shard(cfg, rules):
    """Hypothesis: sharding activations along sequence (context
    parallelism) moves batch-axis pressure to the data axis for
    long-sequence prefill."""
    rules = dict(rules)
    rules["seq"] = "data"
    rules["batch"] = None
    return cfg, rules


def _v_cap_tight(cfg, rules):
    """Hypothesis (MoE): capacity factor 1.0 cuts expert-dispatch
    compute/all-to-all bytes proportionally (more drops)."""
    return cfg.replace(capacity_factor=1.0), rules


def _v_cap_loose(cfg, rules):
    return cfg.replace(capacity_factor=2.0), rules


def _v_window_4k(cfg, rules):
    """Hypothesis (long-context decode): halving the sliding window
    halves KV bytes per step (memory term) without touching params."""
    return cfg.replace(sliding_window=4096), rules


def _v_window_16k(cfg, rules):
    return cfg.replace(sliding_window=16384), rules


def _v_mla_absorb(cfg, rules):
    """Hypothesis (MLA decode): weight absorption attends in the
    compressed c_kv space, removing the per-step re-expansion of k/v
    over the whole cache — expect order-of-magnitude drops in the
    compute AND memory terms at identical math."""
    return cfg.replace(mla_absorb=True), rules


def _v_cache_seq_model(cfg, rules):
    """Hypothesis (decode): sharding the KV/c_kv cache's sequence dim
    over the model axis (flash-decode style partial softmax) splits the
    dominant cache-read bytes across the model axis at the cost of an
    all-reduce over partial softmax stats."""
    rules = dict(rules)
    rules["cache_seq"] = "model"
    return cfg, rules


def _v_absorb_plus_cacheshard(cfg, rules):
    rules = dict(rules)
    rules["cache_seq"] = "model"
    return cfg.replace(mla_absorb=True), rules


def _v_absorb_cacheshard_nofsdp(cfg, rules):
    """Hypothesis: with compute/memory crushed, decode's collective
    term is dominated by per-step param all-gathers (FSDP); replicating
    params over the data axis removes them."""
    rules = dict(rules)
    rules["cache_seq"] = "model"
    rules["fsdp"] = None
    return cfg.replace(mla_absorb=True), rules


def _v_moe_local(cfg, rules):
    """Hypothesis (MoE train): the global-argsort dispatch forces XLA
    to all-gather every token per MoE layer (a sort cannot be sharded);
    per-batch-row dispatch keeps routing local to the data shard —
    expect the collective term to collapse by >10x."""
    return cfg.replace(moe_local_dispatch=True), rules


def _v_moe_local_noefsdp(cfg, rules):
    """Hypothesis: local dispatch removed the token all-gather, but the
    expert matmuls' contraction dim is FSDP-sharded on 'data', forcing
    an all-reduce of the (B,E,cap,f) expert outputs every layer.
    Un-sharding ONLY the expert weights' fsdp dim (experts stay
    expert-parallel on 'model') should collapse the collective term."""
    rules = dict(rules)
    rules["expert_fsdp"] = None
    return cfg.replace(moe_local_dispatch=True), rules


VARIANTS: Dict[str, Callable] = {
    "moe_local": _v_moe_local,
    "moe_local_noefsdp": _v_moe_local_noefsdp,
    "cache_seq_model": _v_cache_seq_model,
    "absorb_cacheshard": _v_absorb_plus_cacheshard,
    "absorb_cs_nofsdp": _v_absorb_cacheshard_nofsdp,
    "baseline": _v_baseline,
    "remat_full": _v_remat_full,
    "no_fsdp": _v_no_fsdp,
    "seq_shard": _v_seq_shard,
    "cap_tight": _v_cap_tight,
    "cap_loose": _v_cap_loose,
    "window_4k": _v_window_4k,
    "window_16k": _v_window_16k,
    "mla_absorb": _v_mla_absorb,
}


def run_variant(arch: str, shape_name: str, variant: str,
                multi_pod: bool = False, device=None,
                mesh=None) -> Dict[str, Any]:
    """The variant's per-rank terms, extrapolated from two probe depths
    as ``repro``'s, on ``mesh`` (None: the production mesh; the process
    group must have its ranks, ``main`` starts a fake one)."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    if mesh is None:
        mesh = make_production_mesh(multi_pod=multi_pod, device=device)
    long_ctx = shape.name == "long_500k"
    rules = rules_for(mesh, shard_cache_seq=long_ctx)
    if long_ctx:
        rules["batch"] = None
    cfg2, rules2 = VARIANTS[variant](cfg, rules)

    l_small, l_big = dr.probe_depths(cfg2)
    t0 = time.time()
    c_small = _probe(cfg2, rules2, shape, multi_pod, l_small, mesh, device)
    c_big = _probe(cfg2, rules2, shape, multi_pod, l_big, mesh, device)
    span = l_big - l_small
    L = cfg2.n_layers

    def extrap(key):
        return c_small[key] + (c_big[key] - c_small[key]) / span \
            * (L - l_small)

    flops, byts, coll = (extrap("flops"), extrap("bytes"),
                         extrap("collective_bytes"))
    terms = {"compute": flops / PEAK_FLOPS[cfg2.dtype],
             "memory": byts / HBM_BW, "collective": coll / NVLINK_BW}
    return {
        "arch": arch, "shape": shape_name, "variant": variant,
        "flops_per_chip": flops, "bytes_per_chip": byts,
        "collective_bytes_per_chip": coll,
        "t_compute_s": terms["compute"], "t_memory_s": terms["memory"],
        "t_collective_s": terms["collective"],
        "dominant": max(terms, key=terms.get),
        "wall_s": round(time.time() - t0, 1),
    }


def _probe(cfg, rules, shape, multi_pod, depth, mesh, device):
    """The dry-run's cost of ``cfg`` at ``depth`` layers, with the
    variant's rules."""
    cfg_p = cfg.replace(n_layers=depth, force_unscanned=True)
    return dr.trace_cost(cfg_p, shape, multi_pod, rules=rules,
                         device=device, mesh=mesh)


def main(argv=None) -> list:
    """Prints one JSON line a variant; returns the rows."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True, choices=list(SHAPES))
    ap.add_argument("--variants", default="baseline")
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--out", default="")
    ap.add_argument("--device", default="cuda",
                    help="device type of the dry-run's mesh")
    args = ap.parse_args(argv)
    multi = args.mesh == "multi"
    created = dr.fake_process_group(512 if multi else 256)
    rows = []
    try:
        for v in args.variants.split(","):
            r = run_variant(args.arch, args.shape, v, multi_pod=multi,
                            device=args.device)
            rows.append(r)
            print(json.dumps(r), flush=True)
    finally:
        if created:
            dist.destroy_process_group()
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return rows


if __name__ == "__main__":
    main()
