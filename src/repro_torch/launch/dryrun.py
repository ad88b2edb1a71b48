r"""Multi-pod dry-run on a fake process group.

For every (architecture x input shape x mesh) combination, build the
production mesh over a fake process group of 256 (or 512) ranks
(``FakeStore``; ``repro`` forces 512 host-platform devices), put the
params, optimizer state, batch and decode state on it by the sharding
rules as DTensors whose shards are meta-device tensors (shapes, no
storage), run the step function once, eagerly, as rank 0, and record
what that rank would do (``benchmarks/roofline.py`` reads the JSON's
keys). Meta tensors, not ``FakeTensorMode``: DTensor's bookkeeping for
a dim split over two mesh axes (attention's batch x heads) builds host
tensors and reads them back, which fake mode refuses.

- ``flops``: ``torch.utils.flop_counter``'s formulas over the shapes of
  the rank's own ops. ``CostMode`` lets DTensor turn each op into the
  ops on the local shards and counts those, not the global op that
  ``FlopCounterMode`` sees above DTensor's dispatch; the global-shape
  ops that DTensor runs to propagate tensor metadata are skipped.
- ``bytes_accessed``: the sum, over the rank's aten ops (views and bare
  allocations left out), of their tensor inputs' and outputs' bytes.
  The step runs on meta-device shards, so only ops on meta tensors
  count: DTensor's own bookkeeping on host tensors does not.
  XLA's "bytes accessed" counts a fused module, so this count of
  unfused eager ops is higher than ``repro``'s for the same step.
- ``collectives``: the ``_c10d_functional`` ops that DTensor issues, by
  kind under ``repro``'s keys, with the bytes of their results (as
  ``repro``'s HLO parse counts result types); ``collective_bytes``
  stands where ``repro``'s ``parse_collective_bytes`` stands.
- ``memory_analysis``: the rank's argument and output bytes, and as
  ``temp_size_in_bytes`` the peak of the storage bytes the step
  allocates and holds at once. ``MemTracker`` would count DTensor's
  global-shape propagation tensors too, so ``CostMode`` tracks the
  storages itself. No generated code: that key is null.
- ``lower_s`` is the trace's wall time, ``compile_s`` 0, ``hlo_ops``
  the count of the rank's aten ops.

Probes (two reduced depths) run and are extrapolated as ``repro``'s;
eager counting sees every layer, so for a homogeneous stack the
extrapolation equals the full-depth count.

Usage:
  python -m repro_torch.launch.dryrun --arch llama3-8b --shape train_4k \
      --mesh single --out experiments/dryrun_torch
  python -m repro_torch.launch.dryrun --all [--mesh both]

The mesh is of the card's device type unless ``--device cpu`` is given;
nothing is allocated on the card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import weakref
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import get_config
from repro_torch.configs.registry import ARCH_IDS
from repro_torch.configs.shapes import SHAPES, InputShape, batch_specs, \
    cache_window
from repro_torch.models import model as lm
from repro_torch.models.common import ModelConfig
from repro_torch.parallel.sharding import (batch_specs_sharding,
                                           decode_state_specs,
                                           distribute_tree, logical_rules,
                                           param_shardings, rules_for)
from repro_torch.serve import engine
from repro_torch.train.optim import OptimConfig, init_opt_state
from repro_torch.train.train_step import train_step
from .mesh import make_production_mesh

COLLECTIVE_OPS = ("all-reduce", "all-gather", "reduce-scatter",
                  "all-to-all", "collective-permute")

# _c10d_functional op name -> repro's HLO kind (others, such as
# wait_tensor, move no data)
_COLLECTIVE_KIND = {
    "broadcast": "broadcast",
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}

# ops that allocate without reading or writing data
_ALLOCATIONS = {"empty", "empty_like", "empty_strided", "new_empty",
                "new_empty_strided"}


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for t in tree:
            yield from _tensors(t)
    elif isinstance(tree, dict):
        for t in tree.values():
            yield from _tensors(t)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _propagation_code():
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    return ShardingPropagator._propagate_tensor_meta_non_cached.__code__


class CostMode(TorchDispatchMode):
    """Counts the ops of this rank: FLOPs, bytes, collectives and the
    peak of live storage bytes (see the module docstring)."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._flop_registry = flop_registry
        self._skip = _propagation_code()
        self.flops = 0
        self.bytes = 0
        self.ops = 0
        self.collectives: Dict[str, Dict[str, int]] = {
            op: {"bytes": 0, "count": 0} for op in COLLECTIVE_OPS}
        self.live = 0
        self.peak = 0
        self._seen: "weakref.WeakSet" = weakref.WeakSet()

    def _in_propagation(self) -> bool:
        f = sys._getframe(2)
        while f is not None:
            if f.f_code is self._skip:
                return True
            f = f.f_back
        return False

    def _free(self, n: int) -> None:
        self.live -= n

    def _track(self, out) -> None:
        for t in _tensors(out):
            st = t.untyped_storage()
            if st in self._seen:
                continue
            self._seen.add(st)
            n = st.nbytes()
            self.live += n
            weakref.finalize(st, self._free, n)
        self.peak = max(self.peak, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented       # DTensor desugars it into local ops
        out = func(*args, **kwargs)
        if self._in_propagation():
            return out
        ns = func.namespace
        name = func._schema.name.split("::")[-1]
        if ns == "_c10d_functional":
            kind = _COLLECTIVE_KIND.get(name)
            if kind is not None:
                rec = self.collectives.setdefault(kind,
                                                  {"bytes": 0, "count": 0})
                rec["bytes"] += sum(_nbytes(t) for t in _tensors(out))
                rec["count"] += 1
            return out
        if ns != "aten" or not any(
                t.is_meta for t in _tensors((args, kwargs, out))):
            return out      # DTensor's own bookkeeping on host tensors
        self.ops += 1
        self._track(out)
        if func.is_view or name in _ALLOCATIONS:
            return out
        self.bytes += sum(_nbytes(t) for t in _tensors((args, kwargs)))
        self.bytes += sum(_nbytes(t) for t in _tensors(out))
        flop = self._flop_registry.get(func.overloadpacket)
        if flop is not None:
            self.flops += flop(*args, **kwargs, out_val=out)
        return out


def collective_bytes(collectives: Dict[str, Dict[str, int]]
                     ) -> Dict[str, Any]:
    """``CostMode``'s collectives with ``repro``'s totals: bytes of
    results and op counts, keyed by kind (``parse_collective_bytes``'s
    output)."""
    out: Dict[str, Any] = {k: dict(v) for k, v in collectives.items()}
    out["total_bytes"] = sum(v["bytes"] for v in collectives.values())
    out["total_count"] = sum(v["count"] for v in collectives.values())
    return out


def build_dryrun(cfg: ModelConfig, shape: InputShape, multi_pod: bool = False,
                 rules: Optional[Dict[str, Any]] = None, device=None,
                 mesh=None):
    """Returns (mesh, fn, args): ``fn(*args)`` runs the step on the
    mesh, its inputs meta-device tensors (as DTensors' shards). ``mesh``
    None: the production mesh; ``rules`` None: ``rules_for(mesh)``
    (a perf variant passes its own). ``mesh=False``: one rank, plain
    tensors of the global shapes (no DTensor, no rules)."""
    long_ctx = shape.name == "long_500k"
    if mesh is None:
        mesh = make_production_mesh(multi_pod=multi_pod, device=device)
    if mesh is False:
        rules = None
    else:
        rules = dict(rules) if rules is not None else \
            rules_for(mesh, shard_cache_seq=long_ctx)
        if long_ctx:
            rules["batch"] = None      # global_batch=1: nothing to shard

    def put(tree, shardings):
        return tree if mesh is False else distribute_tree(tree, shardings)

    params = lm.init_model(cfg, device="meta")
    if mesh is not False:
        params = put(params, param_shardings(params, mesh, rules,
                                             n_expert_hint=cfg.n_experts))
    b_specs = batch_specs(cfg, shape)
    batch = dict(b_specs)
    if mesh is not False:
        batch = put(batch, batch_specs_sharding(b_specs, mesh, rules))

    if shape.kind == "train":
        opt_cfg = OptimConfig()

        def fn(params, opt_state, batch):
            with logical_rules(rules):
                new_p, new_o, metrics = train_step(cfg, opt_cfg, params,
                                                   opt_state, batch)
            return new_p, new_o, metrics["loss"]

        args = (params, init_opt_state(params), batch)
    elif shape.kind == "prefill":
        def fn(params, batch):
            with torch.no_grad(), logical_rules(rules):
                logits, _ = lm.forward(cfg, params, batch)
            return logits

        args = (params, batch)
    else:  # decode
        window = cache_window(cfg, shape)
        state = engine.init_state(cfg, shape.global_batch, window,
                                  device="meta")
        if mesh is not False:
            state = put(state, decode_state_specs(state, mesh, rules))

        def fn(params, state, batch):
            with torch.no_grad(), logical_rules(rules):
                return engine.serve_step(cfg, params, state, batch)

        args = (params, state, batch)
    return mesh, fn, args


def probe_depths(cfg: ModelConfig):
    """Two reduced depths for the cost probes (``repro``'s: XLA counts
    scan bodies once, so its per-layer cost comes from the slope)."""
    if cfg.arch_type == "ssm":
        return (cfg.slstm_every, 2 * cfg.slstm_every)
    if cfg.arch_type == "hybrid":
        return (cfg.shared_attn_every, 2 * cfg.shared_attn_every)
    if cfg.arch_type == "moe":
        k = cfg.first_k_dense
        return (k + 1, k + 3)
    return (2, 4)


def _local_bytes(tree) -> int:
    from torch.distributed.tensor import DTensor
    return sum(_nbytes(t.to_local() if isinstance(t, DTensor) else t)
               for t in _tensors(tree))


def trace_cost(cfg: ModelConfig, shape: InputShape, multi_pod: bool = False,
               rules: Optional[Dict[str, Any]] = None, device=None,
               mesh=None) -> Dict[str, Any]:
    """Build the step on storage-less tensors and count one run of it as
    rank 0 (``build_dryrun``'s arguments)."""
    t0 = time.time()
    if mesh is None:
        mesh = make_production_mesh(multi_pod=multi_pod, device=device)
    mesh, fn, args = build_dryrun(cfg, shape, multi_pod, rules, device, mesh)
    arg_bytes = _local_bytes(args)
    cost = CostMode()
    with cost:
        out = fn(*args)
    out_bytes = _local_bytes(out)
    del out
    coll = collective_bytes(cost.collectives)
    return {
        "flops": float(cost.flops),
        "bytes": float(cost.bytes),
        "collective_bytes": coll["total_bytes"],
        "collectives": coll,
        "ops": cost.ops,
        "wall_s": time.time() - t0,
        "memory": {"argument_size_in_bytes": arg_bytes,
                   "output_size_in_bytes": out_bytes,
                   "temp_size_in_bytes": cost.peak,
                   "generated_code_size_in_bytes": None},
    }


def _compile_cost(cfg: ModelConfig, shape: InputShape, multi_pod: bool,
                  rules: Optional[Dict[str, Any]] = None, device=None,
                  mesh=None) -> Dict[str, Any]:
    c = trace_cost(cfg, shape, multi_pod, rules, device, mesh)
    return {k: c[k] for k in ("flops", "bytes", "collective_bytes",
                              "collectives")}


def one_rank_cost(cfg: ModelConfig, shape: InputShape, device=None
                  ) -> Dict[str, Any]:
    """The same step on one rank, unsharded (plain meta tensors): the
    count a mesh's per-rank counts should add up to."""
    return trace_cost(cfg, shape, device=device, mesh=False)


def fake_process_group(chips: int) -> bool:
    """Start a fake process group of ``chips`` ranks (this process is
    rank 0) unless one of that size is up; returns True when it started
    one (the caller destroys it). A group of another size raises."""
    if dist.is_initialized():
        if dist.get_world_size() != chips:
            raise RuntimeError(f"a process group of {dist.get_world_size()}"
                               f" ranks is up; the dry-run needs {chips}")
        return False
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=chips)
    return True


def run_one(arch: str, shape_name: str, mesh_kind: str,
            probe: bool = True, device=None) -> Dict[str, Any]:
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    multi_pod = mesh_kind == "multi"
    chips = 512 if multi_pod else 256
    created = fake_process_group(chips)
    try:
        mesh = make_production_mesh(multi_pod=multi_pod, device=device)
        full = trace_cost(cfg, shape, multi_pod, device=device, mesh=mesh)
        probes = None
        if probe:
            l_small, l_big = probe_depths(cfg)
            c_small = _compile_cost(
                cfg.replace(n_layers=l_small, force_unscanned=True),
                shape, multi_pod, device=device, mesh=mesh)
            c_big = _compile_cost(
                cfg.replace(n_layers=l_big, force_unscanned=True),
                shape, multi_pod, device=device, mesh=mesh)
            span = l_big - l_small
            L = cfg.n_layers

            def extrap(key):
                slope = (c_big[key] - c_small[key]) / span
                return c_small[key] + slope * (L - l_small), slope

            flops_t, flops_slope = extrap("flops")
            bytes_t, bytes_slope = extrap("bytes")
            coll_t, coll_slope = extrap("collective_bytes")
            probes = {
                "depths": [l_small, l_big],
                "small": c_small, "big": c_big,
                "per_layer": {"flops": flops_slope, "bytes": bytes_slope,
                              "collective_bytes": coll_slope},
                "extrapolated": {"flops": flops_t, "bytes": bytes_t,
                                 "collective_bytes": coll_t},
            }
    finally:
        if created:
            dist.destroy_process_group()
    return {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind,
        "chips": chips,
        "lower_s": round(full["wall_s"], 2), "compile_s": 0.0,
        "flops": full["flops"],
        "bytes_accessed": full["bytes"],
        "memory_analysis": full["memory"],
        "collectives": full["collectives"],
        "hlo_ops": full["ops"],
        "probes": probes,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", type=str, default="")
    ap.add_argument("--shape", type=str, default="",
                    choices=[""] + list(SHAPES))
    ap.add_argument("--mesh", type=str, default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", type=str, default="experiments/dryrun_torch")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--no-probe", action="store_true",
                    help="skip the reduced-depth cost probes")
    ap.add_argument("--archs", type=str, default="",
                    help="comma-separated arch filter for --all")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="device type of the mesh")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)

    if not args.all:
        if not (args.arch and args.shape and args.mesh != "both"):
            ap.error("give --arch, --shape and one --mesh (or --all)")
        res = run_one(args.arch, args.shape, args.mesh,
                      probe=not args.no_probe, device=args.device)
        path = os.path.join(
            args.out, f"{args.arch}__{args.shape}__{args.mesh}.json")
        with open(path, "w") as f:
            json.dump(res, f, indent=1)
        print(json.dumps({k: res[k] for k in
                          ("arch", "shape", "mesh", "lower_s", "flops",
                           "bytes_accessed")}))
        print("collectives:", json.dumps(res["collectives"]))
        return 0

    # --all: one subprocess per combo (isolates process groups and failures)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    archs = [a for a in ARCH_IDS
             if not args.archs or a in args.archs.split(",")]
    failures = []
    for arch in archs:
        for shape_name in SHAPES:
            for mk in meshes:
                path = os.path.join(
                    args.out, f"{arch}__{shape_name}__{mk}.json")
                if os.path.exists(path) and not args.force:
                    print(f"skip {path}")
                    continue
                cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                       "--arch", arch, "--shape", shape_name,
                       "--mesh", mk, "--out", args.out,
                       "--device", args.device]
                if mk == "multi" or args.no_probe:
                    cmd.append("--no-probe")  # roofline is single-pod
                print(">>", arch, shape_name, mk, flush=True)
                t0 = time.time()
                r = subprocess.run(cmd, capture_output=True, text=True)
                dt = time.time() - t0
                if r.returncode != 0:
                    failures.append((arch, shape_name, mk))
                    print(f"FAIL ({dt:.0f}s)\n{r.stdout[-2000:]}"
                          f"\n{r.stderr[-4000:]}", flush=True)
                else:
                    print(f"ok ({dt:.0f}s) {r.stdout.strip()[:300]}",
                          flush=True)
    if failures:
        print("FAILURES:", failures)
        return 1
    print("all dry-runs passed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
