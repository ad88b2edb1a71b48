#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; needs one card

1. Prints the card's name and power limit (``nvidia-smi``), and sets
   and prints the fp32 numerics (no TF32 in matmuls or cuDNN).
2. Builds the three CUDA sources of ``src/repro_torch/csrc`` (fitmask,
   flash attention, SSD scan) with nvcc for sm_90a, one nvcc process per
   source, all started together, and prints each ``-Xptxas -v`` report.
3. Fitmask kernel phase: prints the card's floor for one launch (an
   empty kernel, queued), then holds K1-K3 and the fused bucketed launch
   (K1's kernel writing bool planes and the occupied counts, planes and
   counts both checked) bit-exact against their plain PyTorch versions
   on the card, at the shapes the placement loop gives them and at the
   bit-row kernel's edges (grids of 38^3 and 64^3, rows of 64 cells with
   boxes of 1, 63, 64 and 65 along z, rows of 3, 5 and 13 cells, a batch
   that starts off a 16-byte boundary, uint8 grids viewed as bool with
   bytes of 2 and 255), K2 also at one and two grids of each of the
   loop's cube sizes, and times each beside the least time the card
   could take (the bound) and, where one PyTorch call computes the same
   function, beside that call (K2: ``occ.sum``; K3: ``F.max_pool3d`` over
   the box, first checked equal to the kernel's plane where the box
   fits). The fused launch and K2 are also checked and timed at the
   fleet's shapes: six simulators' grids stacked on B (6 x 16^3,
   48 x 8^3, 384 x 4^3, 3072 x 2^3) with the loop's box tables.
4. Placement main path: runs the eight Table 1 / Fig 3 placement
   configurations at 4096 XPUs on the 200-job trace (seed 0,
   ``target_load=1.5``) through the ``cuda`` engine, and again through
   the host ``numpy`` engine. Schedules and summaries must be identical,
   and each fitmask kernel of the loop must have been launched by the
   ``cuda`` runs (K1 and K3 by every configuration, K2 by Reconfig and
   RFold).
5. Fleet main path: the same eight configurations, 3 runs x 200 jobs
   (seed0 100), through ``repro_torch.eval.EvalRunner`` as fleets
   (``workers=0``, ``fleet_size="auto"``: four fleets of six) on the
   ``cuda`` engine, where every broker multibox flush is one launch of
   the fused bucketed kernel; then as fleets of six on ``numpy`` and
   per task on ``numpy`` (timed after an untimed per-task pass, the oracle).
   Records (``sim_s`` aside) and Table 1 / Fig 3 / Fig 4 must be
   identical, the fused launch launched, the broker batching
   (``mean_grids_per_call > 1``) with no failover and no canary check.
   One more run, 1 x 60 jobs on ``cuda`` with ``workers=2`` (spawned
   workers), must give the records of the same matrix at ``workers=0``.
6. Sequence kernel phase: holds K4 (flash attention) and K5 (SSD scan)
   against their plain versions in fp32 and bf16, at the zamba2 prefill
   shapes and at edge cases (K5 with B and C per group, as the model
   hands them over), within stated tolerances, and times them beside
   their bounds, the earlier kernel's time and, for K4, PyTorch's SDPA.
7. Serve main path, zamba2-1.2b at full width (38 layers, fp32, random
   weights from seed 0): the prefill forward at B 2, S 4096 through the
   kernels (exactly 6 K4 and 38 K5 launches) against the plain path;
   128 decode steps against the prefill logits; and greedy serving
   through ``repro_torch.launch.serve`` at its default sizes.
8. Prints one JSON line per the kernel table, then the result line.

Launch counters are set to 0 just before each main path (placement,
fleet, serve) and read just after; every kernel must have been launched
on a path.

Any failure raises and exits non-zero. With no CUDA device, or without
the repository's ``src/repro_torch`` beside it, it exits non-zero and
prints no result.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet): HBM3 rate, the INT32 ALU issue
# rate (64 INT32 lanes per SM x 132 SMs x 1.98 GHz boost), fp32 on the
# CUDA cores and dense bf16 on the tensor cores.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}

# benchmarks/paper_eval.py: TABLE1_CONFIGS + FIG3_EXTRA_CONFIGS.
CONFIGS = [
    ("FirstFit (16^3)", "firstfit", dict(dims=(16, 16, 16))),
    ("Folding (16^3)", "folding", dict(dims=(16, 16, 16))),
    ("Reconfig (8^3)", "reconfig", dict(num_xpus=4096, cube_n=8)),
    ("RFold (8^3)", "rfold", dict(num_xpus=4096, cube_n=8)),
    ("Reconfig (4^3)", "reconfig", dict(num_xpus=4096, cube_n=4)),
    ("RFold (4^3)", "rfold", dict(num_xpus=4096, cube_n=4)),
    ("Reconfig (2^3)", "reconfig", dict(num_xpus=4096, cube_n=2)),
    ("RFold (2^3)", "rfold", dict(num_xpus=4096, cube_n=2)),
]
NUM_JOBS, SEED, LOAD = 200, 0, 1.5
# Fitmask kernels that no main path launches (checked and timed only).
OFF_PATH = ()
# The fleet phase: benchmarks_torch/fleet_bench.py's CI size, and the
# smaller matrix that runs again with spawned workers.
FLEET_RUNS, FLEET_JOBS, FLEET_SEED0 = 3, 200, 100
SPAWN_RUNS, SPAWN_JOBS, SPAWN_WORKERS = 1, 60, 2
# Simulators a fleet stacks on B at that size (fleet_size "auto" with 24
# tasks in four grid buckets at workers=0), for the kernel phase.
FLEET_SIZE = 6
FLEET_OF = ("static 16^3", "cubes 8^3", "cubes 4^3", "cubes 2^3")

REPLACES = {
    "fitmask_multibox": "src/repro/kernels/fitmask/kernel.py:117",
    # K1's kernel with K2's counts in the same launch (the counterpart of
    # JaxEngine._bucket_fn, src/repro/kernels/fitmask/ops.py:196)
    "fitmask_multibox_bucketed": "src/repro/kernels/fitmask/kernel.py:117",
    "fitmask_batched": "src/repro/kernels/fitmask/kernel.py:90",
    "occupancy_counts": "src/repro/kernels/fitmask/kernel.py:143",
    "flash_attention": "src/repro/kernels/flash_attention/kernel.py:107",
    "ssd_scan": "src/repro/kernels/ssd_scan/kernel.py:94",
}
SOURCE = {"fitmask_multibox": "fitmask.cu", "fitmask_batched": "fitmask.cu",
          "occupancy_counts": "fitmask.cu",
          "fitmask_multibox_bucketed": "fitmask.cu",
          "flash_attention": "flash_attention.cu", "ssd_scan": "ssd_scan.cu"}
SOURCES = tuple(dict.fromkeys(SOURCE.values()))     # in src/repro_torch/csrc

# Sequence kernels against their plain versions on the card, as
# (atol, rtol). fp32: the kernel and the plain version differ only in
# the order of fp32 sums (K5 also in the order of its prefix sum, whose
# exp() amplifies it), so agreement to 1e-5 (K4) and 1e-4 (K5, as the
# Pallas kernel's state tolerance) is expected. bf16: both round the
# same fp32 result to bf16, so they may differ by one bf16 ulp, at most
# 2^-7 (0.0078) of the value. K4's bf16 limit is that ulp (rtol 1e-2)
# plus 4e-3 for outputs near 0: at the path shape a softmax average over
# thousands of keys is only 0.02-0.04, so a looser atol would pass a
# kernel that dropped a k tile (max error measured on an H100: 0.0039).
# K5's bf16 outputs reach 8-16, where one ulp is 0.0625; 5e-2 (atol and
# rtol) is tests/test_kernels.py's bf16 tolerance.
FA_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (4e-3, 1e-2)}
SSD_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (5e-2, 5e-2)}
# zamba2-1.2b prefill: kernel path against plain path, max |d logits| <=
# LOGIT_REL * max |logits| (38 layers of fp32 sums in another order).
LOGIT_REL = 1e-3
# Decode (ssd_step recurrence, einsum attention over the cache) against
# the prefill logits: tests/test_arch_smoke.py's 2e-3, atol and rtol.
DECODE_TOL = 2e-3
PREFILL_B, PREFILL_S, DECODE_S = 2, 4096, 128


def all_shapes(n):
    return [(a, b, c) for a in range(1, n + 1) for b in range(1, n + 1)
            for c in range(1, n + 1)]


def kernel_cases(rng):
    """(label, B, (X, Y, Z), boxes, kind) at the placement loop's
    shapes, plus boxes larger than the grid, K = 0, grids up to 64^3,
    rows of 64 cells with boxes of 1, 63, 64 and 65 along z, rows whose
    length is off the 16-byte load (Z 3, 5, 13), a batch that starts one
    grid into its storage (kind ``offset``: ``occ[1:]``, not 16-byte
    aligned) and uint8 grids viewed as bool with bytes of 2 and 255
    (kind ``bytes``)."""
    s16 = all_shapes(16)
    s8 = all_shapes(8)
    pick16 = sorted(s16[i] for i in rng.choice(len(s16), 51, replace=False))
    pick8 = sorted(s8[i] for i in rng.choice(len(s8), 282, replace=False))
    return [
        ("static 16^3", 1, (16, 16, 16), pick16, ""),
        ("cubes 4^3", 64, (4, 4, 4), all_shapes(4), ""),
        ("cubes 2^3", 512, (2, 2, 2), all_shapes(2), ""),
        ("cubes 8^3", 8, (8, 8, 8), pick8, ""),
        ("oversize", 4, (4, 4, 4), [(5, 1, 1), (1, 6, 1), (1, 1, 9),
                                    (4, 4, 4), (2, 3, 4), (17, 17, 17)],
         ""),
        ("K=0", 2, (16, 16, 16), [], ""),
        ("38^3", 1, (38, 38, 38), [(1, 1, 1), (5, 7, 3), (20, 1, 37),
                                   (38, 38, 38), (39, 1, 1)], ""),
        ("64^3", 1, (64, 64, 64), [(1, 1, 1), (3, 5, 7), (64, 1, 1),
                                   (1, 1, 63), (10, 20, 65), (64, 64, 64)],
         ""),
        ("Z 64 edges", 4, (6, 5, 64), [(1, 1, 1), (2, 1, 63), (1, 2, 64),
                                       (1, 1, 65), (3, 3, 2)], ""),
        ("Z 3", 8, (7, 6, 3), all_shapes(3), ""),
        ("Z 5", 8, (5, 5, 5), all_shapes(5), ""),
        ("Z 13", 2, (9, 4, 13), [(1, 1, 1), (2, 3, 4), (9, 4, 13),
                                 (3, 2, 12), (1, 1, 14)], ""),
        ("offset Z 3", 5, (4, 3, 3), all_shapes(3), "offset"),
        ("bytes 4^3", 64, (4, 4, 4), all_shapes(4)[::3], "bytes"),
    ]


# K2 alone at one and two grids of each cube size of the placement loop
# (the dirty cubes of a reconfigurable torus): (label, B, (X, Y, Z)).
COUNT_CASES = [(f"{bsz} x {n}^3", bsz, (n, n, n))
               for n in (2, 4, 8) for bsz in (1, 2)]


def single_boxes(dims, boxes):
    """The boxes the single-box kernel is checked on in one case: the
    first candidate, the largest that fits in the grid, and one that
    overhangs it, keyed by role."""
    fits = [b for b in boxes if all(e <= d for e, d in zip(b, dims))]
    picks = {"first": boxes[0], "overhang": (2, 1, dims[2] + 1)}
    if fits:
        picks["largest"] = max(fits, key=lambda b: (b[0] * b[1] * b[2], b))
    return picks


def occupancy(rng, bsz, dims, device, kind=""):
    """Grids from empty to about 60 % occupied, one density per grid;
    kind ``offset``: a view that starts one grid into its storage;
    ``bytes``: occupied cells hold 1, 2 or 255, a uint8 tensor viewed as
    bool."""
    extra = int(kind == "offset")
    dens = rng.uniform(0.0, 0.6, size=(bsz + extra, 1, 1, 1))
    dens[0] = 0.0
    occ = rng.random((bsz + extra,) + tuple(dims)) < dens
    if kind == "bytes":
        vals = rng.choice(np.array([1, 2, 255], np.uint8), size=occ.shape)
        return torch.from_numpy(occ * vals).to(device).view(torch.bool)
    return torch.from_numpy(occ).to(device)[extra:]


def kernel_inputs(device):
    """Each case of :func:`kernel_cases` with its seeded grids on
    ``device``: (label, B, dims, boxes, occ)."""
    rng = np.random.default_rng(SEED)
    for label, bsz, dims, boxes, kind in kernel_cases(rng):
        yield label, bsz, dims, boxes, occupancy(rng, bsz, dims, device,
                                                 kind)


def count_inputs(device):
    """Each case of :data:`COUNT_CASES` with its seeded grids."""
    rng = np.random.default_rng(SEED + 1)
    for label, bsz, dims in COUNT_CASES:
        yield label, bsz, dims, occupancy(rng, bsz, dims, device)


def fleet_inputs(device):
    """The fleet broker's flush shapes: :data:`FLEET_SIZE` simulators'
    grids of each loop case in :data:`FLEET_OF` stacked on B, with that
    case's box table (the union a flush of the loop's queries asks for),
    as (label, B, dims, boxes, occ)."""
    loop = {label: (bsz, dims, boxes) for label, bsz, dims, boxes, _ in
            kernel_cases(np.random.default_rng(SEED))}
    rng = np.random.default_rng(SEED + 2)
    for name in FLEET_OF:
        bsz, dims, boxes = loop[name]
        bsz *= FLEET_SIZE
        yield (f"fleet {bsz} x {name.split()[-1]}", bsz, dims, boxes,
               occupancy(rng, bsz, dims, device))


def reps_for(fn, budget_ms=400.0):
    """Repetitions that fit one timing in about ``budget_ms`` (3 to 50),
    from one synchronised call."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    one = (time.perf_counter() - t0) * 1e3
    return int(max(3, min(50, budget_ms / max(one, 1e-3))))


def time_ms(fn, reps=50):
    """Mean time per call, by CUDA events around back-to-back calls after
    warm-up: what a caller pays, host overhead between launches included."""
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, call_ms, reps=50):
    """Mean device time per call: the calls are queued behind a spin
    kernel that outlasts their enqueueing (4x the measured call time,
    counting at most 0.5 ms a call: no wrapper spends longer on the
    host), so the card runs them back to back and host overhead is
    hidden. Only for calls that never block the host."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(int(4 * reps * min(call_ms, 0.5) * 2.0e6))  # ~2e6/ms
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes, nops, ops_per_s=INT32_OPS_PER_S):
    """Least time in ms for the work, and which side bounds it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def multibox_work(bsz, dims, boxes):
    """Bytes moved (bool grids in, box table in, int32 planes out) and
    integer operations (three prefix adds per integral-image cell, eight
    adds and a compare per in-bounds origin: the function's work as the
    reference computes it)."""
    x, y, z = dims
    cells = x * y * z
    nbytes = bsz * cells + 12 * len(boxes) + 4 * bsz * len(boxes) * cells
    inb = sum(max(x - a + 1, 0) * max(y - b + 1, 0) * max(z - c + 1, 0)
              for a, b, c in boxes)
    image = (x + 1) * (y + 1) * (z + 1)
    nops = (3 * image * bsz if boxes else 0) + 8 * bsz * inb
    return nbytes, nops


def single_box_library(occ, box):
    """One PyTorch call computing K3's function where the box fits in the
    grid: a max pool over the box is 0 exactly where the box is free
    (the origins where it fits); None where the box overhangs."""
    import torch.nn.functional as F

    if any(e > d for e, d in zip(box, occ.shape[1:])):
        return None
    return lambda: F.max_pool3d(occ.float()[:, None], box, stride=1)[:, 0] == 0


def bucketed_work(bsz, dims, boxes):
    """K1's work with the planes as bool (a byte a cell) and one int32
    count a grid out; the counts come off the integral image's corner."""
    nbytes, nops = multibox_work(bsz, dims, boxes)
    cells = dims[0] * dims[1] * dims[2]
    return nbytes - 3 * bsz * len(boxes) * cells + 4 * bsz, nops


def as_tuple(out):
    return out if isinstance(out, tuple) else (out,)


def same(got, want):
    """Bit-exact: every output of the same shape, type and values."""
    got, want = as_tuple(got), as_tuple(want)
    return len(got) == len(want) and all(
        g.shape == w.shape and g.dtype == w.dtype and torch.equal(g, w)
        for g, w in zip(got, want))


def max_abs_err(got, want):
    return max((int((g.long() - w.long()).abs().max()) if g.numel() else 0
                for g, w in zip(as_tuple(got), as_tuple(want))), default=0)


def launch_floor_ms():
    """The card's device time for one launch of an empty kernel
    (``torch.cuda._sleep(0)``), queued as :func:`device_ms` queues."""
    def fn():
        torch.cuda._sleep(0)
    return device_ms(fn, time_ms(fn))


def counts_check(kernel, occ, bsz, dims):
    cells = dims[0] * dims[1] * dims[2]
    return ("occupancy_counts", lambda: kernel.occupancy_counts(occ),
            lambda: kernel.occupancy_counts_plain(occ),
            lambda: occ.sum((1, 2, 3)), [bsz, *dims],
            (bsz * cells + 4 * bsz, bsz * cells), ("", None))


def kernel_phase(kernel, device):
    print(f"launch_floor_ms,{launch_floor_ms()}")
    rows = []
    # (label, B, dims, boxes, occ, fleet): loop cases, count cases (no
    # boxes), and the fleet's shapes (K2 and the fused launch only).
    cases = [(*case, False) for case in kernel_inputs(device)]
    cases += [(label, bsz, dims, None, occ, False) for label, bsz, dims, occ
              in count_inputs(device)]
    cases += [(*case, True) for case in fleet_inputs(device)]
    for label, bsz, dims, boxes, occ, fleet in cases:
        checks = [counts_check(kernel, occ, bsz, dims)]
        if boxes is not None and not fleet:
            checks.append(
                ("fitmask_multibox",
                 lambda: kernel.fitmask_multibox(occ, boxes),
                 lambda: kernel.fitmask_multibox_plain(occ, boxes), None,
                 [bsz, len(boxes), *dims], multibox_work(bsz, dims, boxes),
                 ("", None)))
        if boxes is not None:
            checks += [
                ("fitmask_multibox_bucketed",
                 lambda: kernel.fitmask_multibox_bucketed(occ, boxes),
                 lambda: kernel.fitmask_multibox_bucketed_plain(occ, boxes),
                 None, [bsz, len(boxes), *dims],
                 bucketed_work(bsz, dims, boxes), ("", None)),
            ]
        picks = single_boxes(dims, boxes) if boxes and not fleet else {}
        for role, box in picks.items():
            checks.append(
                ("fitmask_batched",
                 lambda box=box: kernel.fitmask_batched(occ, box),
                 lambda box=box: kernel.fitmask_batched_plain(occ, box),
                 single_box_library(occ, box), [bsz, *dims],
                 multibox_work(bsz, dims, [box]), (role, box)))
        for (name, fn, plain, library, shape, (nbytes, nops),
             (box_role, box)) in checks:
            got, want = fn(), plain()
            torch.cuda.synchronize()
            if not same(got, want):
                raise AssertionError(f"{name} on {label}: kernel differs "
                                     "from its plain version")
            if name == "fitmask_batched" and library:
                a, b, c = box
                x, y, z = dims
                if not torch.equal(library(), got[:, :x - a + 1, :y - b + 1,
                                                  :z - c + 1] == 1):
                    raise AssertionError(f"{name} on {label}: max_pool3d "
                                         "differs from the kernel's plane")
            bms, by = bound(nbytes, nops)
            call_ms = time_ms(fn)
            lib_ms = None
            if library:
                lib_ms = device_ms(library, time_ms(library))
            rows.append(dict(
                name=name, case=label, shape=shape, box_role=box_role,
                box=box,
                max_abs_err=max_abs_err(got, want),
                ms=device_ms(fn, call_ms), call_ms=call_ms,
                plain_ms=time_ms(plain), library_ms=lib_ms,
                bound_ms=bms, bound_by=by))
    print("# kernel phase (bit-exact against the plain version). ms and "
          "library_ms: device time per launch, queued; call_ms and plain_ms: "
          "time per call, back to back")
    print("kernel,case,shape,box,max_abs_err,ms,call_ms,plain_ms,library_ms,"
          "bound_ms,bound_by")
    for r in rows:
        shape = "x".join(str(d) for d in r["shape"])
        box = "" if r["box"] is None else "%s %s" % (
            r["box_role"], "x".join(str(d) for d in r["box"]))
        lib = "" if r["library_ms"] is None else r["library_ms"]
        print(f"{r['name']},{r['case']},{shape},{box},{r['max_abs_err']},"
              f"{r['ms']},{r['call_ms']},{r['plain_ms']},{lib},"
              f"{r['bound_ms']},{r['bound_by']}")
    return rows


def schedule(res):
    return [(j.job_id, j.start, j.finish, j.dropped, j.slowdown,
             j.placement_meta) for j in res.jobs]


def main_path_phase(kernel, device):
    from repro_torch.core.allocator import make_policy
    from repro_torch.core.engineconfig import EngineConfig
    from repro_torch.core.maskquery import resolve_mask_client
    from repro_torch.sim.metrics import summarize
    from repro_torch.sim.simulator import Simulator
    from repro_torch.traces.generator import TraceConfig, generate_trace

    cfg = TraceConfig(num_jobs=NUM_JOBS, seed=SEED, target_load=LOAD)
    cuda = EngineConfig("cuda", device=device)
    print("# main path: %d jobs, seed %d, target_load %s, 4096 XPUs"
          % (NUM_JOBS, SEED, LOAD))
    print("config,wall_cuda_s,query_s,wall_numpy_s,multibox_launches,"
          "batched_launches,counts_launches,jcr,util_mean")
    kernel.reset_launch_counts()
    for label, pol, kw in CONFIGS:
        before = kernel.launch_counts()
        client = resolve_mask_client(cuda)   # shared by policy and clones
        q0 = client.seconds
        t0 = time.perf_counter()
        res = Simulator(make_policy(pol, engine=cuda, **kw),
                        generate_trace(cfg)).run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        after = kernel.launch_counts()
        n = {k: after[k] - before[k] for k in after}
        t0 = time.perf_counter()
        ref = Simulator(make_policy(pol, engine="numpy", **kw),
                        generate_trace(cfg)).run()
        wall_np = time.perf_counter() - t0
        summ, summ_np = summarize(res), summarize(ref)
        # repr: a NaN percentile (no job finished) compares equal to itself
        if schedule(res) != schedule(ref) \
                or repr(sorted(summ.items())) != repr(sorted(summ_np.items())):
            raise AssertionError(f"{label}: cuda schedule differs from the "
                                 "numpy engine's")
        if n["fitmask_multibox"] == 0:
            raise AssertionError(f"{label}: fitmask_multibox never launched")
        if pol in ("reconfig", "rfold") and n["occupancy_counts"] == 0:
            raise AssertionError(f"{label}: occupancy_counts never launched")
        if not (0.0 <= summ["jcr"] <= 1.0 and np.isfinite(summ["util_mean"])):
            raise AssertionError(f"{label}: bad summary {summ}")
        print(f"{label},{wall},{client.seconds - q0},{wall_np},"
              f"{n['fitmask_multibox']},"
              f"{n['fitmask_batched']},{n['occupancy_counts']},"
              f"{summ['jcr']},{summ['util_mean']}")
    return kernel.launch_counts()


def strip_timing(records):
    """Records without ``sim_s``, as canonical JSON (a NaN percentile
    compares equal to itself)."""
    return json.dumps([{k: v for k, v in r.items() if k != "sim_s"}
                       for r in records], sort_keys=True)


def figures(records):
    """Table 1 / Fig 3 / Fig 4 of the records, as canonical JSON."""
    from repro_torch.eval import aggregate_by_label, fig3, fig4, table1

    aggs = aggregate_by_label(records)
    return json.dumps({"table1": table1(aggs), "fig3": fig3(aggs),
                       "fig4": fig4(aggs)}, sort_keys=True, default=float)


def fleet_phase(kernel, device):
    """The eval matrix through fleets on the card, against fleets and
    per-task runs on numpy; then spawned workers on the card. Returns
    the fitmask launches of the ``cuda`` fleet run."""
    from repro_torch.core.engineconfig import EngineConfig
    from repro_torch.eval import EvalRunner, aggregate_by_label, make_tasks

    cuda = EngineConfig("cuda", device=device)

    def run(cfg, tasks, workers=0):
        runner = EvalRunner(workers=workers, engine=cfg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        records = runner.run(tasks)
        torch.cuda.synchronize()
        return records, time.perf_counter() - t0, runner

    tasks = make_tasks(CONFIGS, FLEET_RUNS, FLEET_JOBS, LOAD, FLEET_SEED0)
    print("# fleet main path: %d configs x %d runs x %d jobs, seed0 %d, "
          "target_load %s, workers 0, fleet_size auto; after an untimed "
          "per-task numpy pass (the oracle, which also fills the fold and "
          "plan caches)" % (len(CONFIGS), FLEET_RUNS, FLEET_JOBS,
                            FLEET_SEED0, LOAD))
    seq = EngineConfig("numpy", fleet_size=0)
    per_task = run(seq, tasks)[0]
    kernel.reset_launch_counts()
    got, cuda_s, cuda_run = run(cuda, tasks)
    launches = kernel.launch_counts()
    np_fleet, np_fleet_s, np_run = run(
        EngineConfig("numpy", fleet_size=FLEET_SIZE), tasks)
    per_task_s = run(seq, tasks)[1]
    for name, recs in (("cuda fleet", got), ("numpy fleet", np_fleet)):
        if strip_timing(recs) != strip_timing(per_task) \
                or figures(recs) != figures(per_task):
            raise AssertionError(f"{name}: records or Table 1 / Fig 3 / "
                                 "Fig 4 differ from per-task numpy's")
    print("# park_s: seconds queries sat parked, summed over simulators; "
          "engine_s: seconds in engine calls, host copies included")
    print("fleet,engine,wall_s,fleets,size,flushes,flush_all_parked,"
          "flush_quorum,flush_timeout,requeued,engine_calls,batched_calls,"
          "mean_grids_per_call,max_grids,fc_inline,fc_cache_hits,"
          "fc_cache_misses,engine_failovers,canary_checks,park_s,engine_s,"
          "fused_launches,k2_launches,k1_launches,k3_launches")
    for name, wall, runner, n in (
            ("cuda", cuda_s, cuda_run, launches),
            ("numpy", np_fleet_s, np_run, dict.fromkeys(launches, 0))):
        fl = runner.last_stats["fleet"]
        b = fl["broker"]
        print(f"fleet,{name},{wall},{fl['fleets']},{fl['size']},"
              f"{b['flushes']},{b['flush_all_parked']},{b['flush_quorum']},"
              f"{b['flush_timeout']},{b['requeued']},{b['engine_calls']},"
              f"{b['batched_calls']},{b['mean_grids_per_call']},"
              f"{b['max_grids']},{b['fc_inline']},{b['fc_cache_hits']},"
              f"{b['fc_cache_misses']},{b['engine_failovers']},"
              f"{b['canary_checks']},{b['park_s']},{b['engine_s']},"
              f"{n['fitmask_multibox_bucketed']},"
              f"{n['occupancy_counts']},{n['fitmask_multibox']},"
              f"{n['fitmask_batched']}")
    print("fleet_walls,cuda_fleet_s,numpy_fleet_s,numpy_per_task_s,"
          "cuda_over_numpy_fleet,cuda_over_numpy_per_task")
    print(f"fleet_walls,{cuda_s},{np_fleet_s},{per_task_s},"
          f"{cuda_s / np_fleet_s},{cuda_s / per_task_s}")
    sim_cuda = aggregate_by_label(got)
    sim_np = aggregate_by_label(per_task)
    print("fleet_sim_s,config,cuda_fleet_sim_s,numpy_per_task_sim_s,jcr")
    for label, _, _ in CONFIGS:
        print(f"fleet_sim_s,{label},{sim_cuda[label]['sim_s_total']},"
              f"{sim_np[label]['sim_s_total']},"
              f"{sim_cuda[label]['agg']['jcr']}")
    b = cuda_run.last_stats["fleet"]["broker"]
    if launches["fitmask_multibox_bucketed"] == 0:
        raise AssertionError("the fleet never launched "
                             "fitmask_multibox_bucketed")
    if b["fc_cache_misses"] and launches["occupancy_counts"] == 0:
        raise AssertionError("free-count flushes launched no "
                             "occupancy_counts")
    if b["engine_failovers"] or b["canary_checks"] or b["engine_retries"]:
        raise AssertionError(f"the cuda fleet failed over: {b}")
    if not (b["batched_calls"] > 0 and b["mean_grids_per_call"] > 1):
        raise AssertionError(f"the cuda fleet did not batch: {b}")

    small = make_tasks(CONFIGS, SPAWN_RUNS, SPAWN_JOBS, LOAD, FLEET_SEED0)
    inline, inline_s, _ = run(cuda, small)
    pooled, pooled_s, pool = run(cuda, small, SPAWN_WORKERS)
    if pool.start_method() != "spawn":
        raise AssertionError("a pool on the card must spawn its workers")
    pb = pool.last_stats["fleet"]
    print("fleet_spawn,runs,jobs,workers,start_method,fleets,wall_workers_0_s,"
          f"wall_workers_{SPAWN_WORKERS}_s,engine_failovers")
    print(f"fleet_spawn,{SPAWN_RUNS},{SPAWN_JOBS},{SPAWN_WORKERS},"
          f"{pool.start_method()},{pb['fleets']},{inline_s},{pooled_s},"
          f"{pb['broker']['engine_failovers']}")
    if strip_timing(pooled) != strip_timing(inline):
        raise AssertionError("spawned workers on the card gave other "
                             "records than workers=0")
    if pb["fleets"] < 2 or pb["broker"]["engine_failovers"]:
        raise AssertionError(f"spawned fleets: {pb}")
    return launches


def build_all():
    """One nvcc process per source, all started together."""
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        built = list(pool.map(_build.build, SOURCES))
    print("# build: %.1f s for %d sources in parallel"
          % (time.perf_counter() - t0, len(SOURCES)))
    for source, (lib, log) in zip(SOURCES, built):
        print("# %s -> %s" % (source, lib))
        for line in log.splitlines():
            if any(w in line for w in ("registers", "Compiling entry",
                                       "spill")):
                print("#   " + line.strip())


# -- sequence kernels (K4, K5) -------------------------------------------

FA_CASES = [   # label, B, S, H, KH, D, window
    ("path", PREFILL_B, PREFILL_S, 32, 32, 64, 8192),
    ("gqa 32:8", 2, 2048, 32, 8, 128, None),
    ("window 64", 2, 1024, 32, 32, 64, 64),
    ("ragged S 1000", 2, 1000, 32, 32, 64, None),
]
# label, B, S, H, G (groups of B and C), P, N, chunk, with d_skip
SSD_CASES = [
    ("path", PREFILL_B, PREFILL_S, 64, 1, 64, 64, 128, True),
    ("single chunk", 2, 128, 64, 1, 64, 64, 128, True),
    ("no d_skip", 2, 1024, 64, 1, 64, 64, 128, False),
    ("8 groups", 2, 1024, 64, 8, 64, 64, 128, True),
]
# Device ms of the earlier K4 and K5 designs (fp32 FMAs for both types;
# K5 one block per head and batch) for the same (kernel, case, type), as
# PERF.md records them (NVIDIA H100 80GB HBM3, 700.00 W); None where it
# has none.
EARLIER_MS = {
    ("flash_attention", "path", "float32"): 6.184254760742188,
    ("flash_attention", "path", "bfloat16"): 6.261876220703125,
    ("flash_attention", "gqa 32:8", "float32"): 4.71387451171875,
    ("flash_attention", "gqa 32:8", "bfloat16"): 4.6134521484375,
    ("flash_attention", "window 64", "float32"): 0.11910143852233887,
    ("flash_attention", "window 64", "bfloat16"): 0.11330368041992188,
    ("flash_attention", "ragged S 1000", "float32"): 0.5162918472290039,
    ("ssd_scan", "path", "float32"): 3.2305645751953125,
    ("ssd_scan", "path", "bfloat16"): 3.2046929931640626,
    ("ssd_scan", "single chunk", "float32"): 0.10183615684509277,
    ("ssd_scan", "no d_skip", "float32"): 0.8129535675048828,
}


def attention_work(b, s, h, kh, d, window, dtype):
    """Bytes (q, k, v read once, out written once) and FLOP (2 products
    of 2 FLOP per unmasked causal (q, k) pair and head column)."""
    esz = torch.finfo(dtype).bits // 8
    w = window if window and window < s else s
    pairs = w * (w + 1) // 2 + (s - w) * w
    return esz * (2 * b * s * h * d + 2 * b * s * kh * d), 4 * b * h * d * pairs


def ssd_work(b, s, h, g, p, n, chunk, dtype, with_d):
    """Bytes (x, dt, a, d read once per head and B, C once per group; y
    and the fp32 state written once) and FLOP per chunk and head:
    Q (Q + 1) (N + P) for the causal (s <= t) half of C B^T and of the
    masked matrix times X, the only half the function needs, plus
    4 Q N P for C state^T and the state update. Counted like
    attention_work: unmasked pairs only."""
    esz = torch.finfo(dtype).bits // 8
    nbytes = (esz * b * s * (2 * h * p + 2 * g * n) + 4 * b * s * h
              + 4 * h * (2 if with_d else 1) + 4 * b * h * p * n)
    nops = ((chunk * (chunk + 1) * (n + p) + 4 * chunk * n * p)
            * b * h * (s // chunk))
    return nbytes, nops


def _time_all(fn, plain, library):
    reps = reps_for(fn)
    call_ms = time_ms(fn, reps)
    ms = device_ms(fn, call_ms, reps)
    plain_ms = time_ms(plain, reps_for(plain))
    lib_ms = None
    if library is not None:
        lreps = reps_for(library)
        lib_ms = device_ms(library, time_ms(library, lreps), lreps)
    return ms, call_ms, plain_ms, lib_ms


def seq_kernel_phase(device):
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.ssd_scan import kernel as ssd
    import torch.nn.functional as F

    gen = torch.Generator(device).manual_seed(SEED)

    def randn(shape, dtype, scale=1.0):
        return (torch.randn(shape, generator=gen, device=device) * scale
                ).to(dtype)

    def uniform(shape, lo, hi):
        return torch.rand(shape, generator=gen, device=device) * (hi - lo) + lo

    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        for label, b, s, h, kh, d, window in FA_CASES:
            q = randn((b, s, h, d), dtype)
            k, v = randn((b, s, kh, d), dtype), randn((b, s, kh, d), dtype)
            fn = lambda: fa.flash_attention(q, k, v, True, window)  # noqa: E731
            plain = lambda: fa.flash_attention_plain(q, k, v, True, window)  # noqa: E731
            got, want = fn(), plain()
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            atol, rtol = FA_TOL[dtype]
            torch.testing.assert_close(
                got.float(), want.float(), rtol=rtol, atol=atol,
                msg=lambda m: f"flash_attention {label} {dtype}: kernel "
                f"differs from its plain version: {m}")
            del got, want
            library = None
            if window is None or window >= s:    # SDPA has no window
                qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
                library = lambda: F.scaled_dot_product_attention(  # noqa: E731
                    qt, kt, vt, is_causal=True, enable_gqa=kh < h)
            ms, call_ms, plain_ms, lib_ms = _time_all(fn, plain, library)
            nbytes, nops = attention_work(b, s, h, kh, d, window, dtype)
            bms, by = bound(nbytes, nops, PEAK_FLOPS[dtype])
            rows.append(dict(
                name="flash_attention", case=label, dtype=str(dtype)[6:],
                shape=[b, s, h, kh, d], window=window, max_abs_err=err,
                tol="%g/%g" % FA_TOL[dtype], ms=ms, call_ms=call_ms,
                plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bms,
                bound_by=by))
            del q, k, v, fn, plain, library
        for label, b, s, h, g, p, n, chunk, with_d in SSD_CASES:
            x = randn((b, s, h, p), dtype)
            dt = uniform((b, s, h), 0.01, 0.2)
            a = -uniform((h,), 0.5, 2.0)
            bm, cm = randn((b, s, g, n), dtype), randn((b, s, g, n), dtype)
            dsk = randn((h,), torch.float32) if with_d else None
            fn = lambda: ssd.ssd_scan(x, dt, a, bm, cm, chunk, dsk)  # noqa: E731
            plain = lambda: ssd.ssd_scan_plain(x, dt, a, bm, cm, chunk, dsk)  # noqa: E731
            (y, st), (y0, st0) = fn(), plain()
            torch.cuda.synchronize()
            err = float((y.float() - y0.float()).abs().max())
            state_err = float((st - st0).abs().max())
            atol, rtol = SSD_TOL[dtype]
            torch.testing.assert_close(
                y.float(), y0.float(), rtol=rtol, atol=atol,
                msg=lambda m: f"ssd_scan {label} {dtype}: y differs from "
                f"the plain version's: {m}")
            if dtype == torch.float32:
                torch.testing.assert_close(
                    st, st0, rtol=rtol, atol=atol,
                    msg=lambda m: f"ssd_scan {label}: final state differs "
                    f"from the plain version's: {m}")
            del y, st, y0, st0
            ms, call_ms, plain_ms, _ = _time_all(fn, plain, None)
            nbytes, nops = ssd_work(b, s, h, g, p, n, chunk, dtype, with_d)
            bms, by = bound(nbytes, nops, PEAK_FLOPS[dtype])
            rows.append(dict(
                name="ssd_scan", case=label, dtype=str(dtype)[6:],
                shape=[b, s, h, g, p, n, chunk], window=None, max_abs_err=err,
                state_err=state_err, tol="%g/%g" % SSD_TOL[dtype], ms=ms,
                call_ms=call_ms, plain_ms=plain_ms, library_ms=None,
                bound_ms=bms, bound_by=by))
            del x, dt, a, bm, cm, dsk, fn, plain
        torch.cuda.empty_cache()
    print("# sequence kernel phase (against the plain version, tol = "
          "atol/rtol). ms and library_ms: device time per launch, queued; "
          "call_ms and plain_ms: time per call, back to back. library: "
          "F.scaled_dot_product_attention(is_causal=True) on (B, H, S, D)")
    print("kernel,case,dtype,shape,window,max_abs_err,state_err,tol,ms,"
          "call_ms,plain_ms,library_ms,bound_ms,bound_by")
    for r in rows:
        shape = "x".join(str(v) for v in r["shape"])
        lib = "" if r["library_ms"] is None else r["library_ms"]
        before = EARLIER_MS.get((r["name"], r["case"], r["dtype"]))
        print(f"# earlier kernel, same case: "
              f"{'not recorded' if before is None else f'{before} ms'}")
        print(f"{r['name']},{r['case']},{r['dtype']},{shape},"
              f"{r['window'] or ''},{r['max_abs_err']},"
              f"{r.get('state_err', '')},{r['tol']},{r['ms']},{r['call_ms']},"
              f"{r['plain_ms']},{lib},{r['bound_ms']},{r['bound_by']}")
    return rows


# -- serve main path: zamba2-1.2b at full width ---------------------------

def matmul_flop(cfg, tokens):
    """FLOP of the weight products one forward does (2 per weight element
    per token): Mamba2's in and out projections in every layer, the
    shared block's attention and FFN projections once per group, and
    the LM head. Attention's own products are K4's."""
    from repro_torch.models import model as lm
    from repro_torch.models.ssm import mamba_dims

    di, h, n, g = mamba_dims(cfg)
    d = cfg.d_model
    mamba = d * (2 * di + 2 * g * n + h) + di * d
    shared = (d * cfg.head_dim * (2 * cfg.n_heads + 2 * cfg.n_kv_heads)
              + 3 * d * cfg.d_ff)
    groups = sum(sg.count for sg in lm.layer_plan(cfg)
                 if sg.kind == "hybrid_group")
    return 2 * tokens * (cfg.n_layers * mamba + groups * shared
                         + d * cfg.vocab_size)


def profile_prefill(fn, mm_flop):
    """Device time of one prefill by kernel (torch.profiler's CUDA
    events): the share of the wall time the card was busy, the time in
    K4, K5, matrix products (and their fp32 rate, from ``mm_flop``) and
    the rest, and the ten costliest kernels."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [(e.key, e.count, e.self_device_time_total / 1e3)
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    if not kernels:
        print("# prefill profile: no device time in the trace: not measured")
        return
    groups = {"flash_attention": 0.0, "ssd_scan": 0.0, "matmul": 0.0,
              "other": 0.0}
    for name, _, ms in kernels:
        if "flash_attention_kernel" in name:
            groups["flash_attention"] += ms
        elif "ssd_scan_kernel" in name:
            groups["ssd_scan"] += ms
        elif any(w in name.lower() for w in ("gemm", "cutlass", "cublas")):
            groups["matmul"] += ms
        else:
            groups["other"] += ms
    busy = sum(groups.values())
    print("# prefill profile (torch.profiler, one kernel-path prefill; "
          "wall includes the profiler's overhead)")
    mm_rate = mm_flop / (groups["matmul"] * 1e-3) if groups["matmul"] else 0.0
    print("profile,wall_ms,device_busy_ms,busy_share,"
          + ",".join(f"{k}_ms" for k in groups)
          + ",matmul_tflop,matmul_tflop_per_s,matmul_share_of_fp32_peak")
    print(f"profile,{wall * 1e3},{busy},{busy / (wall * 1e3)},"
          + ",".join(str(v) for v in groups.values())
          + f",{mm_flop / 1e12},{mm_rate / 1e12},"
          f"{mm_rate / PEAK_FLOPS[torch.float32]}")
    for name, count, ms in sorted(kernels, key=lambda k: -k[2])[:10]:
        print(f"profile_kernel,{ms},{count},{name[:100]}")


def serve_phase(device):
    import contextlib
    import io

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.ssd_scan import kernel as ssd
    from repro_torch.launch import serve
    from repro_torch.models import model as lm
    from repro_torch.serve import engine

    def counts():
        return {**fa.launch_counts(), **ssd.launch_counts()}

    def reset():
        fa.reset_launch_counts()
        ssd.reset_launch_counts()

    cfg = get_config("zamba2-1.2b").replace(dtype="float32")
    params = lm.init_model(cfg, torch.Generator(device).manual_seed(SEED),
                           device)
    n_params = []
    lm.tree_map(lambda t: n_params.append(t.numel()), params)
    toks = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (PREFILL_B, PREFILL_S))).to(device)
    print("# serve: zamba2-1.2b, %d layers, d_model %d, %d parameters "
          "(fp32), plan %s" % (cfg.n_layers, cfg.d_model, sum(n_params),
                               [(sg.kind, sg.count) for sg in
                                lm.layer_plan(cfg)]))

    def prefill(use_kernel, tokens, c=cfg):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        logits, _ = lm.forward(c, params, {"tokens": tokens},
                               use_kernel=use_kernel)
        torch.cuda.synchronize()
        return (logits, time.perf_counter() - t0,
                torch.cuda.max_memory_allocated())

    # One K4 launch per hybrid group (6), one K5 launch per layer (38).
    want = {"flash_attention": sum(sg.count for sg in lm.layer_plan(cfg)
                                   if sg.kind == "hybrid_group"),
            "ssd_scan": cfg.n_layers}
    reset()
    fast, wall_k, peak_k = prefill(True, toks)
    launches = counts()
    if launches != want:
        raise AssertionError(f"prefill launched {launches}; expected {want}")
    reset()
    slow, wall_p, peak_p = prefill(False, toks)
    if any(counts().values()):
        raise AssertionError(f"the plain prefill launched {counts()}")
    want_shape = (PREFILL_B, PREFILL_S, cfg.vocab_size)
    for name, lg in (("kernel", fast), ("plain", slow)):
        if tuple(lg.shape) != want_shape or not bool(torch.isfinite(lg).all()):
            raise AssertionError(f"{name} prefill logits: shape "
                                 f"{tuple(lg.shape)} or not finite")
    diff = float((fast - slow).abs().max())
    scale = float(slow.abs().max())
    del fast, slow
    # A second pair in the other order: the first calls above also pay
    # the allocator's growth and the libraries' first-use set-up.
    wall_p2 = prefill(False, toks)[1]
    wall_k2 = prefill(True, toks)[1]
    print("prefill,B,S,wall_kernel_s,wall_plain_s,wall_plain_2nd_s,"
          "wall_kernel_2nd_s,peak_kernel_bytes,peak_plain_bytes,"
          "max_abs_dlogit,max_abs_logit,limit")
    print(f"prefill,{PREFILL_B},{PREFILL_S},{wall_k},{wall_p},{wall_p2},"
          f"{wall_k2},{peak_k},{peak_p},{diff},{scale},{LOGIT_REL * scale}")
    if not diff <= LOGIT_REL * scale:
        raise AssertionError(f"prefill logits: kernel path differs from the "
                             f"plain path by {diff} > {LOGIT_REL} * {scale}")
    profile_prefill(lambda: lm.forward(cfg, params, {"tokens": toks},
                                       use_kernel=True),
                    matmul_flop(cfg, PREFILL_B * PREFILL_S))

    # Decode reads the prompt one token at a time; it must reproduce the
    # prefill's logits (tests/test_arch_smoke.py, with no window).
    dcfg = cfg.replace(sliding_window=0)
    dtoks = toks[:, :DECODE_S]
    full, wall_f, _ = prefill(True, dtoks, dcfg)
    state = engine.init_state(dcfg, PREFILL_B, window=DECODE_S, device=device)
    outs = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(DECODE_S):
        pos = torch.full((PREFILL_B, 1), t, dtype=torch.int32, device=device)
        lg, state = engine.serve_step(dcfg, params, state,
                                      {"tokens": dtoks[:, t:t + 1],
                                       "positions": pos})
        outs.append(lg[:, 0])
    torch.cuda.synchronize()
    wall_d = time.perf_counter() - t0
    dec = torch.stack(outs, 1)
    derr = float((dec - full).abs().max())
    print("decode_vs_prefill,B,S,wall_prefill_s,wall_decode_s,"
          "max_abs_dlogit,tol")
    print(f"decode_vs_prefill,{PREFILL_B},{DECODE_S},{wall_f},{wall_d},"
          f"{derr},{DECODE_TOL}")
    torch.testing.assert_close(
        dec, full, rtol=DECODE_TOL, atol=DECODE_TOL,
        msg=lambda m: f"decode logits differ from prefill logits: {m}")
    del params, state, outs, dec, full, toks, dtoks
    torch.cuda.empty_cache()

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        serve.main(["--arch", "zamba2-1.2b", "--batch", "4",
                    "--prompt-len", "16", "--gen", "16"])
    line = out.getvalue().strip().splitlines()[-1]
    print("# greedy serving, repro_torch.launch.serve at its defaults")
    print(line)
    if json.loads(line)["output_shape"] != [4, 32]:
        raise AssertionError(f"greedy serving returned {line}")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    src = os.path.join(ROOT, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 1
    sys.path.insert(0, src)
    from repro_torch.kernels.fitmask import kernel

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True, check=True)
    print(smi.stdout.strip())
    device = torch.device("cuda")
    print("torch %s, CUDA %s, %s" % (torch.__version__, torch.version.cuda,
                                    torch.cuda.get_device_name(0)))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("# numerics: torch.backends.cuda.matmul.allow_tf32 = %s, "
          "torch.backends.cudnn.allow_tf32 = %s"
          % (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32))

    t_start = time.perf_counter()
    build_all()
    phase_s = {}
    t0 = time.perf_counter()
    rows = kernel_phase(kernel, device)
    phase_s["fitmask kernels"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    placement = main_path_phase(kernel, device)
    phase_s["placement main path"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    fleet = fleet_phase(kernel, device)
    phase_s["fleet main path"] = time.perf_counter() - t0
    by_path = {name: {"placement": placement[name], "fleet": fleet[name]}
               for name in placement}
    launches = {name: sum(n.values()) for name, n in by_path.items()}
    for name, count in launches.items():
        if count == 0 and name not in OFF_PATH:
            raise AssertionError(f"{name} never launched on a main path")
    t0 = time.perf_counter()
    rows += seq_kernel_phase(device)
    phase_s["sequence kernels"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    launches.update(serve_phase(device))
    phase_s["serve main path"] = time.perf_counter() - t0
    print("# phase seconds: %s; total %.1f s" % (
        ", ".join(f"{k} {v:.1f}" for k, v in phase_s.items()),
        time.perf_counter() - t_start))

    # One entry per kernel, at its heaviest main-path case above (the
    # single-box kernel: its largest in-grid box there; the fused launch:
    # a fleet of six's 8^3 flush; K4 and K5: the zamba2 prefill shape in
    # fp32, the type the serve path runs).
    heaviest = {"fitmask_multibox": ("cubes 8^3", "box_role", ""),
                "fitmask_batched": ("static 16^3", "box_role", "largest"),
                "occupancy_counts": ("cubes 4^3", "box_role", ""),
                "fitmask_multibox_bucketed": ("fleet 48 x 8^3", "box_role",
                                              ""),
                "flash_attention": ("path", "dtype", "float32"),
                "ssd_scan": ("path", "dtype", "float32")}
    entries = []
    for name, (case, key, value) in heaviest.items():
        r = next(r for r in rows if r["name"] == name and r["case"] == case
                 and r[key] == value)
        entries.append(dict(
            name=name, route="cuda", source="src/repro_torch/csrc/"
            + SOURCE[name], replaces=REPLACES[name],
            launches=launches[name],
            launches_by_path=by_path.get(name, {"serve": launches[name]}),
            max_abs_err=r["max_abs_err"],
            ms=r["ms"], call_ms=r["call_ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"],
            shape=r["shape"]))
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
