#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; needs one card

1. Prints the card's name and power limit (``nvidia-smi``).
2. Builds the CUDA fitmask kernels from ``src/repro_torch/csrc`` (nvcc,
   sm_90a).
3. Kernel phase: holds each kernel bit-exact against its plain PyTorch
   version on the card, at the shapes the placement loop gives it, and
   times both beside the least time the card could take (its bound).
4. Main-path phase: runs the eight Table 1 / Fig 3 placement
   configurations at 4096 XPUs on the 200-job trace (seed 0,
   ``target_load=1.5``) through the ``cuda`` engine, and again through
   the host ``numpy`` engine. Schedules and summaries must be identical,
   and each kernel must have been launched by the ``cuda`` runs.
5. Prints one JSON line per the kernel table, then the result line.

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

# H100 SXM peaks (NVIDIA data sheet): HBM3 rate, and the INT32 ALU
# issue rate (64 INT32 lanes per SM x 132 SMs x 1.98 GHz boost).
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9

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

REPLACES = {
    "fitmask_multibox": "src/repro/kernels/fitmask/kernel.py:117",
    "fitmask_batched": "src/repro/kernels/fitmask/kernel.py:90",
    "occupancy_counts": "src/repro/kernels/fitmask/kernel.py:143",
}
SOURCE = "src/repro_torch/csrc/fitmask.cu"


def all_shapes(n):
    return [(a, b, c) for a in range(1, n + 1) for b in range(1, n + 1)
            for c in range(1, n + 1)]


def kernel_cases(rng):
    """(label, B, n, boxes) at the placement loop's shapes, plus boxes
    larger than the grid and K = 0."""
    s16 = all_shapes(16)
    s8 = all_shapes(8)
    pick16 = sorted(s16[i] for i in rng.choice(len(s16), 51, replace=False))
    pick8 = sorted(s8[i] for i in rng.choice(len(s8), 282, replace=False))
    return [
        ("static 16^3", 1, 16, pick16),
        ("cubes 4^3", 64, 4, all_shapes(4)),
        ("cubes 2^3", 512, 2, all_shapes(2)),
        ("cubes 8^3", 8, 8, pick8),
        ("oversize", 4, 4, [(5, 1, 1), (1, 6, 1), (1, 1, 9), (4, 4, 4),
                            (2, 3, 4), (17, 17, 17)]),
        ("K=0", 2, 16, []),
    ]


def single_boxes(n, boxes):
    """The boxes the single-box kernel is checked on in one case: the
    first candidate, the largest that fits in the grid, and one that
    overhangs it, keyed by role."""
    fits = [b for b in boxes if max(b) <= n]
    picks = {"first": boxes[0], "overhang": (2, 1, n + 1)}
    if fits:
        picks["largest"] = max(fits, key=lambda b: (b[0] * b[1] * b[2], b))
    return picks


def occupancy(rng, bsz, n, device):
    """Grids from empty to about 60 % occupied, one density per grid."""
    dens = rng.uniform(0.0, 0.6, size=(bsz, 1, 1, 1))
    dens[0] = 0.0
    occ = rng.random((bsz, n, n, n)) < dens
    return torch.from_numpy(occ).to(device)


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
    kernel that outlasts their enqueueing (4x the measured call time), so
    the card runs them back to back and host overhead is hidden. Only for
    calls that never block the host."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(int(4 * reps * call_ms * 2.0e6))   # ~2e6 cycles/ms
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes, nops):
    """Least time in ms for the work, and which side bounds it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def multibox_work(bsz, n, boxes):
    """Bytes moved (bool grids in, box table in, int32 planes out) and
    integer operations (three prefix adds per image cell, eight adds and
    a compare per in-bounds origin)."""
    cells = n ** 3
    nbytes = bsz * cells + 12 * len(boxes) + 4 * bsz * len(boxes) * cells
    inb = sum(max(n - a + 1, 0) * max(n - b + 1, 0) * max(n - c + 1, 0)
              for a, b, c in boxes)
    nops = (3 * (n + 1) ** 3 * bsz if boxes else 0) + 8 * bsz * inb
    return nbytes, nops


def max_abs_err(got, want):
    if got.numel() == 0:
        return 0
    return int((got.long() - want.long()).abs().max())


def kernel_phase(kernel, device):
    rng = np.random.default_rng(SEED)
    rows = []
    for label, bsz, n, boxes in kernel_cases(rng):
        occ = occupancy(rng, bsz, n, device)
        checks = [
            ("fitmask_multibox", lambda: kernel.fitmask_multibox(occ, boxes),
             lambda: kernel.fitmask_multibox_plain(occ, boxes), None,
             [bsz, len(boxes), n, n, n], multibox_work(bsz, n, boxes),
             ("", None)),
            ("occupancy_counts", lambda: kernel.occupancy_counts(occ),
             lambda: kernel.occupancy_counts_plain(occ),
             lambda: occ.sum((1, 2, 3)), [bsz, n, n, n],
             (bsz * n ** 3 + 4 * bsz, bsz * n ** 3), ("", None)),
        ]
        for role, box in (single_boxes(n, boxes) if boxes else {}).items():
            checks.append(
                ("fitmask_batched",
                 lambda box=box: kernel.fitmask_batched(occ, box),
                 lambda box=box: kernel.fitmask_batched_plain(occ, box),
                 None, [bsz, n, n, n], multibox_work(bsz, n, [box]),
                 (role, box)))
        for (name, fn, plain, library, shape, (nbytes, nops),
             (box_role, box)) in checks:
            got, want = fn(), plain()
            torch.cuda.synchronize()
            if got.shape != want.shape or got.dtype != want.dtype \
                    or not torch.equal(got, want):
                raise AssertionError(f"{name} on {label}: kernel differs "
                                     "from its plain version")
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
    totals = kernel.launch_counts()
    for name, count in totals.items():
        if count == 0:
            raise AssertionError(f"{name} never launched on the main path")
    return totals


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

    t0 = time.perf_counter()
    lib, log = kernel.build()
    print("# build: %.1f s -> %s" % (time.perf_counter() - t0, lib))
    for line in log.splitlines():
        if "registers" in line or "Compiling entry" in line:
            print("#   " + line.strip())

    rows = kernel_phase(kernel, device)
    launches = main_path_phase(kernel, device)

    # One entry per kernel, at its heaviest main-path case above (the
    # single-box kernel: its largest in-grid box there).
    heaviest = {"fitmask_multibox": ("cubes 8^3", ""), "fitmask_batched":
                ("static 16^3", "largest"), "occupancy_counts": ("cubes 4^3", "")}
    entries = []
    for name, (case, role) in heaviest.items():
        r = next(r for r in rows if r["name"] == name and r["case"] == case
                 and r["box_role"] == role)
        entries.append(dict(
            name=name, route="cuda", source=SOURCE, replaces=REPLACES[name],
            launches=launches[name], max_abs_err=r["max_abs_err"],
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
