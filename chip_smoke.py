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
   48 x 8^3, 384 x 4^3, 3072 x 2^3) with the loop's box tables. The
   single-pass baseline (K launches of K3, stacked) is held bit-exact
   against K1 and its plain version at 16^3, B 8, K 4 and timed there.
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
6. Scenario main path: the same eight configurations, 1 run x 200 jobs
   (seed0 100), under each of the five named chaos scenarios
   (``repro_torch.sim.scenarios``: healthy, node_churn, ocs_degraded,
   bursty, multi_tenant) through ``EvalRunner`` at ``workers=0``: as
   fleets on ``cuda`` (``fleet_size="auto"``), per task on ``cuda`` and
   per task on ``numpy`` (first, and again last). Records (``sim_s``
   aside, chaos blocks included) must be identical across them; healthy's summaries
   must equal the scenario-free records'; node_churn, ocs_degraded and
   multi_tenant must inject faults into every task and account for
   every victim (migrated, preempted or killed; node_churn: none killed,
   every fault repaired); the fused, K1, K2 and K3 launches must be
   > 0, with no retry, failover or canary check. Then
   ``benchmarks_torch/chaos_bench.py``'s matrix (5 scenarios x 5
   policies at 512 XPUs, 120 jobs, each cell twice) on ``cuda`` against
   ``numpy``: identical cells, deterministic, headline held. Last, the
   kill arm: the eight configurations, 1 run x 200 jobs (seed0 100),
   under node_churn with fail-stop faults (``sim_kw={"fault_mode":
   "kill"}``) as ``cuda`` fleets, ``cuda`` per task and ``numpy`` per
   task: records with chaos blocks identical, a job killed, every victim
   killed (none preempted or migrated), ``num_dropped >= killed``, and
   the fused, K1 and K2 launches > 0 (``scenario_kill`` line).
7. Service main path: ``benchmarks_torch/crash_loop.py``'s op stream
   (the node_churn trace's submits, a ``done`` after every 3rd submit,
   the scenario's fault/repair schedule; 200 jobs, seed 17) at 4096
   XPUs, replayed over TCP against a ``repro_torch.serve.scheduler``
   daemon on ``cuda`` and in process against a core on ``numpy``, for
   RFold in 4^3 cubes and FirstFit on a static 16^3 torus: after every
   op the replies and state digests must be equal. Then the RFold
   stream through a daemon sharing a ``cuda`` ``QueryBroker`` (drain
   mode): its digest equals the plain daemon's, fused launches and
   broker requests > 0, no failover. Then the crash drill at that size
   (5 kills: final digest and journal length equal the control run's,
   every resend a no-op, a dedup hit), ``failover_drill.py --quick``
   (a subprocess primary on ``cuda`` killed with SIGKILL, the standby
   promoted and digest-identical, the restarted primary fenced), and
   ``service_bench.py``'s quick sections: parity of five policies
   through ``RemotePolicy`` and admission as checks; submit latency at
   4096 XPUs, remote against in process, printed beside the card's name
   and power limit and gated on nothing. K1, K2, K3 and the fused
   launch must each have launched in the phase.
8. Sequence kernel phase: holds K4 (flash attention) and K5 (SSD scan)
   against their plain versions in fp32 and bf16, at the zamba2 prefill
   shapes, at each dense-stack family's head layout (llama3-8b 32:8 at
   B 2 x S 4096; phi4-mini 24:8, olmo-1b 16:16, qwen1.5-110b 64:8,
   qwen2-vl-7b 28:4 and musicgen 24:24 at B 1 x S 2048), at
   llama4-scout's 40:8 (B 1 x S 2048) and at edge
   cases (K5 with B and C per group, as the model hands them over),
   within stated tolerances, and times them beside their bounds, the
   earlier kernel's time and, for K4, PyTorch's SDPA.
9. Serve main paths, zamba2-1.2b and then llama3-8b at full width and
   depth (38 and 32 layers, fp32, random weights from seed 0), one model
   on the card at a time: the prefill forward at B 2, S 4096 through the
   kernels (exactly 6 K4 and 38 K5 launches for zamba2, 32 K4 for
   llama3-8b) against the plain path, in both orders, with wall and peak
   memory; a torch.profiler profile of one kernel-path prefill; 128
   decode steps against the prefill logits; and greedy serving through
   ``repro_torch.launch.serve --arch <model>`` at its defaults.
10. Family sweep at full width, one family at a time: phi4-mini-3.8b,
   olmo-1b, qwen2-vl-7b (arange positions broadcast to 3 and 64 patch
   embeddings spliced over the first positions), musicgen-medium (four
   codebooks) and qwen1.5-110b cut to 2 of its 80 layers (its fp32
   weights do not fit one card): the prefill at B 1, S 2048 with exactly
   n_layers K4 launches against the plain path, and 16 decode steps
   against the prefill (musicgen's decode adds the sinusoidal position
   of 0 to every token, as the reference's does, so its drift is
   printed, not checked).
11. MoE phase at full width, one model at a time: llama4-scout-17b-a16e
   cut to 4 of its 48 layers (GQA 40:8 on K4, top-1 sigmoid routing
   over 16 experts, per-row dispatch) and deepseek-v2-236b cut to 3 of
   60 (the dense first layer and 2 MoE layers of 160 experts; MLA, no
   kernel). The prefill pair at B 1 x S 2048 (exactly 4 and 0 K4
   launches), each layer's expert ids recorded on both paths: the
   (token, layer) choices that differ are printed and must stay under
   0.1 %, and the logits are held to LOGIT_REL up to the first token
   whose routing differs. A profile of the kernel-path prefill, two
   identical kernel-path forwards bit for bit, 16 decode steps against
   the prefill at drop-free capacity (deepseek-v2: naive and absorbed
   MLA decode, each against the prefill and against each other),
   greedy serving through ``engine.greedy_decode`` on the cut model
   (B 4, 16 + 16 tokens) and ``repro_torch.launch.serve --arch <model>
   --smoke`` on the card.
12. xLSTM phase: xlstm-1.3b at full width and depth (48 layers: 6
   groups of one sLSTM and seven mLSTM layers; fp32, random weights from
   seed 0), alone on the card. The prefill pair at B 1 x S 2048 (no
   kernel on this family: exactly 0 K4 and 0 K5 launches), the
   kernel-path and plain forwards bit for bit, wall and peak memory, the
   prefill's wall split between the sLSTM layers (the loop over S), the
   mLSTM parallel forms and the rest (CUDA events), a torch.profiler
   profile of one group of 8 layers with the embedding and head (GEMMs,
   the device's busy share), 16 decode steps against the
   prefill within DECODE_TOL, and greedy serving through
   ``repro_torch.launch.serve --arch xlstm-1.3b`` at its defaults.
13. Training phase: ``repro_torch.launch.train --arch olmo-1b --steps 10
   --batch 2 --seq 2048`` at full width and depth on the card (the plain
   path, as repro trains; 0 K4 launches), each step timed: CE must fall;
   s a step over steps 2-10, tokens/s, peak memory and the model-FLOP
   rate against the fp32 peak are printed. Then one smoke train step of
   olmo-1b and of xlstm-1.3b on the card against the same step on the
   CPU (the loss; the grads within rtol 1e-4 and 1e-4 of each leaf's
   largest grad; AdamW from the same grads within 1e-6),
   ``train_step_accum`` with two micro-batches against the full batch,
   a checkpoint saved and loaded on the card bit for bit, and
   ``train_step(use_kernel=True)`` refused (K4 has no backward).
14. Mesh training phase: the same ``launch.train`` run with ``--mesh
   1x1`` (a process group of one rank that the launcher starts, NCCL;
   params and batches as DTensors; 0 K4 launches): its CE history
   within 1e-5 relative of the unmeshed run's, s a step, tokens/s and
   peak memory printed beside the unmeshed run's.
15. Cluster phase (a main path of K1, K2 and K3): ``RFoldCluster(64,
   cube_n=2)`` on the ``cuda`` engine places the reference's five archs
   as 1-XPU jobs, all five held at once, and each trains 3 smoke steps
   on its 1x1 mesh on the card; the placements equal a ``numpy``-engine
   cluster's and the losses the same steps' on the CPU (1e-4 relative);
   utilization returns to 0; K2 and K1 + K3 launched. Then ``python -m
   repro_torch.launch.cluster --jobs 5 --steps 3`` exits 0 (on one card
   every job is larger than the group: the reference's "skipped" lines).
16. Dry-run phase, on the host (a fake process group of 256 ranks,
   tensors without storage; the card's memory must not grow):
   ``repro_torch.launch.dryrun`` for olmo-1b train_4k with probes and
   zamba2-1.2b decode_32k without, and ``repro_torch.launch.perf`` for
   olmo-1b train_4k (baseline, remat_full, no_fsdp): per-chip FLOPs > 0,
   256 x them within 10 % of one rank's count of the same step, the
   probes' extrapolation equal to the full-depth count, remat_full's
   FLOPs 20-45 % above baseline's, no_fsdp's collective bytes below
   baseline's.
17. Bench phase, the main path's benches of ``benchmarks_torch/`` on the
   card against the host: ``allocator_bench.py --job-scales 80`` with
   its naive anchor on ``cuda`` and on ``numpy`` (placements and JCR of
   every policy and of the anchor identical; K1, K2 and K3 launched by
   the ``cuda`` run; a ``bench_alloc`` line per engine with each
   policy's placements a second); ``reconfig_bench.py --quick`` on both
   (JCR batched = naive, the bench's own assert, and placements and JCR
   equal across the engines; the headline must pass on ``numpy``, the
   reference CI gate's claim; on ``cuda`` its speedups and ``pass`` are
   printed, not gated: ``bench_reconfig`` lines); ``beyond.py --runs 1
   --num-jobs 200`` on both (the four variants' aggregates identical);
   ``kernels_bench.py`` on the card (each sibling row held against its
   plain row by the bench; every row printed); and ``roofline.py`` and
   ``report.py`` on the dry-run phase's JSONs: the olmo-1b train_4k row's
   terms must equal the JSON's ``probes.extrapolated`` counts over
   ``repro_torch.launch.perf``'s H100 constants, printed beside the
   ``perf`` baseline's terms (``roofline`` lines), then the report's
   roofline table.
18. The single-pass baseline's path: ``benchmarks_torch/fitmask_bench.py``'s
   single-pass section at its headline cell (16^3, B 8, K 4).
19. Prints one JSON line per the kernel table (K4's launches by served
   model; the benches' launches under ``benches`` and ``kernels_bench``),
   then the result line.

Launch counters are set to 0 just before each main path (placement,
fleet, each run of the scenario path, service, each model's kernel-path
prefill, the training runs, the cluster, each bench's ``cuda`` run, the
bench's single-pass section) and read just after; every kernel must have
been launched on a path, and none on the xLSTM prefill or the training
runs.

Any failure raises and exits non-zero. With no CUDA device, or without
the repository's ``src/repro_torch`` beside it, it exits non-zero and
prints no result.
"""
from __future__ import annotations

import contextlib
import json
import os
import shutil
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
# The scenario phase: the fleet phase's configurations and seed0 under
# each named chaos scenario, and chaos_bench's matrix at its default
# size (120-job cells).
SCENARIO_RUNS, SCENARIO_JOBS = 1, 200
CHAOS_BENCH_JOBS, CHAOS_BENCH_SEED = 120, 0
# The service phase: crash_loop.py's node_churn op stream at the paper's
# cluster size (RFold, 4096 XPUs in 4^3 cubes; FirstFit on a static 16^3
# torus), its crash drill at that size, failover_drill.py --quick, and
# service_bench.py's --quick sections (latency at 4096 XPUs).
SERVICE_JOBS, SERVICE_SEED, SERVICE_XPUS, SERVICE_KILLS = 200, 17, 4096, 5
SERVICE_STATIC = dict(dims=(16, 16, 16))
FAILOVER_JOBS, FAILOVER_ACK_N = 36, 20
BENCH_PARITY_JOBS, BENCH_LATENCY_JOBS, BENCH_FLOOD = 50, 150, 40
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
    # K launches of K3 (src/repro/kernels/fitmask/kernel.py:90), stacked
    "fitmask_multibox_singlepass_baseline":
        "src/repro/kernels/fitmask/kernel.py:154",
}
SOURCE = {"fitmask_multibox": "fitmask.cu", "fitmask_batched": "fitmask.cu",
          "occupancy_counts": "fitmask.cu",
          "fitmask_multibox_bucketed": "fitmask.cu",
          "fitmask_multibox_singlepass_baseline": "fitmask.cu",
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
# Prefill: kernel path against plain path, max |d logits| <= LOGIT_REL *
# max |logits| (up to 48 layers of fp32 sums in another order).
LOGIT_REL = 1e-3
# Decode (ssd_step recurrence, einsum attention over the cache) against
# the prefill logits: tests/test_arch_smoke.py's 2e-3, atol and rtol.
DECODE_TOL = 2e-3
# The served models (zamba2-1.2b, llama3-8b) at full width and depth.
SERVED = ("zamba2-1.2b", "llama3-8b")
PREFILL_B, PREFILL_S, DECODE_S = 2, 4096, 128
# The family sweep: the other families on the dense stack at full width,
# (arch, layers run; None: all). qwen1.5-110b's 80 layers (445 GB of fp32
# weights) do not fit one card.
SWEEP = (("phi4-mini-3.8b", None), ("olmo-1b", None), ("qwen2-vl-7b", None),
         ("musicgen-medium", None), ("qwen1.5-110b", 2))
SWEEP_B, SWEEP_S, SWEEP_DECODE, SWEEP_PATCHES = 1, 2048, 16, 64
# The MoE phase: (arch, layers run) at full width. fp32 weights of a
# full-depth model do not fit one card: llama4-scout 8.3 GB of embedding
# and head plus 8.8 GB a layer (4 layers: 43.5 GB); deepseek-v2 4.2 GB,
# its dense first layer 1.35 GB and 15.9 GB an MoE layer (3 layers:
# 37.3 GB).
MOE = (("llama4-scout-17b-a16e", 4), ("deepseek-v2-236b", 3))
MOE_B, MOE_S, MOE_DECODE = 1, 2048, 16
MOE_SERVE_B, MOE_SERVE_PROMPT, MOE_SERVE_GEN = 4, 16, 16
# Share of (token, layer) routing choices that may differ between the
# kernel and plain prefills: K4 and the einsum round differently, and a
# top-1 router flips where two logits nearly tie.
MOE_FLIP_SHARE = 1e-3
# The xLSTM phase: xlstm-1.3b at full width and depth (2.47e9 parameters,
# 9.9 GB fp32); no kernel on its path.
XLSTM = "xlstm-1.3b"
XLSTM_B, XLSTM_S, XLSTM_DECODE = 1, 2048, 16
# The training phase: olmo-1b at full width and depth through
# repro_torch.launch.train (the plain path, as repro trains), and
# tests/test_train_substrate.py's bound on accumulation's rounding.
TRAIN_ARCH, TRAIN_STEPS, TRAIN_B, TRAIN_S = "olmo-1b", 10, 2, 2048
ACCUM_TOL = 5e-4
# Card-against-CPU train steps at the CPU tests' size (B 2 x S 16).
TRAIN_CHECK_BS = (2, 16)
# The mesh training run: the unmeshed run's CE within this share.
MESH_CE_REL = 1e-5
# The cluster phase: RFold on 64 XPUs in 2^3 cubes, 1-XPU jobs of the
# reference's five archs (src/repro/launch/cluster.py:111-117), smoke
# steps on the card against the CPU within this share.
CLUSTER_XPUS, CLUSTER_CUBE, CLUSTER_STEPS, CLUSTER_REL = 64, 2, 3, 1e-4
# The dry-run phase: 256 x one rank's FLOPs within this share of the
# unsharded count; remat_full's FLOPs this far above baseline's
# (repro's hypothesis: about +1/3, src/repro/launch/perf.py:32-34).
DRYRUN_RATIO_TOL, REMAT_RANGE = 0.10, (1.20, 1.45)
# The single-pass baseline's cell: benchmarks_torch/fitmask_bench.py's
# headline (16^3, B 8, K 4).
SINGLEPASS_CELL = ((16, 16, 16), 8, 4)


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


def singlepass_input(device):
    """The single-pass baseline's cell, SINGLEPASS_CELL, with the bench's
    boxes and grids: (label, B, dims, boxes, occ)."""
    from benchmarks_torch.fitmask_bench import boxes_for

    dims, bsz, k = SINGLEPASS_CELL
    occ = occupancy(np.random.default_rng(SEED + 3), bsz, dims, device)
    return (f"singlepass {dims[0]}^3", bsz, dims, boxes_for(dims, k), occ)


def singlepass_row(kernel, label, bsz, dims, boxes, occ):
    """The baseline held bit-exact against its plain version and K1, and
    timed beside K1 (``multibox_ms``) on the same grids."""
    fn = lambda: kernel.fitmask_multibox_singlepass_baseline(occ, boxes)  # noqa: E731
    plain = lambda: kernel.fitmask_multibox_singlepass_baseline_plain(  # noqa: E731
        occ, boxes)
    multi = lambda: kernel.fitmask_multibox(occ, boxes)  # noqa: E731
    got, want, k1 = fn(), plain(), multi()
    torch.cuda.synchronize()
    if not (same(got, want) and same(got, k1)):
        raise AssertionError(f"single-pass baseline on {label}: differs "
                             "from its plain version or from K1")
    bms, by = bound(*multibox_work(bsz, dims, boxes))
    call_ms = time_ms(fn)
    return dict(name="fitmask_multibox_singlepass_baseline", case=label,
                shape=[bsz, len(boxes), *dims], box_role="", box=None,
                max_abs_err=max_abs_err(got, want), ms=device_ms(fn, call_ms),
                call_ms=call_ms, plain_ms=time_ms(plain), library_ms=None,
                bound_ms=bms, bound_by=by,
                multibox_ms=device_ms(multi, time_ms(multi)))


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
    rows.append(singlepass_row(kernel, *singlepass_input(device)))
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
        if "multibox_ms" in r:
            print(f"# {r['case']}: one K1 launch {r['multibox_ms']} ms, "
                  f"{r['ms'] / r['multibox_ms']}x faster than the baseline")
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


def scenario_phase(kernel, device):
    """The eval matrix under each named chaos scenario, as fleets and per
    task on the card against per task on numpy; then chaos_bench's
    matrix on the card against numpy. Returns the fitmask launches of
    the two ``cuda`` eval runs, summed."""
    from benchmarks_torch import chaos_bench
    from repro_torch.core.engineconfig import EngineConfig
    from repro_torch.eval import EvalRunner, make_tasks
    from repro_torch.sim.scenarios import SCENARIOS

    names = sorted(SCENARIOS)
    tasks = [t for name in names for t in make_tasks(
        CONFIGS, SCENARIO_RUNS, SCENARIO_JOBS, LOAD, FLEET_SEED0,
        scenario=name)]
    plain = make_tasks(CONFIGS, SCENARIO_RUNS, SCENARIO_JOBS, LOAD,
                       FLEET_SEED0)
    seq = EngineConfig("numpy", fleet_size=0)

    def run(cfg, todo):
        runner = EvalRunner(workers=0, engine=cfg)
        kernel.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        records = runner.run(todo)
        torch.cuda.synchronize()
        return records, time.perf_counter() - t0, runner, \
            kernel.launch_counts()

    print("# scenario main path: %d configs x %d scenarios x %d run x %d "
          "jobs, seed0 %d, target_load %s, workers 0"
          % (len(CONFIGS), len(names), SCENARIO_RUNS, SCENARIO_JOBS,
             FLEET_SEED0, LOAD))
    want, numpy_s, _, _ = run(seq, tasks)
    fleet, fleet_s, fleet_run, fleet_n = run(
        EngineConfig("cuda", device=device), tasks)
    per_task, per_task_s, _, per_task_n = run(
        EngineConfig("cuda", device=device, fleet_size=0), tasks)
    # numpy again, last: the first matrix in a process pays cache fills
    again, numpy_again_s, _, _ = run(seq, tasks)
    for name, recs in (("cuda fleet", fleet), ("cuda per task", per_task),
                       ("numpy per task, again", again)):
        if strip_timing(recs) != strip_timing(want):
            raise AssertionError(f"scenarios, {name}: records differ from "
                                 "per-task numpy's")
    healthy = {(r["label"], r["run_idx"]): r["summary"] for r in want
               if r["scenario"] == "healthy"}
    for r in run(seq, plain)[0]:
        if json.dumps(r["summary"], sort_keys=True) != json.dumps(
                healthy[(r["label"], r["run_idx"])], sort_keys=True):
            raise AssertionError(f"healthy {r['label']}: summary differs "
                                 "from the scenario-free record's")
    print("scenario,config,faults,repairs,victims,migrated,preempted,"
          "killed,jcr,util_overall,dip_depth,recovered")
    for r in want:
        ch = r["chaos"]
        print(f"scenario,{r['scenario']} {r['label']},{ch['faults']},"
              f"{ch['repairs']},{ch['victims']},{ch['migrated']},"
              f"{ch['preempted']},{ch['killed']},{r['summary']['jcr']},"
              f"{ch['util_overall']},{ch['dip_depth']},{ch['recovered']}")
        if r["scenario"] not in ("node_churn", "ocs_degraded",
                                 "multi_tenant"):
            continue
        moved = ch["migrated"] + ch["preempted"] + ch["killed"]
        # multi_tenant's priority preemptions add evictions no fault made
        lost = (moved < ch["victims"] if r["scenario"] == "multi_tenant"
                else moved != ch["victims"])
        if ch["faults"] == 0 or lost:
            raise AssertionError(f"{r['scenario']} {r['label']}: {ch}")
        if r["scenario"] == "node_churn" and (
                ch["killed"] or ch["repairs"] != ch["faults"]):
            raise AssertionError(f"node_churn {r['label']}: {ch}")
    fl = fleet_run.last_stats["fleet"]
    b = fl["broker"]
    print("scenario_fleet,fleets,size,flushes,flush_all_parked,"
          "flush_timeout,mean_grids_per_call,park_s,engine_s")
    print(f"scenario_fleet,{fl['fleets']},{fl['size']},{b['flushes']},"
          f"{b['flush_all_parked']},{b['flush_timeout']},"
          f"{b['mean_grids_per_call']},{b['park_s']},{b['engine_s']}")
    if b["engine_failovers"] or b["canary_checks"] or b["engine_retries"]:
        raise AssertionError(f"the scenario fleet failed over: {b}")
    launches = {k: fleet_n[k] + per_task_n[k] for k in fleet_n}
    print("scenario_launches,run,fused_launches,k1_launches,k2_launches,"
          "k3_launches")
    for name, n in (("cuda fleet", fleet_n), ("cuda per task", per_task_n)):
        print(f"scenario_launches,{name},{n['fitmask_multibox_bucketed']},"
              f"{n['fitmask_multibox']},{n['occupancy_counts']},"
              f"{n['fitmask_batched']}")
    for name, count in launches.items():
        if count == 0:
            raise AssertionError(f"the scenario path never launched {name}")

    print("# chaos_bench matrix: %d scenarios x %d policies at 512 XPUs, "
          "%d jobs, seed %d, every cell twice"
          % (len(names), len(chaos_bench.POLICY_CONFIGS), CHAOS_BENCH_JOBS,
             CHAOS_BENCH_SEED))
    t0 = time.perf_counter()
    bench_cuda = chaos_bench.run_matrix(
        names, CHAOS_BENCH_JOBS, CHAOS_BENCH_SEED,
        EngineConfig("cuda", device=device), emit=lambda _: None)
    torch.cuda.synchronize()
    bench_cuda_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    bench_numpy = chaos_bench.run_matrix(
        names, CHAOS_BENCH_JOBS, CHAOS_BENCH_SEED, EngineConfig("numpy"),
        emit=lambda _: None)
    bench_numpy_s = time.perf_counter() - t0

    def cells(matrix):
        return json.dumps({sc: {k: {f: v for f, v in cell.items()
                                    if f != "cell_s"}
                                for k, cell in row.items()}
                           for sc, row in matrix.items()}, sort_keys=True)

    head = chaos_bench.headline_from(bench_cuda, 0.02)
    print(f"chaos_bench,headline,{json.dumps(head, sort_keys=True)}")
    if cells(bench_cuda) != cells(bench_numpy):
        raise AssertionError("chaos_bench: cuda cells differ from numpy's")
    if not (head["deterministic"] and head["pass"]):
        raise AssertionError(f"chaos_bench on cuda: {head}")
    print("# scenario_walls: numpy per task ran first and again last")
    print("scenario_walls,cuda_fleet_s,cuda_per_task_s,numpy_per_task_s,"
          "numpy_per_task_last_s,chaos_bench_cuda_s,chaos_bench_numpy_s")
    print(f"scenario_walls,{fleet_s},{per_task_s},{numpy_s},{numpy_again_s},"
          f"{bench_cuda_s},{bench_numpy_s}")

    # The kill arm: node_churn with fail-stop faults, the eval runner's
    # sim_kw path, as cuda fleets, cuda per task and numpy per task.
    t_kill = time.perf_counter()
    kill_tasks = make_tasks(CONFIGS, SCENARIO_RUNS, SCENARIO_JOBS, LOAD,
                            FLEET_SEED0, sim_kw={"fault_mode": "kill"},
                            scenario="node_churn")
    kill_want = run(seq, kill_tasks)[0]
    kill_fleet, _, kill_run, kill_fleet_n = run(
        EngineConfig("cuda", device=device), kill_tasks)
    kill_per_task, _, _, kill_per_task_n = run(
        EngineConfig("cuda", device=device, fleet_size=0), kill_tasks)
    for name, recs in (("cuda fleet", kill_fleet),
                       ("cuda per task", kill_per_task)):
        if strip_timing(recs) != strip_timing(kill_want):
            raise AssertionError(f"kill arm, {name}: records differ from "
                                 "per-task numpy's")
    killed = dropped = 0
    for r in kill_want:
        ch = r["chaos"]
        if ch["victims"] != ch["killed"] or ch["preempted"] \
                or ch["migrated"] or \
                r["summary"]["num_dropped"] < ch["killed"]:
            raise AssertionError(f"kill arm, {r['label']}: {ch}, "
                                 f"{r['summary']['num_dropped']} dropped")
        killed += ch["killed"]
        dropped += r["summary"]["num_dropped"]
    b = kill_run.last_stats["fleet"]["broker"]
    if b["engine_failovers"] or b["canary_checks"] or b["engine_retries"]:
        raise AssertionError(f"the kill arm's fleet failed over: {b}")
    kill_n = {k: kill_fleet_n[k] + kill_per_task_n[k] for k in kill_fleet_n}
    kill_s = time.perf_counter() - t_kill
    print("scenario_kill,records_identical,killed,dropped,fused_launches,"
          "k1_launches,k2_launches,k3_launches,wall_s")
    print(f"scenario_kill,True,{killed},{dropped},"
          f"{kill_n['fitmask_multibox_bucketed']},"
          f"{kill_n['fitmask_multibox']},{kill_n['occupancy_counts']},"
          f"{kill_n['fitmask_batched']},{kill_s}")
    if killed == 0:
        raise AssertionError("the kill arm killed no job")
    for name in ("fitmask_multibox_bucketed", "fitmask_multibox",
                 "occupancy_counts"):
        if kill_n[name] == 0:
            raise AssertionError(f"the kill arm never launched {name}")
    return {k: launches[k] + kill_n[k] for k in launches}


def replay(ops, policy, kw, device, mask_client=None):
    """``ops`` over TCP against a daemon on ``cuda`` (``mask_client``:
    a shared broker) and in process against a core on ``numpy``, the
    oracle: after every op the reply (less the daemon's ``seq`` and
    ``epoch``) and the state digest must be equal. Returns the final
    digest, the journal length and the two sides' walls."""
    from benchmarks_torch.crash_loop import RawClient
    from repro_torch.core.engineconfig import EngineConfig
    from repro_torch.serve.scheduler import (AllocatorCore, Scheduler,
                                             SchedulerConfig, protocol)

    core = AllocatorCore(SchedulerConfig(policy=policy, policy_kw=dict(kw),
                                         engine="numpy"))
    sched = Scheduler(SchedulerConfig(
        policy=policy, policy_kw=dict(kw),
        engine=EngineConfig("cuda", device=device)),
        mask_client=mask_client).start()
    client = RawClient(sched.address, cid="smoke")
    daemon_s = numpy_s = 0.0
    try:
        for i, msg in enumerate(ops):
            wire = dict(msg, client="smoke", request_id=f"smoke:{i}")
            t0 = time.perf_counter()
            got = client.send(i, msg)
            daemon_s += time.perf_counter() - t0
            t0 = time.perf_counter()
            want = core.apply(wire)[0]
            numpy_s += time.perf_counter() - t0
            got = {k: v for k, v in got.items() if k not in ("seq", "epoch")}
            if got != protocol.decode(protocol.encode(want)):
                raise AssertionError(f"{policy} op {i} {msg}: daemon "
                                     f"replied {got}, numpy {want}")
            st = client.send(1_000_000 + i, {"op": "status"})
            if st["state_digest"] != core.state_digest():
                raise AssertionError(f"{policy} op {i} {msg}: digest "
                                     "differs from numpy's")
        st = client.send(2_000_000, {"op": "status"})
    finally:
        client.close()
        sched.stop()
    return st["state_digest"], st["journal_ops"], daemon_s, numpy_s


def service_phase(kernel, device):
    """The allocator service on the card: crash_loop's op stream at 4096
    XPUs through a ``cuda`` daemon against a ``numpy`` core (RFold 4^3,
    FirstFit 16^3), a daemon sharing a ``cuda`` broker, the crash drill
    at that size, failover_drill --quick, and service_bench's sections.
    Returns the fitmask launches of the phase."""
    from benchmarks_torch import crash_loop, failover_drill, service_bench
    from repro_torch.core.engineconfig import EngineConfig
    from repro_torch.sim.fleet import QueryBroker

    cuda = EngineConfig("cuda", device=device)
    rfold_kw = crash_loop.policy_kw_for(SERVICE_XPUS)
    streams = [
        ("RFold (4^3)", "rfold", rfold_kw),
        ("FirstFit (16^3)", "firstfit", SERVICE_STATIC),
    ]
    print("# service main path: crash_loop's node_churn op stream, %d jobs, "
          "seed %d, at %d XPUs; cuda daemon over TCP vs numpy core, every op"
          % (SERVICE_JOBS, SERVICE_SEED, SERVICE_XPUS))
    kernel.reset_launch_counts()
    print("service_stream,config,ops,journal_ops,daemon_s,numpy_core_s,"
          "k1_launches,k2_launches,k3_launches,fused_launches")
    digests = {}
    for label, policy, kw in streams:
        ops = crash_loop.build_op_stream(SERVICE_JOBS, SERVICE_SEED,
                                         policy=policy, policy_kw=kw)
        before = kernel.launch_counts()
        digest, journal, daemon_s, numpy_s = replay(ops, policy, kw, device)
        torch.cuda.synchronize()
        after = kernel.launch_counts()
        n = {k: after[k] - before[k] for k in after}
        digests[policy] = (digest, ops)
        print(f"service_stream,{label},{len(ops)},{journal},{daemon_s},"
              f"{numpy_s},{n['fitmask_multibox']},{n['occupancy_counts']},"
              f"{n['fitmask_batched']},{n['fitmask_multibox_bucketed']}")

    digest, ops = digests["rfold"]
    broker = QueryBroker("cuda", quorum=0, device=device)
    before = kernel.launch_counts()
    shared, _, shared_s, _ = replay(ops, "rfold", rfold_kw, device,
                                    mask_client=broker)
    torch.cuda.synchronize()
    fused = (kernel.launch_counts()["fitmask_multibox_bucketed"]
             - before["fitmask_multibox_bucketed"])
    b = broker.stats.as_dict()
    print("service_broker,digest_equal,requests,flushes,fused_launches,"
          "mean_grids_per_call,failovers,daemon_s")
    print(f"service_broker,{shared == digest},{b['requests']},"
          f"{b['flushes']},{fused},{b['mean_grids_per_call']},"
          f"{b['engine_failovers']},{shared_s}")
    if shared != digest:
        raise AssertionError("the daemon sharing a cuda broker digests "
                             "unlike the plain cuda daemon")
    if fused == 0 or b["requests"] == 0:
        raise AssertionError(f"the shared broker never launched: {b}")
    if b["engine_failovers"] or b["engine_retries"] or b["canary_checks"]:
        raise AssertionError(f"the shared broker failed over: {b}")

    t0 = time.perf_counter()
    drill = crash_loop.run_drill(SERVICE_JOBS, SERVICE_SEED, SERVICE_KILLS,
                                 cuda, SERVICE_XPUS)
    torch.cuda.synchronize()
    crash_s = time.perf_counter() - t0
    c = drill["crash"]
    print("service_crash_loop,ops,kills,control_digest,crash_digest,"
          "journal_ops,dedup_hits,wal_tail_ops,resends_clean,pass,wall_s")
    print(f"service_crash_loop,{drill['ops']},{len(drill['kills'])},"
          f"{drill['control']['digest']},{c['digest']},{c['journal_ops']},"
          f"{c['resilience']['dedup_hits']},{c['resilience']['wal_tail_ops']},"
          f"{c['resends_clean']},{drill['pass']},{crash_s}")
    if not drill["pass"] or len(drill["kills"]) != SERVICE_KILLS:
        raise AssertionError(f"crash loop on the card: {drill}")

    t0 = time.perf_counter()
    fo = failover_drill.run_drill(FAILOVER_JOBS, SERVICE_SEED,
                                  FAILOVER_ACK_N, cuda)
    torch.cuda.synchronize()
    h = fo["headline"]
    print("service_failover,ops,digest_identical,acked_ops_lost,"
          "resend_exactly_once,fenced_writes_landed,fenced,rto_ms,"
          "sync_p50_ms,async_p50_ms,pass,wall_s")
    print(f"service_failover,{h['ops']},{h['digest_identical']},"
          f"{h['acked_ops_lost']},{h['resend_exactly_once']},"
          f"{h['fenced_writes_landed']},{h['fenced_client_and_journal']},"
          f"{h['rto_ms']},{fo['ack_overhead']['sync']['p50_ms']},"
          f"{fo['ack_overhead']['async']['p50_ms']},{fo['pass']},"
          f"{time.perf_counter() - t0}")
    if not fo["pass"]:
        raise AssertionError(f"failover drill on the card: {fo}")

    par = service_bench.parity_section(BENCH_PARITY_JOBS, 3, cuda)
    adm = service_bench.admission_section(BENCH_FLOOD, cuda)
    lat = service_bench.latency_section(BENCH_LATENCY_JOBS, 11, cuda)
    torch.cuda.synchronize()
    print("service_bench,parity_identical,admission_pass,outcomes_equal")
    print(f"service_bench,{par['identical']},{adm['pass']},"
          f"{lat['outcomes_equal']}")
    if not (par["identical"] and adm["pass"] and lat["outcomes_equal"]):
        raise AssertionError(f"service_bench on the card: {par} {adm} "
                             f"{lat['outcomes']}")
    # Host-clock walls of one RPC (remote) or one apply (in process);
    # printed beside the card's name and power limit, gated on nothing.
    print("# service latency (not gated): %d jobs at %d XPUs, %s"
          % (BENCH_LATENCY_JOBS, lat["num_xpus"], card_line()))
    print("service_latency,side,submit_p50_ms,submit_p99_ms,submit_max_ms,"
          "done_p99_ms,rpcs")
    for side in ("remote", "local"):
        r = lat[side]
        print(f"service_latency,{side},{r['submit_p50_ms']},"
              f"{r['submit_p99_ms']},{r['submit_max_ms']},"
              f"{r['done_p99_ms']},{r['rpcs']}")
    launches = kernel.launch_counts()
    print("service_launches,k1,k2,k3,fused")
    print(f"service_launches,{launches['fitmask_multibox']},"
          f"{launches['occupancy_counts']},{launches['fitmask_batched']},"
          f"{launches['fitmask_multibox_bucketed']}")
    for name, count in launches.items():
        if count == 0:
            raise AssertionError(f"the service path never launched {name}")
    return launches


def card_line():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader", "-i", "0"],
                          capture_output=True, text=True,
                          check=True).stdout.strip()


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
    # each family's head layout at its prefill shape on the serve and
    # sweep paths (the window, 8192, reaches past S as there)
    ("llama3-8b 32:8", PREFILL_B, PREFILL_S, 32, 8, 128, 8192),
    ("phi4-mini 24:8", SWEEP_B, SWEEP_S, 24, 8, 128, 8192),
    ("olmo-1b 16:16", SWEEP_B, SWEEP_S, 16, 16, 128, 8192),
    ("qwen1.5-110b 64:8", SWEEP_B, SWEEP_S, 64, 8, 128, 8192),
    ("qwen2-vl-7b 28:4", SWEEP_B, SWEEP_S, 28, 4, 128, 8192),
    ("musicgen 24:24", SWEEP_B, SWEEP_S, 24, 24, 64, 8192),
    ("llama4-scout 40:8", MOE_B, MOE_S, 40, 8, 128, 8192),
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


# -- serve main paths: zamba2-1.2b and llama3-8b at full width ------------

def matmul_flop(cfg, b, s):
    """FLOP of the matrix products one forward of B x S tokens does
    through cuBLAS (2 per weight element per token), by the layer plan:
    attention's projections (GQA d·hd·(2H + 2KH); MLA's down and up
    projections and output), a dense layer's FFN 3·d·d_ff (zamba2's
    shared block once per group; deepseek's dense first layer), Mamba2's
    in and out projections in every Mamba2 layer, an MoE layer's router,
    shared experts and routed experts over all E·capacity slots (padded
    slots are computed too), and the LM head (one per codebook for
    audio). GQA attention's own products are K4's; MLA's run as einsums
    over all S² (q, k) pairs and are counted here, as are the xLSTM's:
    an mLSTM layer's projections and its parallel form's two (B, H, S,
    S) products, an sLSTM layer's input, recurrent (four gates a step)
    and output products."""
    from repro_torch.models import model as lm
    from repro_torch.models.ffn import capacity
    from repro_torch.models.ssm import mamba_dims
    from repro_torch.models.xlstm import mlstm_dims

    d, tokens = cfg.d_model, b * s
    if cfg.use_mla:
        h, qk = cfg.n_heads, cfg.qk_nope_dim + cfg.qk_rope_dim
        attn = (d * cfg.q_lora_rank + cfg.q_lora_rank * h * qk
                + d * (cfg.kv_lora_rank + cfg.qk_rope_dim)
                + cfg.kv_lora_rank * h * (cfg.qk_nope_dim + cfg.v_head_dim)
                + h * cfg.v_head_dim * d)
        # scores and values: (B, H, S, S) by qk and by v_head_dim
        attn_flop = 2 * b * h * s * s * (qk + cfg.v_head_dim)
    else:
        attn = d * cfg.head_dim * (2 * cfg.n_heads + 2 * cfg.n_kv_heads)
        attn_flop = 0
    dense = attn + 3 * d * cfg.d_ff
    mamba = 0
    if cfg.ssm_state:
        di, h, n, g = mamba_dims(cfg)
        mamba = d * (2 * di + 2 * g * n + h) + di * d
    moe = moe_dense = routed = 0
    if cfg.n_experts:
        f, e = cfg.moe_d_ff, cfg.n_experts
        moe = attn + d * e + 3 * d * f * cfg.n_shared_experts
        moe_dense = attn + 3 * d * (cfg.d_ff or f * (cfg.n_shared_experts
                                                     + cfg.moe_top_k))
        slots = (b * e * capacity(cfg, s) if cfg.moe_local_dispatch
                 else e * capacity(cfg, tokens))
        routed = 2 * 3 * d * f * slots
    mlstm = slstm = mlstm_flop = 0
    if cfg.arch_type == "ssm":
        di, h, dqk, dv = mlstm_dims(cfg)
        mlstm = d * 2 * di + di * h * (2 * dqk + dv + 2) + di * d
        slstm = d * 4 * d + 4 * d * (d // h) + d * d
        mlstm_flop = 2 * b * h * s * s * (dqk + dv)
    per_token = d * cfg.vocab_size * max(cfg.n_codebooks, 1)
    total = 0
    for sg in lm.layer_plan(cfg):
        per_token += sg.count * {
            "dense": dense, "mamba": mamba,
            "hybrid_group": dense + len(sg.group) * mamba,
            "xlstm_group": slstm + (len(sg.group) - 1) * mlstm,
            "moe": moe, "moe_dense": moe_dense}[sg.kind]
        if sg.kind in ("moe", "moe_dense"):
            total += sg.count * attn_flop
        if sg.kind == "moe":
            total += sg.count * routed
        if sg.kind == "xlstm_group":
            total += sg.count * (len(sg.group) - 1) * mlstm_flop
    return 2 * tokens * per_token + total


def expected_launches(cfg):
    """K4 once per GQA attention layer (a dense layer, a hybrid group's
    shared block, an MoE family's layer without MLA), K5 once per Mamba2
    layer, on one kernel-path forward. MLA and the xLSTM take no kernel."""
    from repro_torch.models import model as lm

    plan = lm.layer_plan(cfg)
    attention = ("dense", "hybrid_group") + (
        () if cfg.use_mla else ("moe", "moe_dense"))
    return {"flash_attention": sum(sg.count for sg in plan
                                   if sg.kind in attention),
            "ssd_scan": sum(sg.count * max(len(sg.group), 1) for sg in plan
                            if sg.kind in ("mamba", "hybrid_group"))}


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


def build_model(arch, device, layers=None):
    """Full-width fp32 model with random weights from SEED; ``layers``
    cuts the depth. Prints its size and plan."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as lm

    cfg = get_config(arch).replace(dtype="float32")
    cut = ""
    if layers is not None:
        cut = "cut to %d of %d layers" % (layers, cfg.n_layers)
        cfg = cfg.replace(n_layers=layers)
    params = lm.init_model(cfg, torch.Generator(device).manual_seed(SEED),
                           device)
    n_params = []
    lm.tree_map(lambda t: n_params.append(t.numel()), params)
    print("# %s: %d layers%s, d_model %d, heads %d:%d of %d, %d parameters "
          "(fp32), plan %s" % (arch, cfg.n_layers, f" ({cut})" if cut else "",
                               cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                               cfg.head_dim, sum(n_params),
                               [(sg.kind, sg.count) for sg in
                                lm.layer_plan(cfg)]))
    return cfg, params, sum(n_params), cut


def model_batch(cfg, b, s, device):
    """Prefill inputs from numpy's generator (SEED): tokens (B, S), or
    (B, K, S) for audio; for the vlm, ``arange`` positions broadcast to
    (B, S, 3) and SWEEP_PATCHES patch embeddings spliced over the first
    positions (with arange positions the kernel and plain paths agree)."""
    rng = np.random.default_rng(SEED)
    shape = ((b, cfg.n_codebooks, s) if cfg.arch_type == "audio"
             else (b, s))
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, shape)).to(device)}
    if cfg.arch_type == "vlm":
        batch["positions"] = torch.arange(
            s, dtype=torch.int32, device=device)[None, :, None].expand(b, s, 3)
        batch["patch_embeds"] = torch.from_numpy(
            rng.normal(0.0, 0.02, (b, s, cfg.d_model)).astype(np.float32)
        ).to(device)
        mask = torch.zeros((b, s), dtype=torch.bool, device=device)
        mask[:, :SWEEP_PATCHES] = True
        batch["patch_mask"] = mask
    return batch


@contextlib.contextmanager
def recorded_routing():
    """The expert ids of every MoE layer that forwards run inside the
    block, in order (wraps ``models.ffn.router_probs``)."""
    from repro_torch.models import ffn

    ids, real = [], ffn.router_probs

    def record(cfg, logits):
        w, idx = real(cfg, logits)
        ids.append(idx)
        return w, idx

    ffn.router_probs = record
    try:
        yield ids
    finally:
        ffn.router_probs = real


def routing_flips(ids_kernel, ids_plain, b, s):
    """(token, layer) routing choices that differ between two forwards'
    recorded expert ids, the choices compared, and the first position
    whose routing differs in any layer and row (``s`` if none)."""
    def stack(ids):
        return torch.stack([i.reshape(b, s, -1) for i in ids])

    differ = (stack(ids_kernel) != stack(ids_plain)).any(-1)  # (L, B, S)
    at = differ.any(0).any(0).nonzero()
    return (int(differ.sum()), differ.numel(),
            int(at[0, 0]) if len(at) else s)


def prefill_pair(cfg, params, batch, label):
    """The kernel-path prefill (counted: exactly ``expected_launches``)
    and the plain path, then the pair again in the other order (the
    first calls also pay the allocator's growth and the libraries'
    first-use set-up; the second pair's peaks hold no other logits).
    Holds the kernel path within LOGIT_REL x max |logit| of the plain
    path, or bit for bit where no kernel is on the path (MLA, the
    xLSTM: the two paths are one computation). For an MoE model each
    layer's expert ids are recorded on both paths: the (token, layer)
    choices that differ must stay within MOE_FLIP_SHARE, and the logits
    are held up to the first position whose routing differs (a flip at
    token t cannot reach an earlier token: attention is causal, and the
    stable sort only moves later tokens' pairs within an expert's
    segment). Returns the counted launches."""
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.ssd_scan import kernel as ssd
    from repro_torch.models import model as lm

    def counts():
        return {**fa.launch_counts(), **ssd.launch_counts()}

    def reset():
        fa.reset_launch_counts()
        ssd.reset_launch_counts()

    def prefill(use_kernel):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with recorded_routing() as ids:
            logits, _ = lm.forward(cfg, params, batch, use_kernel=use_kernel)
        torch.cuda.synchronize()
        return (logits, time.perf_counter() - t0,
                torch.cuda.max_memory_allocated(), ids)

    want = expected_launches(cfg)
    reset()
    fast, wall_k, peak_k, ids_k = prefill(True)
    launches = counts()
    if launches != want:
        raise AssertionError(f"{label} prefill launched {launches}; "
                             f"expected {want}")
    reset()
    slow, wall_p, peak_p, ids_p = prefill(False)
    if any(counts().values()):
        raise AssertionError(f"the plain {label} prefill launched {counts()}")
    tokens = batch["tokens"]
    want_shape = ((tokens.shape[0], tokens.shape[-1])
                  + ((cfg.n_codebooks,) if cfg.arch_type == "audio" else ())
                  + (cfg.vocab_size,))
    for name, lg in (("kernel", fast), ("plain", slow)):
        if tuple(lg.shape) != want_shape or not bool(torch.isfinite(lg).all()):
            raise AssertionError(f"{label} {name} prefill logits: shape "
                                 f"{tuple(lg.shape)} or not finite")
    held = want_shape[1]
    if cfg.n_experts:
        flips, choices, held = routing_flips(ids_k, ids_p, *want_shape[:2])
        print("routing,arch,layers,choices,differ,first_differing_token")
        print(f"routing,{label},{len(ids_k)},{choices},{flips},{held}")
        if flips > MOE_FLIP_SHARE * choices or held == 0:
            raise AssertionError(f"{label}: {flips} of {choices} routing "
                                 "choices differ between the kernel and "
                                 f"plain paths, the first at token {held}")
    del ids_k, ids_p
    diff = float((fast[:, :held] - slow[:, :held]).abs().max())
    scale = float(slow[:, :held].abs().max())
    del fast, slow, lg
    wall_p2, peak_p2 = prefill(False)[1:3]
    wall_k2, peak_k2 = prefill(True)[1:3]
    limit = LOGIT_REL * scale if any(want.values()) else 0.0
    print("prefill,arch,B,S,wall_kernel_s,wall_plain_s,wall_plain_2nd_s,"
          "wall_kernel_2nd_s,peak_kernel_bytes,peak_plain_bytes,"
          "peak_plain_2nd_bytes,peak_kernel_2nd_bytes,max_abs_dlogit,"
          "max_abs_logit,limit,tokens_held")
    print(f"prefill,{label},{want_shape[0]},{want_shape[1]},{wall_k},{wall_p},"
          f"{wall_p2},{wall_k2},{peak_k},{peak_p},{peak_p2},{peak_k2},{diff},"
          f"{scale},{limit},{held}")
    if not diff <= limit:
        raise AssertionError(f"{label} prefill logits: kernel path differs "
                             f"from the plain path by {diff} > {limit}")
    return launches


def decode_against_prefill(cfg, params, batch, steps, device, label,
                           check=True):
    """``steps`` decode steps (the prompt read one token at a time, the
    window off) against the kernel-path prefill's logits of the same
    tokens (tests/test_arch_smoke.py's check, at DECODE_TOL). With
    ``check`` False (musicgen, whose decode adds the sinusoidal position
    of 0 to every token, as repro's does) the logits must only be finite
    and the drift is printed."""
    from repro_torch.models import model as lm
    from repro_torch.serve import engine

    dcfg = cfg.replace(sliding_window=0)
    toks = batch["tokens"][..., :steps]
    b = toks.shape[0]
    dbatch = {"tokens": toks}
    if cfg.pos_type == "mrope":
        dbatch["positions"] = batch["positions"][:, :steps]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    full, _ = lm.forward(dcfg, params, dbatch, use_kernel=True)
    torch.cuda.synchronize()
    wall_f = time.perf_counter() - t0
    state = engine.init_state(dcfg, b, window=steps, device=device)
    outs = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(steps):
        pos = torch.full((b, 1), t, dtype=torch.int32, device=device)
        if cfg.pos_type == "mrope":
            pos = pos[:, :, None].expand(b, 1, 3)
        lg, state = engine.serve_step(dcfg, params, state,
                                      {"tokens": toks[..., t:t + 1],
                                       "positions": pos})
        outs.append(lg[:, 0])
    torch.cuda.synchronize()
    wall_d = time.perf_counter() - t0
    dec = torch.stack(outs, 1)
    if cfg.use_mla:
        label = f"{label} ({'absorbed' if cfg.mla_absorb else 'naive'} MLA)"
    derr = float((dec - full).abs().max())
    print("decode_vs_prefill,arch,B,S,wall_prefill_s,wall_decode_s,"
          "ms_per_step,max_abs_dlogit,tol")
    print(f"decode_vs_prefill,{label},{b},{steps},{wall_f},{wall_d},"
          f"{wall_d / steps * 1e3},{derr},{DECODE_TOL if check else 'none'}")
    if not bool(torch.isfinite(dec).all()):
        raise AssertionError(f"{label} decode logits are not finite")
    if check:
        torch.testing.assert_close(
            dec, full, rtol=DECODE_TOL, atol=DECODE_TOL,
            msg=lambda m: f"{label} decode logits differ from prefill "
            f"logits: {m}")
    else:
        drift = (dec - full).abs().amax(dim=tuple(
            i for i in range(dec.dim()) if i != 1))
        print("# %s decode drift from the prefill by position (no "
              "pos_offset in decode, as in repro): %s"
              % (label, [float(v) for v in drift[:6]]))
    return dec


def serve_phase(device, arch):
    """One model served at full width and depth: the prefill pair at
    PREFILL_B x PREFILL_S, its profile, DECODE_S decode steps against
    the prefill, and greedy serving through ``repro_torch.launch.serve``
    at its defaults. Returns the kernel-path prefill's launches."""
    import contextlib
    import io

    from repro_torch.launch import serve
    from repro_torch.models import model as lm

    cfg, params, _, _ = build_model(arch, device)
    batch = model_batch(cfg, PREFILL_B, PREFILL_S, device)
    launches = prefill_pair(cfg, params, batch, arch)
    profile_prefill(lambda: lm.forward(cfg, params, batch, use_kernel=True),
                    matmul_flop(cfg, PREFILL_B, PREFILL_S))
    decode_against_prefill(cfg, params, batch, DECODE_S, device, arch)
    del params, batch
    torch.cuda.empty_cache()

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        serve.main(["--arch", arch])
    line = out.getvalue().strip().splitlines()[-1]
    print(f"# greedy serving, repro_torch.launch.serve --arch {arch} at its "
          "defaults")
    print(line)
    if json.loads(line)["output_shape"] != [4, 32]:
        raise AssertionError(f"greedy serving returned {line}")
    torch.cuda.empty_cache()
    return launches


def family_phase(device):
    """The other families on the dense stack at full width, one at a
    time: the prefill pair at SWEEP_B x SWEEP_S (exactly n_layers K4
    launches) and SWEEP_DECODE decode steps against the prefill. Returns
    each family's kernel-path launches."""
    launches = {}
    print("# family sweep: prefill B %d x S %d, %d decode steps"
          % (SWEEP_B, SWEEP_S, SWEEP_DECODE))
    for arch, layers in SWEEP:
        t0 = time.perf_counter()
        cfg, params, n_params, cut = build_model(arch, device, layers)
        batch = model_batch(cfg, SWEEP_B, SWEEP_S, device)
        launches[arch] = prefill_pair(cfg, params, batch, arch)
        decode_against_prefill(cfg, params, batch, SWEEP_DECODE, device,
                               arch, check=cfg.arch_type != "audio")
        del params, batch
        torch.cuda.empty_cache()
        print(f"family,{arch},{cfg.n_layers},{cut or 'full depth'},"
              f"{n_params},{launches[arch]['flash_attention']},"
              f"{time.perf_counter() - t0}")
    return launches


def moe_phase(device):
    """The MoE families at full width and cut depth (MOE), one at a time:
    the prefill pair at MOE_B x MOE_S with routing recorded, a profile,
    two kernel-path forwards bit for bit, MOE_DECODE decode steps against
    the prefill at drop-free capacity (``capacity_factor = n_experts``,
    as tests/test_arch_smoke.py; with MLA both decodes and against each
    other), greedy serving through ``engine.greedy_decode`` and
    ``launch.serve --smoke``. Returns each model's kernel-path launches."""
    import io

    from repro_torch.launch import serve
    from repro_torch.models import model as lm
    from repro_torch.serve import engine

    launches = {}
    for arch, layers in MOE:
        t0 = time.perf_counter()
        cfg, params, n_params, cut = build_model(arch, device, layers)
        batch = model_batch(cfg, MOE_B, MOE_S, device)
        launches[arch] = prefill_pair(cfg, params, batch, arch)
        profile_prefill(
            lambda: lm.forward(cfg, params, batch, use_kernel=True),
            matmul_flop(cfg, MOE_B, MOE_S))

        first, aux1 = lm.forward(cfg, params, batch, use_kernel=True)
        again, aux2 = lm.forward(cfg, params, batch, use_kernel=True)
        identical = torch.equal(first, again) and torch.equal(aux1, aux2)
        print(f"repeat,{arch},bit_identical,{identical},aux,{float(aux1)}")
        if not identical:
            raise AssertionError(f"{arch}: two identical kernel-path "
                                 "forwards differ")
        del first, again

        dcfg = cfg.replace(capacity_factor=float(cfg.n_experts))
        decs = [decode_against_prefill(dcfg.replace(mla_absorb=absorb),
                                       params, batch, MOE_DECODE, device,
                                       arch)
                for absorb in ((False, True) if cfg.use_mla else (False,))]
        if len(decs) == 2:
            gap = float((decs[0] - decs[1]).abs().max())
            print(f"mla_decode,{arch},naive_vs_absorbed_max_abs,{gap},"
                  f"tol,{DECODE_TOL}")
            torch.testing.assert_close(
                decs[1], decs[0], rtol=DECODE_TOL, atol=DECODE_TOL,
                msg=lambda m: f"{arch}: absorbed MLA decode differs from "
                f"the naive decode: {m}")
        del decs

        prompt = np.random.default_rng(SEED).integers(
            0, cfg.vocab_size, (MOE_SERVE_B, MOE_SERVE_PROMPT))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = engine.greedy_decode(cfg, params, prompt, steps=MOE_SERVE_GEN,
                                   device=device)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        print(f"greedy,{arch},B,{MOE_SERVE_B},prompt,{MOE_SERVE_PROMPT},"
              f"generated,{MOE_SERVE_GEN},wall_s,{wall},tok_per_s,"
              f"{MOE_SERVE_B * MOE_SERVE_GEN / wall}")
        if tuple(out.shape) != (MOE_SERVE_B, MOE_SERVE_PROMPT + MOE_SERVE_GEN):
            raise AssertionError(f"{arch} greedy_decode returned "
                                 f"{tuple(out.shape)}")
        del params, batch, out
        torch.cuda.empty_cache()

        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            serve.main(["--arch", arch, "--smoke"])
        line = text.getvalue().strip().splitlines()[-1]
        print(f"# repro_torch.launch.serve --arch {arch} --smoke")
        print(line)
        if json.loads(line)["output_shape"] != [4, 32]:
            raise AssertionError(f"smoke serving returned {line}")
        print(f"moe,{arch},{cfg.n_layers},{cut},{n_params},"
              f"{launches[arch]['flash_attention']},"
              f"{time.perf_counter() - t0}")
    return launches


@contextlib.contextmanager
def xlstm_marks():
    """CUDA events around every sLSTM layer (the loop over S with its
    input and output projections) and every mLSTM parallel form that
    forwards run inside the block: yields a list that the block fills
    with (kind, start, end) events (wraps ``models.blocks.slstm_forward``
    and ``models.xlstm._mlstm_parallel``)."""
    from repro_torch.models import blocks, xlstm

    marks, real = [], (blocks.slstm_forward, xlstm._mlstm_parallel)

    def marked(kind, fn):
        def run(*args, **kw):
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            out = fn(*args, **kw)
            end.record()
            marks.append((kind, start, end))
            return out
        return run

    blocks.slstm_forward = marked("slstm", real[0])
    xlstm._mlstm_parallel = marked("mlstm_parallel", real[1])
    try:
        yield marks
    finally:
        blocks.slstm_forward, xlstm._mlstm_parallel = real


def xlstm_split(cfg, params, batch):
    """One kernel-path prefill with the sLSTM layers and the mLSTM
    parallel forms marked by CUDA events (no host sync inside): each
    region's time on the device's timeline (launch-bound regions keep
    the card waiting, so this is their share of the wall) beside the
    wall. Returns the sLSTM share."""
    from repro_torch.models import model as lm

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with xlstm_marks() as marks:
        lm.forward(cfg, params, batch, use_kernel=True)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    by_kind = {"slstm": 0.0, "mlstm_parallel": 0.0}
    for kind, start, end in marks:
        by_kind[kind] += start.elapsed_time(end)
    rest = wall_ms - sum(by_kind.values())
    print("xlstm_split,arch,wall_ms,slstm_layers_ms,slstm_share,"
          "slstm_layers,mlstm_parallel_ms,mlstm_parallel_share,"
          "mlstm_layers,rest_ms")
    print(f"xlstm_split,{cfg.name},{wall_ms},{by_kind['slstm']},"
          f"{by_kind['slstm'] / wall_ms},"
          f"{sum(k == 'slstm' for k, _, _ in marks)},"
          f"{by_kind['mlstm_parallel']},"
          f"{by_kind['mlstm_parallel'] / wall_ms},"
          f"{sum(k == 'mlstm_parallel' for k, _, _ in marks)},{rest}")
    return by_kind["slstm"] / wall_ms


def xlstm_phase(device):
    """xlstm-1.3b at full width and depth (48 layers, fp32, random
    weights from SEED), alone on the card: the prefill pair at XLSTM_B x
    XLSTM_S (no kernel on this family: exactly 0 K4 and 0 K5 launches,
    and the kernel-path and plain forwards bit for bit), the split of
    one prefill's wall between the sLSTM layers, the mLSTM parallel
    forms and the rest, a profile of one group of layers (GEMMs and the
    device's busy share), XLSTM_DECODE decode steps against the
    prefill, and greedy serving through ``repro_torch.launch.serve
    --arch xlstm-1.3b`` at its defaults. Returns the kernel-path
    prefill's launches."""
    import io

    from repro_torch.launch import serve
    from repro_torch.models import model as lm

    t0 = time.perf_counter()
    cfg, params, n_params, _ = build_model(XLSTM, device)
    batch = model_batch(cfg, XLSTM_B, XLSTM_S, device)
    launches = prefill_pair(cfg, params, batch, XLSTM)
    steps = {"prefill pair": time.perf_counter() - t0}
    t1 = time.perf_counter()
    share = xlstm_split(cfg, params, batch)
    steps["split"] = time.perf_counter() - t1
    # The profiler turns each of the sLSTM loop's ~4e5 launches into
    # events; one group of layers (one sLSTM and seven mLSTM layers, a
    # sixth of the stack) with the embedding and head keeps its trace
    # small.
    t1 = time.perf_counter()
    group = cfg.replace(n_layers=cfg.slstm_every)
    one = dict(params, segments=[lm.tree_map(lambda t: t[:1],
                                             params["segments"][0])])
    print(f"# profile of one group: {group.n_layers} of {cfg.n_layers} "
          "layers, the embedding and the head")
    profile_prefill(lambda: lm.forward(group, one, batch, use_kernel=True),
                    matmul_flop(group, XLSTM_B, XLSTM_S))
    steps["profile"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    decode_against_prefill(cfg, params, batch, XLSTM_DECODE, device, XLSTM)
    steps["decode"] = time.perf_counter() - t1
    del params, batch, one
    torch.cuda.empty_cache()

    t1 = time.perf_counter()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        serve.main(["--arch", XLSTM])
    line = out.getvalue().strip().splitlines()[-1]
    print(f"# greedy serving, repro_torch.launch.serve --arch {XLSTM} at its "
          "defaults")
    print(line)
    if json.loads(line)["output_shape"] != [4, 32]:
        raise AssertionError(f"greedy serving returned {line}")
    torch.cuda.empty_cache()
    steps["serve"] = time.perf_counter() - t1
    print("# xlstm phase seconds: %s" % ", ".join(
        f"{k} {v:.1f}" for k, v in steps.items()))
    print(f"xlstm,{XLSTM},{cfg.n_layers},{n_params},"
          f"{launches['flash_attention']},{launches['ssd_scan']},{share},"
          f"{time.perf_counter() - t0}")
    return launches


def train_flop(cfg, b, s):
    """Model FLOP of one train step at B x S: three times the forward's
    (backward twice the forward), the forward being ``matmul_flop`` and,
    per attention layer, the causal half of the (S, S) products,
    2·B·H·S²·head_dim (the plain path computes the whole square)."""
    from repro_torch.models import model as lm

    attn = sum(sg.count for sg in lm.layer_plan(cfg) if sg.kind == "dense")
    return 3 * (matmul_flop(cfg, b, s)
                + attn * 2 * b * cfg.n_heads * s * s * cfg.head_dim)


@contextlib.contextmanager
def timed_train_steps():
    """The wall of every train step that ``repro_torch.launch.train`` runs
    inside the block, each ended by a synchronize (wraps the launcher's
    ``train_step``)."""
    from repro_torch.launch import train

    walls, real = [], train.train_step

    def timed(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real(*args, **kw)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        return out

    train.train_step = timed
    try:
        yield walls
    finally:
        train.train_step = real


def grad_atol(ref):
    """The absolute tolerance of a grad leaf against ``ref``: a 1e-4 share
    of the leaf's largest |grad|, and at least the CPU tests' 1e-6. An
    elementwise 1e-6 holds where two runs add in the same order (the
    port against repro on the CPU); another order moves the xLSTM's
    grads by more (1.6e-6 under a one-ulp perturbation of the params,
    on the CPU alone)."""
    return max(1e-6, 1e-4 * float(ref.abs().max()))


def train_against_cpu(arch, device):
    """One smoke train step on the card against the CPU, from identical
    params and batch (TRAIN_CHECK_BS): the loss; the grads within rtol
    1e-4 and ``grad_atol`` (the elements beyond the CPU tests' elementwise
    rtol 1e-4 / atol 1e-6 are counted and printed); AdamW on the card
    from the CPU's grads within 1e-6 of AdamW on the CPU (the optimizer
    alone: Adam's first step is lr·g / (|g| + eps), so comparing the
    updated params of two steps would magnify grads near eps); and the
    card's ``train_step`` finite with the same CE."""
    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.models import model as lm
    from repro_torch.train.data import synthetic_batches
    from repro_torch.train.optim import (OptimConfig, adamw_update,
                                         init_opt_state)
    from repro_torch.train.train_step import train_step, value_and_grad

    cfg = smoke_variant(get_config(arch))
    cpu = torch.device("cpu")
    host = lm.init_model(cfg, torch.Generator().manual_seed(SEED), cpu)
    params = lm.tree_map(lambda t: t.to(device), host)
    hbatch = next(synthetic_batches(cfg, *TRAIN_CHECK_BS, seed=SEED,
                                    device=cpu))
    batch = {k: v.to(device) for k, v in hbatch.items()}
    (_, m), grads = value_and_grad(cfg, params, batch)
    (_, hm), hgrads = value_and_grad(cfg, host, hbatch)
    pairs = [(g.cpu(), h) for g, h in zip(lm.tree_leaves(grads),
                                          lm.tree_leaves(hgrads))]
    gerr = max(float((g - h).abs().max()) for g, h in pairs)
    beyond = sum(int(((g - h).abs() > 1e-6 + 1e-4 * h.abs()).sum())
                 for g, h in pairs)
    for g, h in pairs:
        torch.testing.assert_close(g, h, rtol=1e-4, atol=grad_atol(h),
                                   msg=lambda msg: f"{arch} grads: {msg}")
    oc = OptimConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    p1 = adamw_update(oc, params, lm.tree_map(lambda h: h.to(device), hgrads),
                      init_opt_state(params))[0]
    h1 = adamw_update(oc, host, hgrads, init_opt_state(host))[0]
    perr = max(float((a.cpu() - h).abs().max())
               for a, h in zip(lm.tree_leaves(p1), lm.tree_leaves(h1)))
    p2, _, m2 = train_step(cfg, oc, params, init_opt_state(params), batch)
    finite = all(bool(torch.isfinite(t).all()) for t in lm.tree_leaves(p2))
    print("train_vs_cpu,arch,ce_card,ce_cpu,max_abs_dgrad,"
          "grads_beyond_cpu_test_tol,grads,max_abs_dparam_adamw,"
          "step_ce_card,step_params_finite")
    print(f"train_vs_cpu,{arch}-smoke,{float(m['ce'])},{float(hm['ce'])},"
          f"{gerr},{beyond},{sum(h.numel() for _, h in pairs)},{perr},"
          f"{float(m2['ce'])},{finite}")
    if not (perr <= 1e-6 and finite
            and abs(float(m["ce"]) - float(hm["ce"])) <= 1e-5 * float(hm["ce"])
            and abs(float(m2["ce"]) - float(m["ce"])) <= 1e-6 * float(m["ce"])):
        raise AssertionError(f"{arch}: the card's train step disagrees with "
                             "the CPU's")


def train_phase(device, record=None):
    """Training on the card: ``repro_torch.launch.train --arch olmo-1b``
    at full width and depth (TRAIN_STEPS steps at TRAIN_B x TRAIN_S, fp32)
    with each step timed, CE falling, s a step over steps 2 to the last,
    tokens/s, peak memory and the model-FLOP rate against the fp32 peak;
    then smoke train steps on the card against the CPU (olmo-1b,
    xlstm-1.3b), ``train_step_accum`` with two micro-batches against the
    full batch, a checkpoint saved and loaded bit for bit, and
    ``train_step(use_kernel=True)`` refused (K4 has no backward). Returns
    the K4 and K5 launches of the launcher's run; ``record`` (a dict)
    gets its history, s a step, tokens/s and peak."""
    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.ssd_scan import kernel as ssd
    from repro_torch.launch import train
    from repro_torch.models import model as lm
    from repro_torch.train.checkpoint import load_checkpoint, save_checkpoint
    from repro_torch.train.data import synthetic_batches
    from repro_torch.train.optim import OptimConfig, init_opt_state
    from repro_torch.train.train_step import train_step, train_step_accum

    cfg = get_config(TRAIN_ARCH).replace(dtype="float32")
    fa.reset_launch_counts()
    ssd.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with timed_train_steps() as walls:
        history = train.main(["--arch", TRAIN_ARCH, "--steps",
                              str(TRAIN_STEPS), "--batch", str(TRAIN_B),
                              "--seq", str(TRAIN_S), "--seed", str(SEED)])
    torch.cuda.synchronize()
    launches = {**fa.launch_counts(), **ssd.launch_counts()}
    peak = torch.cuda.max_memory_allocated()
    torch.cuda.empty_cache()
    if any(launches.values()):
        raise AssertionError(f"training launched {launches}: it runs the "
                             "plain path")
    if not history[-1]["ce"] < history[0]["ce"]:
        raise AssertionError(f"CE did not fall: {history}")
    steady = walls[1:]
    s_step = sum(steady) / len(steady)
    flop = train_flop(cfg, TRAIN_B, TRAIN_S)
    print("train,arch,B,S,steps,first_step_s,s_per_step,min_step_s,"
          "max_step_s,tokens_per_s,peak_bytes,model_tflop_per_step,"
          "model_tflop_per_s,share_of_fp32_peak,ce_first,ce_last")
    print(f"train,{TRAIN_ARCH},{TRAIN_B},{TRAIN_S},{len(walls)},{walls[0]},"
          f"{s_step},{min(steady)},{max(steady)},"
          f"{TRAIN_B * TRAIN_S / s_step},{peak},{flop / 1e12},"
          f"{flop / s_step / 1e12},{flop / s_step / PEAK_FLOPS[torch.float32]},"
          f"{history[0]['ce']},{history[-1]['ce']}")
    if record is not None:
        record.update(history=history, s_step=s_step, peak=peak,
                      tokens_per_s=TRAIN_B * TRAIN_S / s_step)

    for arch in ("olmo-1b", "xlstm-1.3b"):
        train_against_cpu(arch, device)

    small = smoke_variant(get_config("olmo-1b"))
    params = lm.init_model(small, torch.Generator(device).manual_seed(SEED),
                           device)
    batch = next(synthetic_batches(small, 4, 64, seed=SEED, device=device))
    oc = OptimConfig(lr=1e-3, warmup_steps=0, total_steps=10, clip_norm=1e9)
    opt = init_opt_state(params)
    p_full, _, m_full = train_step(small, oc, params, opt, batch)
    p_acc, o_acc, m_acc = train_step_accum(small, oc, params, opt, batch,
                                           n_micro=2)
    diff = max(float((a - b).abs().max()) for a, b in
               zip(lm.tree_leaves(p_full), lm.tree_leaves(p_acc)))
    print(f"train_accum,olmo-1b-smoke,n_micro,2,max_abs_dparam,{diff},tol,"
          f"{ACCUM_TOL},ce_full,{float(m_full['ce'])},ce_accum,"
          f"{float(m_acc['ce'])}")
    if not diff < ACCUM_TOL:
        raise AssertionError(f"accumulation differs from the full batch by "
                             f"{diff}")

    ckpt_dir = os.path.join(ROOT, "build", "chip_smoke_ckpt")
    path = os.path.join(ckpt_dir, "ckpt.npz")
    try:
        save_checkpoint(path, p_acc, o_acc, step=1, meta={"arch": small.name})
        zeros = lm.tree_map(torch.zeros_like, p_acc)
        p2, o2, meta = load_checkpoint(path, zeros,
                                       lm.tree_map(torch.zeros_like, o_acc))
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    same_bits = all(
        a.device == b.device and torch.equal(a, b) for a, b in
        zip(lm.tree_leaves([p_acc, o_acc]), lm.tree_leaves([p2, o2])))
    print(f"checkpoint,olmo-1b-smoke,round_trip_bit_identical,{same_bits},"
          f"meta,{meta}")
    if not same_bits or meta["step"] != 1:
        raise AssertionError("the checkpoint did not round-trip on the card")

    try:
        train_step(small, oc, params, opt, batch, use_kernel=True)
    except RuntimeError as e:
        print(f"# train_step(use_kernel=True) on the card refused: {e}")
    else:
        raise AssertionError("train_step(use_kernel=True) on the card ran: "
                             "K4's output would cut the gradient")
    return launches


def mesh_train_phase(device, unmeshed):
    """``launch.train`` as in the training phase with ``--mesh 1x1``: the
    launcher starts a process group of one rank (NCCL) and trains on
    DTensors. Its CE history against the unmeshed run's (``unmeshed``,
    the training phase's record), s a step, tokens/s and peak beside it.
    Returns the K4 and K5 launches of the run."""
    import torch.distributed as dist

    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.ssd_scan import kernel as ssd
    from repro_torch.launch import train

    fa.reset_launch_counts()
    ssd.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with timed_train_steps() as walls:
        history = train.main(["--arch", TRAIN_ARCH, "--steps",
                              str(TRAIN_STEPS), "--batch", str(TRAIN_B),
                              "--seq", str(TRAIN_S), "--seed", str(SEED),
                              "--mesh", "1x1"])
    torch.cuda.synchronize()
    launches = {**fa.launch_counts(), **ssd.launch_counts()}
    peak = torch.cuda.max_memory_allocated()
    torch.cuda.empty_cache()
    if dist.is_initialized():
        raise AssertionError("launch.train left its process group up")
    if any(launches.values()):
        raise AssertionError(f"the mesh run launched {launches}")
    rel = max(abs(a["ce"] - b["ce"]) / abs(b["ce"])
              for a, b in zip(history, unmeshed["history"]))
    steady = walls[1:]
    s_step = sum(steady) / len(steady)
    print("train_mesh,arch,mesh,steps,first_step_s,s_per_step,min_step_s,"
          "max_step_s,tokens_per_s,peak_bytes,unmeshed_s_per_step,"
          "unmeshed_tokens_per_s,unmeshed_peak_bytes,step_time_ratio,"
          "max_rel_dce,ce_first,ce_last")
    print(f"train_mesh,{TRAIN_ARCH},1x1,{len(walls)},{walls[0]},{s_step},"
          f"{min(steady)},{max(steady)},{TRAIN_B * TRAIN_S / s_step},{peak},"
          f"{unmeshed['s_step']},{unmeshed['tokens_per_s']},"
          f"{unmeshed['peak']},{s_step / unmeshed['s_step']},{rel},"
          f"{history[0]['ce']},{history[-1]['ce']}")
    if [h["step"] for h in history] != \
            [h["step"] for h in unmeshed["history"]] or rel > MESH_CE_REL:
        raise AssertionError(f"the mesh run's CE moved by {rel} from the "
                             "unmeshed run's")
    return launches


def cluster_phase(kernel, device):
    """The RFold cluster on the card (see the module docstring, item 15).
    Returns the fitmask kernels' launches of the card cluster's run."""
    import torch.distributed as dist

    from repro_torch.core.engineconfig import EngineConfig
    from repro_torch.core.geometry import JobShape
    from repro_torch.launch import cluster as cl
    from repro_torch.launch.mesh import ensure_process_group

    t0 = time.perf_counter()
    created = ensure_process_group(device)
    try:
        kernel.reset_launch_counts()
        card = cl.RFoldCluster(CLUSTER_XPUS, CLUSTER_CUBE,
                               engine=EngineConfig("cuda", device=device),
                               device=device)
        host = cl.RFoldCluster(CLUSTER_XPUS, CLUSTER_CUBE, engine="numpy",
                               device="cpu")
        one = JobShape((1, 1, 1))
        for jid, (arch, _) in enumerate(cl.SUBMISSIONS):
            got = card.submit(jid, arch, one, seed=jid)
            want = host.submit(jid, arch, one, seed=jid)
            if got is None or want is None or \
                    got["placement"] != want["placement"]:
                raise AssertionError(f"job {jid} ({arch}): placed "
                                     f"{got and got['placement']} on cuda, "
                                     f"{want and want['placement']} on numpy")
        held = card.utilization()
        if held != host.utilization() or held != len(cl.SUBMISSIONS) \
                / CLUSTER_XPUS:
            raise AssertionError(f"utilization {held} with all jobs held")
        worst = 0.0
        for jid, (arch, _) in enumerate(cl.SUBMISSIONS):
            lc = card.run_steps(jid, CLUSTER_STEPS)
            lh = host.run_steps(jid, CLUSTER_STEPS)
            rel = max(abs(a - b) / abs(b) for a, b in zip(lc, lh))
            worst = max(worst, rel)
            print(f"cluster_job,{jid},{arch},"
                  f"{json.dumps(card.jobs[jid]['placement'])},"
                  f"losses_card,{lc},losses_cpu,{lh},max_rel,{rel}")
            if len(lc) != CLUSTER_STEPS or rel > CLUSTER_REL:
                raise AssertionError(f"{arch}: card losses {lc} against "
                                     f"the CPU's {lh}")
        torch.cuda.synchronize()
        counts = kernel.launch_counts()
        for jid in range(len(cl.SUBMISSIONS)):
            card.finish(jid)
            host.finish(jid)
        if card.utilization() != 0.0 or host.utilization() != 0.0:
            raise AssertionError("utilization after finish: "
                                 f"{card.utilization()}")
    finally:
        if created:
            dist.destroy_process_group()
    k13 = counts["fitmask_multibox"] + counts["fitmask_batched"]
    print("cluster,xpus,cube_n,jobs,steps,held_utilization,max_rel_dloss,"
          "k2_launches,k1_k3_launches,s")
    print(f"cluster,{CLUSTER_XPUS},{CLUSTER_CUBE},{len(cl.SUBMISSIONS)},"
          f"{CLUSTER_STEPS},{held},{worst},{counts['occupancy_counts']},"
          f"{k13},{time.perf_counter() - t0}")
    if not (counts["occupancy_counts"] > 0 and k13 > 0):
        raise AssertionError(f"the cluster's placements launched {counts}")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.cluster",
                        "--jobs", "5", "--steps", "3"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    print(r.stdout.rstrip())
    if r.returncode != 0:
        raise AssertionError(f"launch.cluster exited {r.returncode}: "
                             f"{r.stderr[-2000:]}")
    return counts


def dryrun_phase(device, out):
    """The dry-run and perf harness on a fake process group (see the
    module docstring, item 16), writing the dry-run JSONs to ``out`` (the
    bench phase reads them). Host work only: the card's allocated memory
    must not grow. Returns the perf variants' rows by name."""
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import SHAPES
    from repro_torch.launch import dryrun, perf

    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    dryrun.main(["--arch", "olmo-1b", "--shape", "train_4k", "--mesh",
                 "single", "--out", out])
    t_olmo = time.perf_counter() - t0
    with open(os.path.join(out, "olmo-1b__train_4k__single.json")) as f:
        res = json.load(f)
    t0 = time.perf_counter()
    dryrun.main(["--arch", "zamba2-1.2b", "--shape", "decode_32k",
                 "--mesh", "single", "--no-probe", "--out", out])
    t_zamba = time.perf_counter() - t0
    with open(os.path.join(out, "zamba2-1.2b__decode_32k__single.json")
              ) as f:
        dec = json.load(f)
    t0 = time.perf_counter()
    one = dryrun.one_rank_cost(get_config("olmo-1b"), SHAPES["train_4k"],
                               device=device)
    t_one = time.perf_counter() - t0
    t0 = time.perf_counter()
    rows = {r["variant"]: r for r in perf.main(
        ["--arch", "olmo-1b", "--shape", "train_4k", "--variants",
         "baseline,remat_full,no_fsdp"])}
    t_perf = time.perf_counter() - t0
    torch.cuda.synchronize()
    mem1 = torch.cuda.memory_allocated()
    ratio = res["chips"] * res["flops"] / one["flops"]
    ex = res["probes"]["extrapolated"]
    remat = rows["remat_full"]["flops_per_chip"] \
        / rows["baseline"]["flops_per_chip"]
    print("dryrun,arch,shape,chips,flops,bytes_accessed,collective_bytes,"
          "collective_count,hlo_ops,argument_bytes,temp_bytes,"
          "one_rank_flops,chips_x_flops_over_one_rank,extrapolated_flops,"
          "trace_s")
    for r, t in ((res, t_olmo), (dec, t_zamba)):
        mem = r["memory_analysis"]
        print(f"dryrun,{r['arch']},{r['shape']},{r['chips']},{r['flops']},"
              f"{r['bytes_accessed']},{r['collectives']['total_bytes']},"
              f"{r['collectives']['total_count']},{r['hlo_ops']},"
              f"{mem['argument_size_in_bytes']},{mem['temp_size_in_bytes']},"
              + (f"{one['flops']},{ratio},{ex['flops']},{t}" if r is res
                 else f",,,{t}"))
    print("collectives,olmo-1b,train_4k," + json.dumps(res["collectives"]))
    print("perf,variant,flops_per_chip,bytes_per_chip,"
          "collective_bytes_per_chip,t_compute_s,t_memory_s,"
          "t_collective_s,dominant")
    for v, r in rows.items():
        print(f"perf,{v},{r['flops_per_chip']},{r['bytes_per_chip']},"
              f"{r['collective_bytes_per_chip']},{r['t_compute_s']},"
              f"{r['t_memory_s']},{r['t_collective_s']},{r['dominant']}")
    print(f"dryrun_phase,remat_over_baseline,{remat},one_rank_s,{t_one},"
          f"perf_s,{t_perf},card_bytes_before,{mem0},after,{mem1}")
    if not (res["flops"] > 0 and dec["flops"] > 0):
        raise AssertionError("a dry-run counted no FLOPs")
    if abs(ratio - 1.0) > DRYRUN_RATIO_TOL:
        raise AssertionError(f"256 x per-chip FLOPs / one rank's = {ratio}")
    if ex["flops"] != res["flops"]:
        raise AssertionError(f"the probes extrapolate to {ex['flops']}, "
                             f"the full depth counts {res['flops']}")
    if not REMAT_RANGE[0] <= remat <= REMAT_RANGE[1]:
        raise AssertionError(f"remat_full / baseline FLOPs = {remat}")
    if not rows["no_fsdp"]["collective_bytes_per_chip"] < \
            rows["baseline"]["collective_bytes_per_chip"]:
        raise AssertionError("no_fsdp moves no fewer collective bytes")
    if mem1 > mem0:
        raise AssertionError(f"the dry-run allocated {mem1 - mem0} bytes "
                             "on the card")
    return rows


def counted(kernel, fn):
    """``fn()`` with every kernel's launch counter set to 0 just before
    and read just after: ``(result, {kernel name: launches})``."""
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.ssd_scan import kernel as ssd

    for mod in (kernel, fa, ssd):
        mod.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    counts = {}
    for mod in (kernel, fa, ssd):
        counts.update(mod.launch_counts())
    return out, counts


def add_counts(total, counts):
    for name, n in counts.items():
        total[name] = total.get(name, 0) + n


def bench_phase(kernel, dryrun_dir, perf_rows):
    """The main path's benches (see the module docstring, item 17).
    Returns the kernels' launches by path: ``benches`` (the ``cuda``
    runs of allocator_bench, reconfig_bench and beyond) and
    ``kernels_bench``."""
    from benchmarks_torch import (allocator_bench, beyond, kernels_bench,
                                  reconfig_bench, report, roofline)
    from repro_torch.launch.perf import HBM_BW, NVLINK_BW, PEAK_FLOPS

    engines = ("cuda", "numpy")
    benches = {}
    walls = {}
    out = os.path.join(ROOT, "build", "chip_smoke_bench")
    os.makedirs(out, exist_ok=True)
    try:
        # allocator_bench at 80 jobs with the naive anchor, in turns
        alloc = {}
        for eng in engines:
            t0 = time.perf_counter()
            alloc[eng], counts = counted(kernel, lambda: allocator_bench.main(
                ["--job-scales", "80", "--engine", eng, "--out", ""]))
            walls[f"allocator {eng}"] = time.perf_counter() - t0
            if eng == "cuda":
                add_counts(benches, counts)
                missing = [n for n in ("fitmask_multibox", "fitmask_batched",
                                       "occupancy_counts") if not counts[n]]
                if missing:
                    raise AssertionError(f"allocator_bench on cuda launched "
                                         f"no {missing}: {counts}")
            print(f"bench_alloc,{eng},placements_per_sec," + ",".join(
                f"{label}:{r['80']['placements_per_sec']}"
                for label, r in alloc[eng]["policies"].items())
                + f",naive_rfold_80:"
                f"{alloc[eng]['baseline']['naive_rfold_80']['placements_per_sec']}"
                f",speedup_vs_naive:{alloc[eng]['baseline']['speedup_vs_naive']}")

        def outcome(r):
            return (r["placements"], r["jcr"])
        for label in alloc["numpy"]["policies"]:
            got = outcome(alloc["cuda"]["policies"][label]["80"])
            want = outcome(alloc["numpy"]["policies"][label]["80"])
            if got != want:
                raise AssertionError(f"allocator_bench {label}: (placements,"
                                     f" jcr) {got} on cuda, {want} on numpy")
        naive = [outcome(alloc[e]["baseline"]["naive_rfold_80"])
                 for e in engines]
        if naive[0] != naive[1]:
            raise AssertionError(f"naive anchor {naive[0]} on cuda, "
                                 f"{naive[1]} on numpy")

        # reconfig_bench --quick, in turns
        rec = {}
        for eng in engines:
            t0 = time.perf_counter()
            rec[eng], counts = counted(kernel, lambda: reconfig_bench.main(
                ["--quick", "--engine", eng, "--out", ""]))
            walls[f"reconfig {eng}"] = time.perf_counter() - t0
            if eng == "cuda":
                add_counts(benches, counts)
            head = rec[eng]["headline"]
            print(f"bench_reconfig,{eng},speedups,"
                  f"{json.dumps(head['speedups'])},pass,{head['pass']},"
                  + ",".join(f"{cube}:batched_s:{r['batched']['sim_seconds']}"
                             f":naive_s:{r['naive']['sim_seconds']}"
                             for cube, r in rec[eng]["cube_sizes"].items()))
        for cube, r in rec["numpy"]["cube_sizes"].items():
            for kind in ("batched", "naive"):
                got = outcome(rec["cuda"]["cube_sizes"][cube][kind])
                if got != outcome(r[kind]):
                    raise AssertionError(f"reconfig_bench {cube} {kind}: "
                                         f"{got} on cuda, {outcome(r[kind])} "
                                         "on numpy")
        if not rec["numpy"]["headline"]["pass"]:
            raise AssertionError("reconfig_bench's headline failed on numpy: "
                                 f"{rec['numpy']['headline']}")

        # beyond --runs 1 --num-jobs 200, in turns
        aggs = {}
        for eng in engines:
            path = os.path.join(out, f"beyond_{eng}.json")
            t0 = time.perf_counter()
            _, counts = counted(kernel, lambda: beyond.main(
                ["--runs", "1", "--num-jobs", "200", "--engine", eng,
                 "--out", path]))
            walls[f"beyond {eng}"] = time.perf_counter() - t0
            if eng == "cuda":
                add_counts(benches, counts)
            with open(path) as f:
                aggs[eng] = json.load(f)
        if aggs["cuda"] != aggs["numpy"]:
            raise AssertionError(f"beyond: {aggs['cuda']} on cuda, "
                                 f"{aggs['numpy']} on numpy")
    finally:
        shutil.rmtree(out, ignore_errors=True)

    # kernels_bench on the card: the bench holds each sibling row
    rows = []
    t0 = time.perf_counter()
    _, micro = counted(kernel, lambda: kernels_bench.main(
        [], emit=rows.append))
    walls["kernels_bench"] = time.perf_counter() - t0
    for row in rows:
        print("kernels_bench," + row)
    names = {row.split(",")[0] for row in rows}
    siblings = {"attention_kernel_s256", "attention_kernel_s1024",
                "ssd_kernel_chunk64", "ssd_kernel_chunk256",
                "fitmask_kernel_64cubes"}
    if not siblings <= names:
        raise AssertionError(f"kernels_bench printed no {siblings - names}")

    # roofline and report on the dry-run phase's JSONs
    t0 = time.perf_counter()
    roof = roofline.load_rows(dryrun_dir)
    with open(os.path.join(dryrun_dir, "olmo-1b__train_4k__single.json")
              ) as f:
        ex = json.load(f)["probes"]["extrapolated"]
    row = next(r for r in roof
               if (r["arch"], r["shape"]) == ("olmo-1b", "train_4k"))
    want = {"t_compute_s": ex["flops"] / PEAK_FLOPS["bfloat16"],
            "t_memory_s": ex["bytes"] / HBM_BW,
            "t_collective_s": ex["collective_bytes"] / NVLINK_BW}
    base = perf_rows["baseline"]
    print("roofline,arch,shape,source,t_compute_s,t_memory_s,"
          "t_collective_s,dominant,useful_ratio")
    for r in roof:
        print(f"roofline,{r['arch']},{r['shape']},dryrun,{r['t_compute_s']},"
              f"{r['t_memory_s']},{r['t_collective_s']},{r['dominant']},"
              f"{r['useful_ratio']}")
    print(f"roofline,olmo-1b,train_4k,perf baseline,{base['t_compute_s']},"
          f"{base['t_memory_s']},{base['t_collective_s']},"
          f"{base['dominant']},")
    for key, value in want.items():
        if row[key] != value:
            raise AssertionError(f"roofline {key} = {row[key]}, the dry-run's "
                                 f"counts over the H100 terms give {value}")
    path = os.path.join(dryrun_dir, "roofline", "roofline_torch.json")
    roofline.main(["--dryrun-dir", dryrun_dir, "--out", path])
    print(report.roofline_table(path))
    walls["roofline and report"] = time.perf_counter() - t0
    print("bench_phase,walls_s," + json.dumps(walls))
    return {"benches": benches, "kernels_bench": micro}


def singlepass_path(kernel, device):
    """The single-pass baseline's path: the bench's single-pass section
    at SINGLEPASS_CELL. Returns the K3 launches it made."""
    from benchmarks_torch.fitmask_bench import singlepass_sweep

    kernel.reset_launch_counts()
    singlepass_sweep(kernel, device, lambda fn: device_ms(fn, time_ms(fn)),
                     cells=[SINGLEPASS_CELL])
    torch.cuda.synchronize()
    return kernel.launch_counts()["fitmask_batched"]


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

    print(card_line())
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
    t0 = time.perf_counter()
    scenario = scenario_phase(kernel, device)
    phase_s["scenario main path"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    service = service_phase(kernel, device)
    phase_s["service main path"] = time.perf_counter() - t0
    by_path = {name: {"placement": placement[name], "fleet": fleet[name],
                      "scenario": scenario[name], "service": service[name]}
               for name in placement}
    launches = {name: sum(n.values()) for name, n in by_path.items()}
    for name, count in launches.items():
        if count == 0 and name not in OFF_PATH:
            raise AssertionError(f"{name} never launched on a main path")
    t0 = time.perf_counter()
    rows += seq_kernel_phase(device)
    phase_s["sequence kernels"] = time.perf_counter() - t0
    # Each model's kernel-path prefill is a main path of K4 (and K5):
    # its counts are set to 0 just before it and read just after.
    served = {}
    for arch in SERVED:
        t0 = time.perf_counter()
        served[arch] = serve_phase(device, arch)
        phase_s[f"serve {arch}"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    served.update(family_phase(device))
    phase_s["family sweep"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    served.update(moe_phase(device))
    phase_s["moe"] = time.perf_counter() - t0
    # The xLSTM prefill and the training run are main paths with no
    # kernel on them: their counts are set to 0 before and must read 0.
    t0 = time.perf_counter()
    no_kernel = {XLSTM: xlstm_phase(device)}
    phase_s["xlstm"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    unmeshed = {}
    no_kernel[f"train {TRAIN_ARCH}"] = train_phase(device, unmeshed)
    phase_s["training"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    no_kernel[f"train {TRAIN_ARCH} --mesh 1x1"] = mesh_train_phase(
        device, unmeshed)
    phase_s["mesh training"] = time.perf_counter() - t0
    print("# K4/K5 launches on the paths without a kernel: %s" % no_kernel)
    t0 = time.perf_counter()
    cluster = cluster_phase(kernel, device)
    phase_s["cluster"] = time.perf_counter() - t0
    for name in by_path:
        by_path[name]["cluster"] = cluster[name]
        launches[name] += cluster[name]
    dryrun_dir = os.path.join(ROOT, "build", "chip_smoke_dryrun")
    try:
        t0 = time.perf_counter()
        perf_rows = dryrun_phase(device, dryrun_dir)
        phase_s["dry-run"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        bench = bench_phase(kernel, dryrun_dir, perf_rows)
        phase_s["benches"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(dryrun_dir, ignore_errors=True)
    for name in by_path:
        by_path[name]["benches"] = bench["benches"][name]
        by_path[name]["kernels_bench"] = bench["kernels_bench"][name]
        launches[name] += (bench["benches"][name]
                           + bench["kernels_bench"][name])
    t0 = time.perf_counter()
    baseline = "fitmask_multibox_singlepass_baseline"
    by_path[baseline] = {"fitmask_bench": singlepass_path(kernel, device)}
    launches[baseline] = by_path[baseline]["fitmask_bench"]
    if not launches[baseline]:
        raise AssertionError("the single-pass section launched no K3")
    phase_s["single-pass path"] = time.perf_counter() - t0
    for name in ("flash_attention", "ssd_scan"):
        by_path[name] = {arch: n[name] for arch, n in served.items()
                         if n[name]}
        by_path[name]["kernels_bench"] = bench["kernels_bench"][name]
        launches[name] = sum(by_path[name].values())
    print("# phase seconds: %s; total %.1f s" % (
        ", ".join(f"{k} {v:.1f}" for k, v in phase_s.items()),
        time.perf_counter() - t_start))

    # One entry per kernel, at its heaviest main-path case above (the
    # single-box kernel: its largest in-grid box there; the fused launch:
    # a fleet of six's 8^3 flush; K4: the llama3-8b prefill shape, K5:
    # the zamba2 prefill shape, both in fp32, the type the serve path
    # runs; the single-pass baseline: its one cell).
    heaviest = {"fitmask_multibox": ("cubes 8^3", "box_role", ""),
                "fitmask_batched": ("static 16^3", "box_role", "largest"),
                "occupancy_counts": ("cubes 4^3", "box_role", ""),
                "fitmask_multibox_bucketed": ("fleet 48 x 8^3", "box_role",
                                              ""),
                "flash_attention": ("llama3-8b 32:8", "dtype", "float32"),
                "ssd_scan": ("path", "dtype", "float32"),
                baseline: (f"singlepass {SINGLEPASS_CELL[0][0]}^3",
                           "box_role", "")}
    entries = []
    for name, (case, key, value) in heaviest.items():
        r = next(r for r in rows if r["name"] == name and r["case"] == case
                 and r[key] == value)
        entries.append(dict(
            name=name, route="cuda", source="src/repro_torch/csrc/"
            + SOURCE[name], replaces=REPLACES[name],
            launches=launches[name], launches_by_path=by_path[name],
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
