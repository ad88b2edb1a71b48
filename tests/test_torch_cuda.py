"""Tests of the port that need a CUDA card: the hand-written kernels
against their plain PyTorch versions on the card, the placement loop
the chaos scenarios (fail-stop kill mode too) and the allocator daemon
through the ``cuda`` engine against the host ``numpy`` engine, the smoke models'
forwards (zamba2, the dense-stack and MoE families) through the kernels
against their plain paths, the xlstm smoke model and one smoke train
step on the card against the CPU, K4 and K5 refusing autograd, and
meshes on the card (a process group of one rank, NCCL): ``shard_batch``
and ``distribute_params`` on a 1x1 mesh, a smoke train step on it
against the unmeshed step, the RFold cluster on the ``cuda``
engine training a 1-XPU job, and the benches: ``kernels_bench``'s
kernel rows against its plain rows and a bare section on the card,
``reconfig_bench`` on ``cuda`` against ``numpy``.
Every test is marked ``cuda`` and skips without a card. This file
imports neither JAX nor ``repro``, so it also runs where only the
port's requirements are installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, smoke_variant
from repro_torch.core.allocator import make_policy
from repro_torch.kernels.fitmask import kernel as tk
from repro_torch.kernels.flash_attention import kernel as tfa
from repro_torch.kernels.ssd_scan import kernel as tssd
from repro_torch.models import model as tlm
from repro_torch.sim.simulator import Simulator
from repro_torch.traces.generator import TraceConfig, generate_trace

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _case(seed):
    rng = np.random.default_rng(seed)
    bsz = int(rng.integers(1, 9))
    grid = tuple(int(v) for v in rng.integers(2, 17, size=3))
    boxes = [tuple(int(v) for v in rng.integers(1, 18, size=3))
             for _ in range(int(rng.integers(1, 40)))]
    occ = rng.uniform(size=(bsz,) + grid) < rng.uniform(0.0, 0.5)
    return occ, boxes


@pytest.mark.parametrize("seed", range(6))
def test_kernels_match_plain_on_card(card, seed):
    occ, boxes = _case(seed)
    t = torch.from_numpy(occ).to(card)
    tk.reset_launch_counts()
    assert torch.equal(tk.fitmask_multibox(t, boxes),
                       tk.fitmask_multibox_plain(t, boxes))
    assert torch.equal(tk.fitmask_batched(t, boxes[0]),
                       tk.fitmask_batched_plain(t, boxes[0]))
    assert torch.equal(tk.occupancy_counts(t), tk.occupancy_counts_plain(t))
    planes, counts = tk.fitmask_multibox_bucketed(t, boxes)
    want_planes, want_counts = tk.fitmask_multibox_bucketed_plain(t, boxes)
    assert planes.dtype == torch.bool and torch.equal(planes, want_planes)
    assert torch.equal(counts, want_counts)
    torch.cuda.synchronize()
    assert tk.launch_counts() == {"fitmask_multibox": 1,
                                  "fitmask_batched": 1,
                                  "occupancy_counts": 1,
                                  "fitmask_multibox_bucketed": 1}


def test_kernel_refuses_grid_beyond_shared_memory(card):
    """A 38^3 grid (beyond the old integral image's 37^3) runs; a row
    longer than 64 cells, or row words beyond a block's shared memory,
    is refused with ValueError before any launch."""
    t = torch.from_numpy(np.random.default_rng(1).uniform(
        size=(1, 38, 38, 38)) < 0.01).to(card)
    boxes = [(1, 1, 1), (4, 2, 38), (38, 38, 38)]
    assert torch.equal(tk.fitmask_multibox(t, boxes),
                       tk.fitmask_multibox_plain(t, boxes))
    tk.reset_launch_counts()
    for dims in [(4, 4, 65), (200, 200, 1)]:
        big = torch.zeros((1,) + dims, dtype=torch.bool, device=card)
        with pytest.raises(ValueError, match="at most"):
            tk.fitmask_multibox(big, [(1, 1, 1)])
        with pytest.raises(ValueError, match="at most"):
            tk.fitmask_batched(big, (1, 1, 1))
        with pytest.raises(ValueError, match="at most"):
            tk.fitmask_multibox_bucketed(big, [(1, 1, 1)])
        assert tk.fitmask_multibox(big, []).shape == (1, 0) + dims
    torch.cuda.synchronize()
    assert tk.launch_counts() == {"fitmask_multibox": 0,
                                  "fitmask_batched": 0,
                                  "occupancy_counts": 0,
                                  "fitmask_multibox_bucketed": 0}


def _bit_exact(t, boxes):
    tk.reset_launch_counts()
    got = tk.fitmask_multibox(t, boxes)
    single = tk.fitmask_batched(t, boxes[-1])
    want = tk.fitmask_multibox_plain(t, boxes)
    torch.cuda.synchronize()
    assert tk.launch_counts()["fitmask_multibox"] == 1
    assert tk.launch_counts()["fitmask_batched"] == 1
    assert got.dtype == torch.int32 and torch.equal(got, want)
    assert torch.equal(single, want[:, -1])


@pytest.mark.parametrize("n", [38, 64])
def test_kernel_large_grids_on_card(card, n):
    rng = np.random.default_rng(n)
    t = torch.from_numpy(rng.uniform(size=(1, n, n, n)) < 0.002).to(card)
    _bit_exact(t, [(1, 1, 1), (3, 5, 7), (n, 1, 1), (1, 1, n - 1),
                   (10, 20, n + 1), (n, n, n)])


def test_kernel_z64_box_edges_on_card(card):
    """Z = 64 with boxes of 1, 63, 64 and 65 cells along z: the masks
    of 64 and of 1 low bits, and a box longer than the row."""
    t = torch.from_numpy(np.random.default_rng(2).uniform(
        size=(3, 5, 4, 64)) < 0.02).to(card)
    _bit_exact(t, [(1, 1, 1), (2, 1, 63), (1, 2, 64), (1, 1, 65),
                   (5, 4, 64), (1, 1, 64)])


@pytest.mark.parametrize("z", [3, 5, 13])
def test_kernel_ragged_rows_on_card(card, z):
    """Rows whose length is off the 16-byte load, and stores of odd
    length."""
    rng = np.random.default_rng(z)
    t = torch.from_numpy(rng.uniform(size=(6, 7, 5, z)) < 0.2).to(card)
    _bit_exact(t, [(1, 1, 1), (2, 2, 2), (7, 5, z), (3, 1, z + 1),
                   (1, 6, 1), (2, 3, z - 1)])


def test_kernel_offset_view_on_card(card):
    """occ[1:] of a Z = 3 batch starts 36 bytes into its storage."""
    rng = np.random.default_rng(4)
    full = torch.from_numpy(rng.uniform(size=(5, 4, 3, 3)) < 0.3).to(card)
    t = full[1:]
    assert t.is_contiguous() and t.data_ptr() % 16
    _bit_exact(t, [(1, 1, 1), (2, 2, 2), (4, 3, 3), (1, 1, 4)])


@pytest.mark.parametrize("bsz", [1, 512])
def test_kernel_many_boxes_on_card(card, bsz):
    rng = np.random.default_rng(bsz)
    n = 4 if bsz > 1 else 8
    t = torch.from_numpy(rng.uniform(size=(bsz, n, n, n))
                         < rng.uniform(0.0, 0.4, size=(bsz, 1, 1, 1))
                         ).to(card)
    boxes = [tuple(int(v) for v in rng.integers(1, n + 2, size=3))
             for _ in range(300)]
    _bit_exact(t, boxes)


@pytest.mark.parametrize("mode", tk.OR_MODES)
def test_every_or_mode_matches_plain_on_card(card, mode):
    """Each way the kernel may OR a box's rows, on grids of 16^3, 8^3,
    2^3 and (but for the shuffle, which needs 32 % Y == 0) 64^3: several
    units a block, one grid a block, several grids a block, several
    blocks a grid."""
    rng = np.random.default_rng(len(mode))
    for bsz, n, k in [(1, 16, 20), (8, 8, 40), (100, 2, 8), (1, 64, 3)]:
        if mode == "shuffle" and 32 % n:
            continue
        t = torch.from_numpy(rng.uniform(size=(bsz, n, n, n)) < 0.05).to(card)
        table = tk.box_table([tuple(int(v) for v in rng.integers(
            1, n + 2, size=3)) for _ in range(k)])
        plan = tk.launch_plan(bsz, n, n, n, table, mode=mode)
        assert torch.equal(tk._launch_multibox(t, table, plan),
                           tk.fitmask_multibox_plain(t, table))


def _shapes(n):
    return [(a, b, c) for a in range(1, n + 1) for b in range(1, n + 1)
            for c in range(1, n + 1)]


# (id, B, grid, boxes, kind): the loop's grids (all cubes of 8^3, 4^3
# and 2^3, and one of each), 16^3, 38^3, 64^3, rows of 3, 5 and 13
# cells, K = 0, boxes larger than the grid, a view one grid into its
# storage (kind "offset") and uint8 grids viewed as bool with bytes of 2
# and 255 (kind "bytes").
COUNT_CASES = [
    ("512 x 2^3", 512, (2, 2, 2), _shapes(2), ""),
    ("64 x 4^3", 64, (4, 4, 4), _shapes(4)[::5], ""),
    ("8 x 8^3", 8, (8, 8, 8), _shapes(8)[::7], ""),
    ("1 x 2^3", 1, (2, 2, 2), _shapes(2), ""),
    ("2 x 4^3", 2, (4, 4, 4), _shapes(4), ""),
    ("1 x 8^3", 1, (8, 8, 8), _shapes(8)[::11], ""),
    ("16^3", 2, (16, 16, 16), [(1, 1, 1), (2, 3, 4), (16, 16, 16)], ""),
    ("38^3", 1, (38, 38, 38), [(1, 1, 1), (5, 7, 3), (39, 1, 1)], ""),
    ("64^3", 2, (64, 64, 64), [(1, 1, 1), (3, 5, 7), (1, 1, 65)], ""),
    ("Z 3", 8, (7, 6, 3), _shapes(3), ""),
    ("Z 5", 8, (5, 5, 5), _shapes(5)[::3], ""),
    ("Z 13", 3, (9, 4, 13), [(1, 1, 1), (2, 3, 4), (1, 1, 14)], ""),
    ("K=0", 3, (8, 8, 8), [], ""),
    ("oversize", 4, (4, 4, 4), [(5, 1, 1), (1, 6, 1), (17, 17, 17)], ""),
    ("offset Z 3", 5, (4, 3, 3), _shapes(3), "offset"),
    ("offset 5^3", 9, (5, 5, 5), [(1, 1, 1), (2, 2, 2)], "offset"),
    ("bytes 4^3", 64, (4, 4, 4), [(1, 1, 1), (2, 2, 2), (4, 1, 3)], "bytes"),
    ("bytes 5^3", 3, (5, 5, 5), [(1, 1, 1), (2, 3, 2)], "bytes"),
]


def _grids_on_card(card, seed, bsz, dims, kind):
    rng = np.random.default_rng(seed)
    extra = int(kind == "offset")
    shape = (bsz + extra,) + dims
    if kind == "bytes":
        raw = rng.choice(np.array([0, 1, 2, 255], np.uint8), size=shape,
                         p=[0.6, 0.1, 0.15, 0.15])
        t = torch.from_numpy(raw).to(card).view(torch.bool)
    else:
        dens = rng.uniform(0.0, 0.6, size=(bsz + extra, 1, 1, 1))
        t = torch.from_numpy(rng.uniform(size=shape) < dens).to(card)
    t = t[extra:]
    assert t.is_contiguous() and (t.data_ptr() % 16 != 0) == bool(extra)
    return t


@pytest.mark.parametrize("label,bsz,dims,boxes,kind", COUNT_CASES,
                         ids=[c[0] for c in COUNT_CASES])
def test_counts_and_bucketed_bit_exact_on_card(card, label, bsz, dims, boxes,
                                               kind):
    """K2 and the fused launch against their plain versions, one launch
    a call (K = 0: the fused wrapper's counts are K2's launch)."""
    t = _grids_on_card(card, len(label), bsz, dims, kind)
    want_planes, want_counts = tk.fitmask_multibox_bucketed_plain(t, boxes)
    tk.reset_launch_counts()
    counts = tk.occupancy_counts(t)
    planes, fused = tk.fitmask_multibox_bucketed(t, boxes)
    torch.cuda.synchronize()
    assert counts.dtype == fused.dtype == torch.int32
    assert torch.equal(counts, want_counts) and torch.equal(fused, want_counts)
    assert planes.dtype == torch.bool and torch.equal(planes, want_planes)
    assert tk.launch_counts() == {
        "fitmask_multibox": 0, "fitmask_batched": 0,
        "occupancy_counts": 2 if not boxes else 1,
        "fitmask_multibox_bucketed": 1 if boxes else 0}
    if kind == "bytes":
        assert int(t.view(torch.uint8).max()) == 255


@pytest.mark.parametrize("n", [8, 64, 512, 4096, 54872, 262144, 70001])
def test_every_count_plan_matches_plain_on_card(card, n):
    """Each lane count (1 to 32), cluster size (1 to 8) and batch of
    loads (1 to 8) the counts kernel may take, forced on grids of n
    bytes, aligned and one byte off."""
    rng = np.random.default_rng(n)
    raw = torch.from_numpy(rng.choice(np.array([0, 1, 7], np.uint8),
                                      size=3 * n + 1)).to(card)
    for start in (0, 1):
        t = raw[start:start + 3 * n].view(torch.bool).reshape(3, n, 1, 1)
        want = tk.occupancy_counts_plain(t)
        base = tk.counts_plan(3, n, t.data_ptr())
        plans = [base._replace(batch=batch, lanes=lanes, cluster=0,
                               threads=96, blocks=-(-3 * lanes // 96))
                 for lanes in (1, 2, 4, 8, 16, 32) for batch in (1, 8)]
        plans += [base._replace(batch=batch, lanes=0, cluster=c,
                                threads=256, blocks=3 * c)
                  for c in range(1, 9) for batch in (1, 2, 4, 8)]
        for plan in plans:
            assert torch.equal(tk._launch_counts(t, plan), want), plan
        assert torch.equal(tk.occupancy_counts(t), want)


def test_cuda_engine_bucketed_is_one_launch(card):
    """``CudaEngine.multibox_bucketed``: one launch a call, free counts
    and bool planes equal to the numpy engine's fused answer."""
    from repro_torch.kernels.fitmask import ops as tops
    rng = np.random.default_rng(5)
    occ = rng.uniform(size=(8, 8, 8, 8)) < 0.3
    boxes = _shapes(8)[::9]
    want_planes, want_free = tops.get_engine("numpy").multibox_bucketed(
        occ, boxes)
    tk.reset_launch_counts()
    planes, free = tops.get_engine("cuda", device=card).multibox_bucketed(
        occ, boxes)
    torch.cuda.synchronize()
    assert sum(tk.launch_counts().values()) == 1
    assert tk.launch_counts()["fitmask_multibox_bucketed"] == 1
    assert (planes.cpu().numpy() == want_planes).all()
    assert (free.cpu().numpy() == want_free).all()


@pytest.mark.parametrize("policy,kw", [
    ("firstfit", dict(dims=(8, 8, 8))), ("folding", dict(dims=(8, 8, 8))),
    ("reconfig", dict(num_xpus=512, cube_n=4)),
    ("rfold", dict(num_xpus=512, cube_n=2)),
    ("rfold_be", dict(num_xpus=512, cube_n=4))])
def test_cuda_schedules_match_numpy_on_card(card, policy, kw):
    cfg = TraceConfig(num_jobs=30, seed=3, size_scale=48.0, size_max=512,
                      cluster_xpus=512, target_load=1.5, cube4_budget=8)
    want = Simulator(make_policy(policy, engine="numpy", **kw),
                     generate_trace(cfg)).run()
    tk.reset_launch_counts()
    got = Simulator(make_policy(policy, **kw), generate_trace(cfg)).run()
    assert [(j.start, j.finish, j.dropped, j.placement_meta)
            for j in got.jobs] == \
        [(j.start, j.finish, j.dropped, j.placement_meta) for j in want.jobs]
    assert tk.launch_counts()["fitmask_multibox"] > 0


def test_launch_counts_exact_from_two_threads(card):
    """Two threads x 200 K1 launches (the broker's two flush lanes) count
    exactly 400, and every answer is right."""
    import threading
    occ, boxes = _case(7)
    t = torch.from_numpy(occ).to(card)
    want = tk.fitmask_multibox_plain(t, boxes)
    tk.reset_launch_counts()
    bad = []

    def lane(_):
        for _ in range(200):
            if not torch.equal(tk.fitmask_multibox(t, boxes), want):
                bad.append(1)

    threads = [threading.Thread(target=lane, args=(i,), daemon=True)
               for i in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    assert not any(th.is_alive() for th in threads)
    torch.cuda.synchronize()
    assert not bad
    assert tk.launch_counts()["fitmask_multibox"] == 400


@pytest.mark.parametrize("seed", range(4))
def test_broker_on_cuda_matches_numpy_under_interleaving(card, seed):
    """The fleet broker on the ``cuda`` engine, two lanes, steppers with
    random pauses: every answer equals the numpy engine's, the fused
    bucketed launch answers the multibox flushes, and nothing fails
    over."""
    import threading
    import time

    from repro_torch.core.engineconfig import EngineConfig
    from repro_torch.kernels.fitmask import ops as tops
    from repro_torch.sim.fleet import Fleet

    rng = np.random.default_rng(seed)
    cell = tuple(int(v) for v in rng.integers(2, 9, size=3))
    plans = []
    for _ in range(4):
        steps = []
        for _s in range(int(rng.integers(3, 8))):
            occ = rng.random((int(rng.integers(1, 9)),) + cell) < 0.4
            boxes = tuple(tuple(int(v) for v in rng.integers(1, 5, size=3))
                          for _ in range(int(rng.integers(1, 6))))
            steps.append((occ, boxes if rng.random() < 0.75 else None))
        plans.append(steps)
    broker = Fleet(EngineConfig("cuda", device=card),
                   timeout=0.002).broker
    assert broker.max_inflight == 2
    outs = [[] for _ in plans]
    tk.reset_launch_counts()

    def stepper(i):
        r = np.random.default_rng(seed ^ (i + 1))
        try:
            for occ, boxes in plans[i]:
                time.sleep(float(r.random()) * 0.002)
                outs[i].append(broker.free_counts(occ) if boxes is None
                               else broker.multibox(occ, boxes))
        finally:
            broker.deactivate()

    for _ in plans:
        broker.register()
    threads = [threading.Thread(target=stepper, args=(i,), daemon=True)
               for i in range(len(plans))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    assert not any(th.is_alive() for th in threads)
    oracle = tops.get_engine("numpy")
    for steps, got in zip(plans, outs):
        assert len(got) == len(steps)
        for (occ, boxes), ans in zip(steps, got):
            if boxes is None:
                assert (ans == oracle.free_counts(occ)).all()
            else:
                assert ((ans != 0) == (oracle.multibox(occ, boxes) != 0)).all()
    s = broker.stats
    assert (s.engine_failovers, s.engine_retries, s.canary_checks) == (0, 0, 0)
    counts = tk.launch_counts()
    assert counts["fitmask_multibox_bucketed"] > 0
    assert counts["fitmask_multibox"] == counts["fitmask_batched"] == 0


def test_fleet_eval_on_cuda_matches_numpy(card):
    """A small eval matrix through fleets on the card gives the per-task
    numpy records, with batched calls and no failover."""
    import json

    from repro_torch.core.engineconfig import EngineConfig
    from repro_torch.eval import EvalRunner, make_tasks

    configs = [("RFold (4^3)", "rfold", dict(num_xpus=512, cube_n=4)),
               ("Folding (8^3)", "folding", dict(dims=(8, 8, 8)))]
    tasks = make_tasks(configs, runs=2, num_jobs=25, load=1.5, seed0=100)

    def strip(records):
        return json.dumps([{k: v for k, v in r.items() if k != "sim_s"}
                           for r in records], sort_keys=True)

    want = EvalRunner(workers=0, engine=EngineConfig(
        "numpy", fleet_size=0)).run(tasks)
    runner = EvalRunner(workers=0, engine=EngineConfig("cuda", device=card))
    tk.reset_launch_counts()
    got = runner.run(tasks)
    assert strip(got) == strip(want)
    broker = runner.last_stats["fleet"]["broker"]
    assert broker["engine_failovers"] == 0 and broker["batched_calls"] > 0
    assert tk.launch_counts()["fitmask_multibox_bucketed"] > 0


def test_scenarios_on_cuda_match_numpy(card):
    """node_churn and ocs_degraded on RFold 4^3 at 512 XPUs: the cuda
    engine's records equal the numpy engine's, faults injected, with K1
    and K2 launched. Failed cells are busy cells of the grids the
    kernels read; a dead OCS port only filters cubes on the host."""
    import json

    from repro_torch.core.engineconfig import EngineConfig
    from repro_torch.sim.scenarios import run_scenario

    kw = dict(num_xpus=512, cube_n=4)
    trace_kw = dict(cluster_xpus=512, size_max=512)
    for scenario in ("node_churn", "ocs_degraded"):
        want = run_scenario(scenario, policy_kw=dict(kw, engine="numpy"),
                            num_jobs=120, trace_kw=trace_kw)
        tk.reset_launch_counts()
        got = run_scenario(scenario, policy_kw=dict(
            kw, engine=EngineConfig("cuda", device=card)), num_jobs=120,
            trace_kw=trace_kw)
        counts = tk.launch_counts()
        assert json.dumps(got, sort_keys=True) == \
            json.dumps(want, sort_keys=True), scenario
        assert got["num_faults"] > 0 and got["chaos"]["faults"] > 0
        assert counts["fitmask_multibox"] > 0, (scenario, counts)
        assert counts["occupancy_counts"] > 0, (scenario, counts)


def test_kill_mode_on_cuda_matches_numpy(card):
    """``fault_mode="kill"`` under node_churn on RFold 4^3 at 512 XPUs,
    through the eval runner's ``run_task``: the cuda engine's records
    equal the numpy engine's, every victim killed, K1 and K2 launched."""
    import json

    from repro_torch.core.engineconfig import EngineConfig
    from repro_torch.eval import make_tasks, run_task

    tasks = make_tasks([("RFold (4^3)", "rfold",
                         dict(num_xpus=512, cube_n=4))],
                       runs=2, num_jobs=120, load=1.5, seed0=100,
                       trace_kw=dict(cluster_xpus=512, size_max=512),
                       sim_kw={"fault_mode": "kill"}, scenario="node_churn")

    def strip(recs):
        return json.dumps([{k: v for k, v in r.items() if k != "sim_s"}
                           for r in recs], sort_keys=True)

    want = [run_task(t, engine="numpy") for t in tasks]
    tk.reset_launch_counts()
    got = [run_task(t, engine=EngineConfig("cuda", device=card))
           for t in tasks]
    counts = tk.launch_counts()
    assert strip(got) == strip(want)
    for rec in got:
        ch = rec["chaos"]
        assert ch["victims"] == ch["killed"]
        assert ch["preempted"] == ch["migrated"] == 0
        assert rec["summary"]["num_dropped"] >= ch["killed"]
    assert sum(r["chaos"]["killed"] for r in got) > 0
    assert counts["fitmask_multibox"] > 0, counts
    assert counts["occupancy_counts"] > 0, counts


def test_service_daemon_on_cuda_launches_k1(card):
    """The allocator daemon with no engine argument places on the card:
    a submit/done round trip over TCP launches K1, and every reply and
    the state digest equal a host ``numpy`` core's on the same ops."""
    from repro_torch.serve.scheduler import (AllocatorCore, Scheduler,
                                             SchedulerConfig, protocol)

    kw = dict(num_xpus=512, cube_n=4)
    host = AllocatorCore(SchedulerConfig(policy="rfold", policy_kw=kw,
                                         engine="numpy"))
    ops = [{"op": "submit", "shape": [8, 4, 4]},
           {"op": "submit", "shape": [2, 2, 2]},
           {"op": "submit", "shape": [4, 4, 4]},
           {"op": "done", "job_id": 0}]
    tk.reset_launch_counts()
    with Scheduler(SchedulerConfig(policy="rfold", policy_kw=kw)) as s:
        assert s.config.engine.resolve_name() == "cuda"
        for op in ops:
            want = protocol.decode(protocol.encode(host.apply(dict(op))[0]))
            got = s.client.call(op["op"], **{k: v for k, v in op.items()
                                             if k != "op"})
            assert {k: v for k, v in got.items()
                    if k not in ("seq", "epoch")} == want, op
        status = s.status()
    torch.cuda.synchronize()
    assert tk.launch_counts()["fitmask_multibox"] > 0
    assert status["state_digest"] == host.state_digest()


# Tolerances (atol, rtol) of the sequence kernels against their plain
# versions on the card: the fp32 ones differ only in the order of fp32
# sums; bf16 inputs are compared on the bf16 outputs, one rounding (at
# most 2^-7 of the value) apart. K4's bf16 atol covers outputs near 0
# and stays well under the 0.02-0.04 that a long softmax average comes
# to, so a dropped k tile cannot pass (chip_smoke.py's FA_TOL).
FA_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (4e-3, 1e-2)}
SSD_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (5e-2, 5e-2)}


def _fa_case(seed, dtype, card):
    rng = np.random.default_rng(seed)
    b = int(rng.integers(1, 3))
    kh = int(rng.choice([1, 2, 4]))
    h = kh * int(rng.integers(1, 4))
    d = int(rng.choice([32, 64, 128]))
    s = int(rng.integers(1, 300))
    window = int(rng.choice([0, 1, 7, 64, 1000]))
    q, k, v = (torch.from_numpy(rng.normal(size=shape).astype(np.float32))
               .to(card, dtype) for shape in
               ((b, s, h, d), (b, s, kh, d), (b, s, kh, d)))
    return q, k, v, window or None


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("seed", [0, 1])
def test_flash_attention_matches_plain_on_card(card, seed, dtype):
    q, k, v, window = _fa_case(seed, dtype, card)
    tfa.reset_launch_counts()
    got = tfa.flash_attention(q, k, v, causal=True, window=window)
    want = tfa.flash_attention_plain(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    assert tfa.launch_counts() == {"flash_attention": 1}
    assert got.dtype == dtype and got.shape == q.shape
    atol, rtol = FA_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)


# Tile edges of the K4 kernels (64 q rows a block in fp32, 16 a warp in
# bf16; 64-key tiles): S below one tile and one past a tile, ragged S,
# head widths 32 and 128 with GQA 4:1, and the narrowest windows.
FA_EDGES = [  # B, S, H, KH, D, window
    (1, 10, 2, 2, 64, None),
    (2, 1000, 8, 2, 32, None),
    (1, 4097, 4, 1, 128, None),
    (1, 1000, 4, 1, 128, None),
    (1, 300, 4, 1, 64, 1),
    (1, 1000, 4, 4, 32, 64),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FA_EDGES)
def test_flash_attention_tile_edges_on_card(card, case, dtype):
    b, s, h, kh, d, window = case
    rng = np.random.default_rng(s + d)
    q, k, v = (torch.from_numpy(rng.normal(size=shape).astype(np.float32))
               .to(card, dtype) for shape in
               ((b, s, h, d), (b, s, kh, d), (b, s, kh, d)))
    tfa.reset_launch_counts()
    got = tfa.flash_attention(q, k, v, causal=True, window=window)
    want = tfa.flash_attention_plain(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    assert tfa.launch_counts() == {"flash_attention": 1}
    atol, rtol = FA_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)


def _ssd_case(seed, dtype, card):
    rng = np.random.default_rng(seed)
    b, h = int(rng.integers(1, 3)), int(rng.integers(1, 5))
    p, n = int(rng.choice([8, 32, 64])), int(rng.choice([4, 16, 64]))
    chunk = int(rng.choice([16, 32, 64]))
    s = chunk * int(rng.integers(1, 5))

    def t(arr, ty=torch.float32):
        return torch.from_numpy(arr.astype(np.float32)).to(card, ty)

    return (t(rng.normal(size=(b, s, h, p)), dtype),
            t(rng.uniform(0.01, 0.2, size=(b, s, h))),
            t(-rng.uniform(0.5, 2.0, size=(h,))),
            t(rng.normal(size=(b, s, h, n)), dtype),
            t(rng.normal(size=(b, s, h, n)), dtype),
            t(rng.normal(size=(h,))), chunk)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("seed", [0, 1])
def test_ssd_scan_matches_plain_on_card(card, seed, dtype):
    x, dt, a, b, c, d, chunk = _ssd_case(seed, dtype, card)
    atol, rtol = SSD_TOL[dtype]
    tssd.reset_launch_counts()
    for d_skip in (d, None):
        y, st = tssd.ssd_scan(x, dt, a, b, c, chunk=chunk, d_skip=d_skip)
        y0, st0 = tssd.ssd_scan_plain(x, dt, a, b, c, chunk=chunk,
                                      d_skip=d_skip)
        torch.cuda.synchronize()
        assert y.dtype == dtype and st.dtype == torch.float32
        torch.testing.assert_close(y.float(), y0.float(), rtol=rtol,
                                   atol=atol)
        if dtype == torch.float32:
            torch.testing.assert_close(st, st0, rtol=1e-4, atol=1e-4)
    assert tssd.launch_counts() == {"ssd_scan": 2}


def _ssd_inputs(rng, b, s, h, g, p, n, dtype, card):
    def t(arr, ty=torch.float32):
        return torch.from_numpy(arr.astype(np.float32)).to(card, ty)

    return (t(rng.normal(size=(b, s, h, p)), dtype),
            t(rng.uniform(0.01, 0.2, size=(b, s, h))),
            t(-rng.uniform(0.5, 2.0, size=(h,))),
            t(rng.normal(size=(b, s, g, n)), dtype),
            t(rng.normal(size=(b, s, g, n)), dtype),
            t(rng.normal(size=(h,))))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_few_blocks_on_card(card, dtype):
    """Batch 1 and two heads: 2 blocks a chunk, far fewer than the SMs."""
    x, dt, a, b, c, d = _ssd_inputs(np.random.default_rng(20), 1, 512, 2,
                                    2, 64, 64, dtype, card)
    tssd.reset_launch_counts()
    y, st = tssd.ssd_scan(x, dt, a, b, c, chunk=128, d_skip=d)
    y0, st0 = tssd.ssd_scan_plain(x, dt, a, b, c, chunk=128, d_skip=d)
    torch.cuda.synchronize()
    assert tssd.launch_counts() == {"ssd_scan": 1}
    atol, rtol = SSD_TOL[dtype]
    torch.testing.assert_close(y.float(), y0.float(), rtol=rtol, atol=atol)
    if dtype == torch.float32:
        torch.testing.assert_close(st, st0, rtol=1e-4, atol=1e-4)


def test_ssd_scan_sizes_off_the_tile_on_card(card):
    """P and N that are not multiples of 4 take the 1 x 1 tile code."""
    x, dt, a, b, c, d = _ssd_inputs(np.random.default_rng(23), 2, 96, 3,
                                    3, 6, 5, torch.float32, card)
    y, st = tssd.ssd_scan(x, dt, a, b, c, chunk=12, d_skip=d)
    y0, st0 = tssd.ssd_scan_plain(x, dt, a, b, c, chunk=12, d_skip=d)
    torch.cuda.synchronize()
    torch.testing.assert_close(y, y0, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(st, st0, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("groups", [1, 2, 4])
def test_ssd_scan_grouped_bc_on_card(card, groups):
    """B and C per group against the plain version on the same values
    broadcast to the 4 heads."""
    x, dt, a, b, c, d = _ssd_inputs(np.random.default_rng(21 + groups), 2,
                                    256, 4, groups, 32, 16, torch.float32,
                                    card)
    y, st = tssd.ssd_scan(x, dt, a, b, c, chunk=64, d_skip=d)
    bh, ch = (torch.repeat_interleave(t, 4 // groups, dim=2) for t in (b, c))
    y0, st0 = tssd.ssd_scan_plain(x, dt, a, bh, ch, chunk=64, d_skip=d)
    torch.cuda.synchronize()
    torch.testing.assert_close(y, y0, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(st, st0, rtol=1e-4, atol=1e-4)


def test_ssd_scan_path_chunk_fits_and_a_longer_one_is_refused(card):
    """A block keeps one chunk's B, C and masked matrix in shared memory
    and its y in registers: chunk 128 fits at P = N = 64, chunk 256 is
    refused with the sizes in the message."""
    x, dt, a, b, c, d = _ssd_inputs(np.random.default_rng(22), 1, 512, 2,
                                    1, 64, 64, torch.float32, card)
    y, st = tssd.ssd_scan(x, dt, a, b, c, chunk=128, d_skip=d)
    y0, st0 = tssd.ssd_scan_plain(x, dt, a, b, c, chunk=128, d_skip=d)
    torch.cuda.synchronize()
    torch.testing.assert_close(y, y0, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(st, st0, rtol=1e-4, atol=1e-4)
    with pytest.raises(RuntimeError, match="S = 512, chunk = 256"):
        tssd.ssd_scan(x, dt, a, b, c, chunk=256, d_skip=d)


def test_ssd_scan_refuses_a_partial_chunk(card):
    x = torch.zeros((1, 48, 2, 8), device=card)
    b = torch.zeros((1, 48, 2, 16), device=card)
    dt = torch.zeros((1, 48, 2), device=card)
    a = torch.zeros(2, device=card)
    with pytest.raises(ValueError, match="S = 48, chunk = 32"):
        tssd.ssd_scan(x, dt, a, b, b, chunk=32)


def test_ssd_scan_refuses_a_chunk_beyond_shared_memory(card):
    # A 256-step chunk at P = N = 64 needs about 470 KB of shared memory.
    x = torch.zeros((1, 256, 1, 64), device=card)
    dt, a = torch.zeros((1, 256, 1), device=card), torch.zeros(1, device=card)
    with pytest.raises(RuntimeError, match="S = 256, chunk = 256"):
        tssd.ssd_scan(x, dt, a, x, x, chunk=256)
    # the refusal leaves no CUDA error behind for the next launch
    y, _ = tssd.ssd_scan(x, dt, a, x, x, chunk=128)
    assert torch.equal(y, torch.zeros_like(y))


def _strided(t):
    """The same values as ``t``, in a tensor that is not contiguous."""
    return torch.cat([t, t], dim=-1)[..., :t.shape[-1]]


def test_kernels_take_strided_inputs(card):
    q, k, v, window = _fa_case(0, torch.float32, card)
    torch.testing.assert_close(
        tfa.flash_attention(*map(_strided, (q, k, v)), window=window),
        tfa.flash_attention_plain(q, k, v, window=window),
        rtol=1e-5, atol=1e-5)
    x, dt, a, b, c, d, chunk = _ssd_case(0, torch.float32, card)
    torch.testing.assert_close(
        tssd.ssd_scan(_strided(x), dt, a, _strided(b), _strided(c),
                      chunk=chunk, d_skip=d),
        tssd.ssd_scan_plain(x, dt, a, b, c, chunk=chunk, d_skip=d),
        rtol=1e-4, atol=1e-4)


def test_smoke_forward_through_kernels_matches_plain_on_card(card):
    cfg = smoke_variant(get_config("zamba2-1.2b"), n_layers=5)
    params = tlm.init_model(cfg, torch.Generator(card).manual_seed(0), card)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 64))).to(card)
    want, _ = tlm.forward(cfg, params, {"tokens": toks})
    tfa.reset_launch_counts()
    tssd.reset_launch_counts()
    got, _ = tlm.forward(cfg, params, {"tokens": toks}, use_kernel=True)
    torch.cuda.synchronize()
    # two groups of (shared attention + 2 mamba) and one leftover mamba
    assert tfa.launch_counts() == {"flash_attention": 2}
    assert tssd.launch_counts() == {"ssd_scan": 5}
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


# K4 at each head layout of the dense-stack families (H:KH, D), against
# its plain version: GQA groups of 4, 3, 8 and 7, and MHA at 128 and 64.
FAMILY_LAYOUTS = {  # arch: (H, KH, D)
    "llama3-8b": (32, 8, 128), "phi4-mini-3.8b": (24, 8, 128),
    "olmo-1b": (16, 16, 128), "qwen1.5-110b": (64, 8, 128),
    "qwen2-vl-7b": (28, 4, 128), "musicgen-medium": (24, 24, 64),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("arch", sorted(FAMILY_LAYOUTS))
def test_flash_attention_family_layouts_on_card(card, arch, dtype):
    h, kh, d = FAMILY_LAYOUTS[arch]
    rng = np.random.default_rng(h + kh + d)
    b, s = 1, 333
    q, k, v = (torch.from_numpy(rng.normal(size=shape).astype(np.float32))
               .to(card, dtype) for shape in
               ((b, s, h, d), (b, s, kh, d), (b, s, kh, d)))
    tfa.reset_launch_counts()
    got = tfa.flash_attention(q, k, v, causal=True, window=8192)
    want = tfa.flash_attention_plain(q, k, v, causal=True, window=8192)
    torch.cuda.synchronize()
    assert tfa.launch_counts() == {"flash_attention": 1}
    atol, rtol = FA_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)


def _family_batch(cfg, card):
    rng = np.random.default_rng(1)
    shape = ((2, cfg.n_codebooks, 64) if cfg.arch_type == "audio"
             else (2, 64))
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, shape)).to(card)}
    if cfg.arch_type == "vlm":
        batch["positions"] = torch.arange(
            64, dtype=torch.int32, device=card)[None, :, None].expand(2, 64, 3)
        batch["patch_embeds"] = torch.from_numpy(
            rng.normal(size=(2, 64, cfg.d_model)).astype(np.float32)).to(card)
        mask = torch.zeros((2, 64), dtype=torch.bool, device=card)
        mask[:, :8] = True
        batch["patch_mask"] = mask
    return batch


@pytest.mark.parametrize("arch", sorted(FAMILY_LAYOUTS))
def test_family_smoke_forward_through_kernel_matches_plain_on_card(card,
                                                                   arch):
    """One kernel-path prefill per family at smoke width (qwen2-vl with
    arange positions and spliced patches), one K4 launch per layer."""
    cfg = smoke_variant(get_config(arch), n_layers=3)
    params = tlm.init_model(cfg, torch.Generator(card).manual_seed(0), card)
    batch = _family_batch(cfg, card)
    want, _ = tlm.forward(cfg, params, batch)
    tfa.reset_launch_counts()
    got, _ = tlm.forward(cfg, params, batch, use_kernel=True)
    torch.cuda.synchronize()
    assert tfa.launch_counts() == {"flash_attention": 3}
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


# -- the MoE families (llama4-scout on K4, deepseek-v2 with MLA) -----------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_llama4_scout_layout_on_card(card, dtype):
    """K4 at llama4-scout's GQA 40:8 (groups of 5), D 128."""
    rng = np.random.default_rng(40)
    b, s = 1, 333
    q, k, v = (torch.from_numpy(rng.normal(size=shape).astype(np.float32))
               .to(card, dtype) for shape in
               ((b, s, 40, 128), (b, s, 8, 128), (b, s, 8, 128)))
    tfa.reset_launch_counts()
    got = tfa.flash_attention(q, k, v, causal=True, window=8192)
    want = tfa.flash_attention_plain(q, k, v, causal=True, window=8192)
    torch.cuda.synchronize()
    assert tfa.launch_counts() == {"flash_attention": 1}
    atol, rtol = FA_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("arch,launches", [("llama4-scout-17b-a16e", 3),
                                           ("deepseek-v2-236b", 0)])
def test_moe_smoke_forward_through_kernel_on_card(card, arch, launches):
    """One kernel-path prefill per MoE family at smoke width: K4 once per
    layer without MLA, never with it; logits against the plain path, and
    a second kernel-path forward bit for bit (the dispatch's combine adds
    in a fixed order)."""
    cfg = smoke_variant(get_config(arch), n_layers=3)
    params = tlm.init_model(cfg, torch.Generator(card).manual_seed(0), card)
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 64))).to(card)
    want, want_aux = tlm.forward(cfg, params, {"tokens": toks})
    tfa.reset_launch_counts()
    got, aux = tlm.forward(cfg, params, {"tokens": toks}, use_kernel=True)
    torch.cuda.synchronize()
    assert tfa.launch_counts() == {"flash_attention": launches}
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(aux, want_aux, rtol=1e-5, atol=1e-6)
    again, aux2 = tlm.forward(cfg, params, {"tokens": toks}, use_kernel=True)
    assert torch.equal(again, got) and torch.equal(aux2, aux)


def test_singlepass_baseline_bit_exact_against_k1_on_card(card):
    """K launches of K3 stacked equal one K1 launch at 16^3, B 8, K 4,
    and each K3 launch is counted."""
    rng = np.random.default_rng(16)
    occ = torch.from_numpy(rng.uniform(size=(8, 16, 16, 16)) < 0.3).to(card)
    boxes = [(4, 4, 4), (8, 4, 2), (2, 2, 2), (16, 2, 2)]
    tk.reset_launch_counts()
    got = tk.fitmask_multibox_singlepass_baseline(occ, boxes)
    want = tk.fitmask_multibox(occ, boxes)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(
        got, tk.fitmask_multibox_singlepass_baseline_plain(occ, boxes))
    assert tk.launch_counts()["fitmask_batched"] == 4
    assert tk.launch_counts()["fitmask_multibox"] == 1


def test_init_model_holds_one_layer_beside_the_stack_on_card(card):
    """A scanned segment's stack is filled layer by layer: init's peak is
    the model plus about one layer (a layer's leaf is briefly held twice
    while it is scaled), not the model twice as with a list of layers
    stacked at the end."""
    cfg = smoke_variant(get_config("llama4-scout-17b-a16e"), n_layers=8,
                        d_model=512, moe_d_ff=1024)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    params = tlm.init_model(cfg, torch.Generator(card).manual_seed(0), card)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    total = sum(t.numel() * t.element_size() for t in tlm.tree_leaves(params))
    layer = sum(t[0].numel() * t.element_size()
                for t in tlm.tree_leaves(params["segments"][0]))
    assert peak <= total + 2 * layer, (peak, total, layer)
    assert 2 * layer < total - 2 * layer   # the bound tells the two apart


# -- xLSTM and training ------------------------------------------------------

def test_kernels_refuse_autograd_on_card(card):
    """K4 and K5 write their outputs through raw pointers, so the outputs
    carry no autograd history: with grad mode on and an input requiring
    grad each raises instead of cutting the gradient; under no_grad, or
    with no input requiring grad, each launches. train_step with
    use_kernel=True on the card therefore raises."""
    from repro_torch.train.data import synthetic_batches
    from repro_torch.train.optim import OptimConfig, init_opt_state
    from repro_torch.train.train_step import train_step

    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, 64, 4, 64)).astype(
        np.float32)).to(card) for _ in range(3))
    x = torch.from_numpy(rng.normal(size=(1, 64, 2, 32)).astype(
        np.float32)).to(card)
    dt = torch.full((1, 64, 2), 0.1, device=card)
    a = -torch.ones(2, device=card)
    bc = torch.from_numpy(rng.normal(size=(1, 64, 1, 16)).astype(
        np.float32)).to(card)
    with pytest.raises(RuntimeError, match="no backward"):
        tfa.flash_attention(q.requires_grad_(), k, v)
    with pytest.raises(RuntimeError, match="no backward"):
        tssd.ssd_scan(x.requires_grad_(), dt, a, bc, bc, chunk=16)
    tfa.reset_launch_counts()
    tssd.reset_launch_counts()
    with torch.no_grad():
        tfa.flash_attention(q, k, v)
        tssd.ssd_scan(x, dt, a, bc, bc, chunk=16)
    torch.cuda.synchronize()
    assert tfa.launch_counts() == {"flash_attention": 1}
    assert tssd.launch_counts() == {"ssd_scan": 1}

    cfg = smoke_variant(get_config("olmo-1b"))
    params = tlm.init_model(cfg, torch.Generator(card).manual_seed(0), card)
    batch = next(synthetic_batches(cfg, 2, 16, seed=0, device=card))
    oc = OptimConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    with pytest.raises(RuntimeError, match="no backward"):
        train_step(cfg, oc, params, init_opt_state(params), batch,
                   use_kernel=True)


def test_xlstm_smoke_forward_and_decode_on_card_match_cpu(card):
    """The same parameters on the card and on the CPU: the forward (the
    sLSTM loop, the mLSTM parallel form) and six decode steps from
    m = -inf, with no NaN, and decode against the forward."""
    from repro_torch.serve import engine

    cfg = smoke_variant(get_config("xlstm-1.3b"), n_layers=4)
    host = tlm.init_model(cfg, torch.Generator().manual_seed(0),
                          torch.device("cpu"))
    params = tlm.tree_map(lambda t: t.to(card), host)
    b, s = 2, 6
    toks = torch.from_numpy(np.random.default_rng(6).integers(
        0, cfg.vocab_size, (b, 32)))
    want, _ = tlm.forward(cfg, host, {"tokens": toks})
    got, _ = tlm.forward(cfg, params, {"tokens": toks.to(card)},
                         use_kernel=True)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    state = engine.init_state(cfg, b, window=s, device=card)
    hstate = engine.init_state(cfg, b, window=s, device=torch.device("cpu"))
    for t in range(s):
        pos = torch.full((b, 1), t, dtype=torch.int32)
        lg, state = engine.serve_step(cfg, params, state,
                                      {"tokens": toks[:, t:t + 1].to(card),
                                       "positions": pos.to(card)})
        hl, hstate = engine.serve_step(cfg, host, hstate,
                                       {"tokens": toks[:, t:t + 1],
                                        "positions": pos})
        torch.testing.assert_close(lg.cpu(), hl, rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(lg[:, 0].cpu(), want[:, t], rtol=2e-3,
                                   atol=2e-3)
    for a, h in zip(tlm.tree_leaves(state), tlm.tree_leaves(hstate)):
        assert not torch.isnan(a).any()
        torch.testing.assert_close(a.cpu(), h, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", ["olmo-1b", "xlstm-1.3b"])
def test_smoke_train_step_on_card_matches_cpu(card, arch):
    """One train step from the same params and batch on the card and on
    the CPU: the loss; the grads within rtol 1e-4 and 1e-4 of each
    leaf's largest grad (at least 1e-6: another order of fp32 sums moves
    the xLSTM's grads by more than an elementwise 1e-6); AdamW from the
    same grads within 1e-6; the card's step finite."""
    from repro_torch.train.data import synthetic_batches
    from repro_torch.train.optim import (OptimConfig, adamw_update,
                                         init_opt_state)
    from repro_torch.train.train_step import train_step, value_and_grad

    cfg = smoke_variant(get_config(arch))
    cpu = torch.device("cpu")
    host = tlm.init_model(cfg, torch.Generator().manual_seed(0), cpu)
    params = tlm.tree_map(lambda t: t.to(card), host)
    hbatch = next(synthetic_batches(cfg, 2, 16, seed=0, device=cpu))
    batch = {k: v.to(card) for k, v in hbatch.items()}
    (_, m), grads = value_and_grad(cfg, params, batch)
    (_, hm), hgrads = value_and_grad(cfg, host, hbatch)
    assert float(m["ce"]) == pytest.approx(float(hm["ce"]), rel=1e-5)
    for g, h in zip(tlm.tree_leaves(grads), tlm.tree_leaves(hgrads)):
        atol = max(1e-6, 1e-4 * float(h.abs().max()))
        torch.testing.assert_close(g.cpu(), h, rtol=1e-4, atol=atol)
    oc = OptimConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    p1 = adamw_update(oc, params, tlm.tree_map(lambda h: h.to(card), hgrads),
                      init_opt_state(params))[0]
    h1 = adamw_update(oc, host, hgrads, init_opt_state(host))[0]
    for a, h in zip(tlm.tree_leaves(p1), tlm.tree_leaves(h1)):
        torch.testing.assert_close(a.cpu(), h, rtol=1e-6, atol=1e-6)
    p2, o2, m2 = train_step(cfg, oc, params, init_opt_state(params), batch)
    assert all(bool(torch.isfinite(t).all()) for t in tlm.tree_leaves(p2))
    assert int(o2["step"]) == 1
    assert float(m2["ce"]) == pytest.approx(float(m["ce"]), rel=1e-6)


# ----------------------------------------------------------------------
# Meshes on the card: a process group of one rank (NCCL)
# ----------------------------------------------------------------------

@pytest.fixture
def nccl1(card):
    import torch.distributed as dist

    from repro_torch.launch.mesh import ensure_process_group
    assert ensure_process_group(card)
    try:
        yield card
    finally:
        dist.destroy_process_group()


def test_shard_batch_and_distribute_params_on_a_1x1_mesh(nccl1):
    from torch.distributed.tensor import DTensor

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel import sharding as ts
    from repro_torch.train.data import shard_batch, synthetic_batches

    cfg = smoke_variant(get_config("olmo-1b"))
    mesh = make_mesh((1, 1), ("data", "model"))
    assert mesh.device_type == "cuda"
    batch = next(synthetic_batches(cfg, 2, 16, seed=0, device=nccl1))
    for k, v in shard_batch(batch, mesh).items():
        assert isinstance(v, DTensor) and v.to_local().is_cuda
        assert torch.equal(v.full_tensor(), batch[k])
    params = tlm.init_model(cfg, torch.Generator(nccl1).manual_seed(0),
                            nccl1)
    dp = ts.distribute_params(params, mesh, ts.rules_for(mesh))
    for a, b in zip(tlm.tree_leaves(params), tlm.tree_leaves(dp)):
        assert isinstance(b, DTensor) and torch.equal(b.full_tensor(), a)


def test_smoke_train_step_on_a_1x1_mesh_matches_unmeshed_on_card(nccl1):
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel import sharding as ts
    from repro_torch.train.data import shard_batch, synthetic_batches
    from repro_torch.train.optim import (OptimConfig, adamw_update,
                                         init_opt_state)
    from repro_torch.train.train_step import train_step, value_and_grad

    cfg = smoke_variant(get_config("olmo-1b"))
    mesh = make_mesh((1, 1), ("data", "model"))
    rules = ts.rules_for(mesh)
    params = tlm.init_model(cfg, torch.Generator(nccl1).manual_seed(0),
                            nccl1)
    batch = next(synthetic_batches(cfg, 2, 16, seed=0, device=nccl1))
    oc = OptimConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    opt = init_opt_state(params)
    (_, m1), g1 = value_and_grad(cfg, params, batch)
    dp = ts.distribute_params(params, mesh, rules)
    with ts.logical_rules(rules):
        p2, _, m2 = train_step(cfg, oc, dp, init_opt_state(dp),
                               shard_batch(batch, mesh))
        (_, _), g2 = value_and_grad(cfg, dp, shard_batch(batch, mesh))
    assert float(m2["ce"].full_tensor()) == pytest.approx(float(m1["ce"]),
                                                          rel=1e-5)
    g2 = tlm.tree_map(ts.full_tensor, g2)
    for a, b in zip(tlm.tree_leaves(g1), tlm.tree_leaves(g2)):
        torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-6)
    own = adamw_update(oc, params, g2, opt)[0]
    for a, b in zip(tlm.tree_leaves(own), tlm.tree_leaves(p2)):
        torch.testing.assert_close(b.full_tensor(), a, rtol=1e-5, atol=1e-6)


def test_rfold_cluster_on_the_cuda_engine_trains_a_1_xpu_job(nccl1):
    from repro_torch.core.geometry import JobShape
    from repro_torch.kernels.fitmask import kernel
    from repro_torch.launch.cluster import RFoldCluster

    kernel.reset_launch_counts()
    cluster = RFoldCluster(num_xpus=64, cube_n=2)
    host = RFoldCluster(num_xpus=64, cube_n=2, engine="numpy", device="cpu")
    job = cluster.submit(0, "olmo-1b", JobShape((1, 1, 1)), seed=0)
    assert job["placement"] == host.submit(
        0, "olmo-1b", JobShape((1, 1, 1)), seed=0)["placement"]
    counts = kernel.launch_counts()
    assert counts["occupancy_counts"] > 0
    assert counts["fitmask_multibox"] + counts["fitmask_batched"] > 0
    losses = cluster.run_steps(0, 2)
    assert losses == pytest.approx(host.run_steps(0, 2), rel=1e-4)
    cluster.finish(0)
    assert cluster.utilization() == 0.0


def test_kernels_bench_sibling_rows_agree_with_their_plain_rows(card):
    """The bench holds each kernel row against its plain row on the card
    (K4 within FA_TOL in bf16, K5 within SSD_TOL in fp32, K3 bit-exact)
    and raises on a mismatch; K5's 256-step chunk is refused."""
    from benchmarks_torch import kernels_bench

    rows = []
    kernels_bench.main([], emit=rows.append)
    by_name = {r.split(",")[0]: r.split(",")[1] for r in rows[1:]}
    for name in ("attention_kernel_s256", "attention_kernel_s1024",
                 "ssd_kernel_chunk64", "fitmask_kernel_64cubes"):
        assert float(by_name[name]) > 0, name
    assert by_name["ssd_kernel_chunk256"] == "refused"


def test_kernels_bench_section_defaults_to_the_card(card):
    """A bare section runs on the card, its kernel row included."""
    from benchmarks_torch import kernels_bench

    rows = []
    kernels_bench.bench_fitmask(rows.append)
    assert [r.split(",")[0] for r in rows] == [
        "fitmask_numpy_16cube", "fitmask_reduce_window_64cubes",
        "fitmask_kernel_64cubes"]


def test_reconfig_bench_on_cuda_gives_numpys_placements(card):
    from benchmarks_torch import reconfig_bench

    got = reconfig_bench.main(["--num-jobs", "12", "--out", ""])
    want = reconfig_bench.main(["--num-jobs", "12", "--engine", "numpy",
                                "--out", ""])
    assert got["engine"] == "cuda" and want["engine"] == "numpy"
    for cube, w in want["cube_sizes"].items():
        for kind in ("batched", "naive"):
            g = got["cube_sizes"][cube][kind]
            assert (g["placements"], g["jcr"]) == \
                (w[kind]["placements"], w[kind]["jcr"]), (cube, kind)
