"""The port's launch layer on the CPU: meshes over process groups,
``shard_batch``, the RFold cluster driver, ``launch.train --mesh``, the
dry-run and the perf variants.

- Four gloo ranks, started as ``torchrun`` starts them (``RANK`` and
  ``WORLD_SIZE`` in the environment of four subprocesses), train one
  step of olmo-1b, llama3-8b, xlstm-1.3b and llama4-scout smoke on a
  2x2 mesh and decode with
  zamba2 smoke from a sharded state; each is held against the
  single-device port (itself held against ``repro`` in
  tests/test_torch_train.py and tests/test_torch_model.py) within
  rtol 1e-5 / atol 1e-6: losses, gradients and logits elementwise, the
  decode state within 1e-5 of each leaf's largest magnitude (its conv
  state holds projections that cancel to 1e-2 from terms of 3, and the
  sharded matmuls sum them in another order: 3.4e-6 apart). The AdamW
  update of the sharded step is held to the single-device update of
  its own gradients: Adam's first step
  divides each gradient by its own magnitude, so gradients of 1e-8 that
  move by 1e-9 with the order of the sharded sums move their parameter
  by up to 1e-4 (lr 1e-3). Every rank makes the same RFold placements.
- A fake process group of 8 ranks (this process is rank 0) carries the
  mini dry-runs of tests/test_launch.py:82-177 and every perf variant.

Process groups are destroyed by fixtures; the ranks run in subprocesses.
"""
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.core.allocator import RFoldPolicy as JRFoldPolicy
from repro.core.geometry import JobShape as JJobShape
from repro_torch.configs import get_config, smoke_variant
from repro_torch.configs.shapes import SHAPES, InputShape, smoke_shape
from repro_torch.core.engineconfig import EngineConfig
from repro_torch.core.geometry import JobShape
from repro_torch.launch import cluster as tcluster
from repro_torch.launch import dryrun, perf
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import train as train_launcher
from repro_torch.models import model as tlm
from repro_torch.parallel import sharding as ts
from repro_torch.train.data import shard_batch, synthetic_batches
from repro_torch.train.optim import OptimConfig, adamw_update, init_opt_state
from repro_torch.train.train_step import train_step, value_and_grad

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture
def fake8():
    dryrun.fake_process_group(8)
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.fixture
def gloo1():
    """A one-rank gloo group, as the launchers start it on the CPU."""
    assert tmesh.ensure_process_group("cpu")
    try:
        yield
    finally:
        dist.destroy_process_group()


# ----------------------------------------------------------------------
# Meshes
# ----------------------------------------------------------------------

def test_mesh_from_allocation_order(fake8):
    coords = [(0, 0, i) for i in range(dist.get_world_size())]
    n = len(coords)
    mesh = tmesh.mesh_from_allocation(coords, (n, 1), ("data", "model"),
                                      device="cpu")
    assert tuple(mesh.shape) == (n, 1)
    assert mesh.mesh_dim_names == ("data", "model")
    assert mesh.mesh.reshape(-1).tolist() == list(range(n))
    # a deployment passes the rank at each coordinate, in ring order
    order = [5, 4, 7, 6]
    mesh = tmesh.mesh_from_allocation(coords[:4], (2, 2), ("data", "model"),
                                      ranks=order, device="cpu")
    assert mesh.mesh.tolist() == [[5, 4], [7, 6]]
    assert mesh.get_coordinate() is None        # rank 0 is outside it
    with pytest.raises(ValueError, match="mesh needs 4"):
        tmesh.mesh_from_allocation(coords[:3], (2, 2), ("data", "model"),
                                   device="cpu")
    with pytest.raises(ValueError, match="only 8 ranks"):
        tmesh.mesh_from_allocation([(0, 0, i) for i in range(16)], (16, 1),
                                   ("data", "model"), device="cpu")


def test_make_mesh_never_shrinks(fake8):
    assert tuple(tmesh.make_mesh((4, 2), ("data", "model"),
                                 device="cpu").shape) == (4, 2)
    with pytest.raises(ValueError, match="needs 16 ranks"):
        tmesh.make_mesh((4, 4), ("data", "model"), device="cpu")


def test_production_mesh_needs_its_ranks(fake8):
    with pytest.raises(ValueError, match="needs 256 ranks"):
        tmesh.make_production_mesh(device="cpu")


def test_mesh_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.ensure_process_group()
    assert not dist.is_initialized()


def test_shard_batch_single_device(gloo1):
    cfg = smoke_variant(get_config("olmo-1b"))
    mesh = tmesh.make_mesh((1,), ("data",), device="cpu")
    batch = next(synthetic_batches(cfg, 2, 8, seed=0, device="cpu"))
    out = shard_batch(batch, mesh)
    assert out["tokens"].shape == batch["tokens"].shape
    for k in batch:
        assert torch.equal(out[k].full_tensor(), batch[k])


def test_mesh_train_step_on_one_rank_equals_plain(gloo1):
    cfg = smoke_variant(get_config("llama3-8b"))
    mesh = tmesh.make_mesh((1, 1), ("data", "model"), device="cpu")
    rules = ts.rules_for(mesh)
    params = tlm.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    oc = OptimConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    batch = next(synthetic_batches(cfg, 2, 16, seed=1, device="cpu"))
    opt = init_opt_state(params)
    (_, m1), g1 = value_and_grad(cfg, params, batch)
    dp = ts.distribute_params(params, mesh, rules)
    with ts.logical_rules(rules):
        p2, _, m2 = train_step(cfg, oc, dp, init_opt_state(dp),
                               shard_batch(batch, mesh))
        (_, _), g2 = value_and_grad(cfg, dp, shard_batch(batch, mesh))
    assert float(m2["ce"].full_tensor()) == pytest.approx(float(m1["ce"]),
                                                          rel=RTOL)
    g2 = tlm.tree_map(ts.full_tensor, g2)
    for a, b in zip(tlm.tree_leaves(g1), tlm.tree_leaves(g2)):
        torch.testing.assert_close(b, a, rtol=RTOL, atol=ATOL)
    # AdamW on the mesh: the single-device update of the same gradients
    # (see the module docstring for Adam's first step)
    p_own, _, _ = adamw_update(oc, params, g2, opt)
    for a, b in zip(tlm.tree_leaves(p_own), tlm.tree_leaves(p2)):
        torch.testing.assert_close(b.full_tensor(), a, rtol=RTOL, atol=ATOL)


# ----------------------------------------------------------------------
# The RFold cluster driver (ports tests/test_system.py:10-27)
# ----------------------------------------------------------------------

def test_rfold_cluster_end_to_end(gloo1):
    n_dev = dist.get_world_size()
    cluster = tcluster.RFoldCluster(num_xpus=8, cube_n=2, engine="numpy",
                                    device="cpu")
    shape = JobShape((min(2, n_dev), 1, 1))
    job = cluster.submit(0, "olmo-1b", shape, seed=0)
    assert job is not None
    assert cluster.utilization() == pytest.approx(shape.size / 8)
    losses = cluster.run_steps(0, steps=2)
    assert len(losses) == 2 and all(v > 0 for v in losses)
    cluster.finish(0)
    assert cluster.utilization() == 0.0


def test_rfold_cluster_rejects_oversized(gloo1):
    cluster = tcluster.RFoldCluster(num_xpus=8, cube_n=2, engine="numpy",
                                    device="cpu")
    assert cluster.submit(1, "olmo-1b", JobShape((64, 1, 1))) is None


def test_rfold_cluster_places_as_repro_on_the_cuda_engine(gloo1):
    """The reference's five archs as 1-XPU jobs held at once: the
    placements equal ``repro``'s RFold policy's, and each job trains on
    its 1x1 mesh as the plain step does."""
    cluster = tcluster.RFoldCluster(
        num_xpus=64, cube_n=2, engine=EngineConfig("cuda", device="cpu"),
        device="cpu")
    ref = JRFoldPolicy(num_xpus=64, cube_n=2)
    for jid, (arch, _) in enumerate(tcluster.SUBMISSIONS):
        job = cluster.submit(jid, arch, JobShape((1, 1, 1)), seed=jid)
        want = ref.try_place(jid, JJobShape((1, 1, 1)))
        assert job["placement"] == want.meta
        assert cluster.utilization() == pytest.approx(ref.utilization())
    cfg = cluster.jobs[0]["cfg"]
    params = tlm.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    oc = cluster.jobs[0]["opt_cfg"]
    opt = init_opt_state(params)
    data = synthetic_batches(cfg, batch=1, seq=32, seed=0, device="cpu")
    want = []
    for _ in range(2):
        params, opt, m = train_step(cfg, oc, params, opt, next(data))
        want.append(float(m["ce"]))
    assert cluster.run_steps(0, 2) == pytest.approx(want, rel=RTOL)
    for jid in range(len(tcluster.SUBMISSIONS)):
        cluster.finish(jid)
    assert cluster.utilization() == 0.0


def test_cluster_main_skips_jobs_larger_than_the_group(capsys):
    tcluster.main(["--jobs", "5", "--steps", "1", "--device", "cpu",
                   "--engine", "numpy"])
    assert not dist.is_initialized()
    out = capsys.readouterr().out.splitlines()
    assert out[:5] == [
        f"job {jid}: {arch} {shape} skipped (needs {shape.size} devices, "
        f"have 1)" for jid, (arch, shape) in enumerate(tcluster.SUBMISSIONS)]
    assert json.loads(out[-1]) == {"final_utilization": 0.0}


def test_train_launcher_mesh_of_one_rank_equals_unmeshed(capsys):
    argv = ["--arch", "olmo-1b", "--smoke", "--steps", "3", "--batch", "2",
            "--seq", "16", "--log-every", "1", "--device", "cpu"]
    plain = train_launcher.main(argv)
    meshed = train_launcher.main(argv + ["--mesh", "1x1"])
    assert not dist.is_initialized()
    for a, b in zip(plain, meshed):
        assert b["ce"] == pytest.approx(a["ce"], rel=RTOL)
        assert b["grad_norm"] == pytest.approx(a["grad_norm"], rel=1e-4)


# ----------------------------------------------------------------------
# Four gloo ranks on a 2x2 mesh
# ----------------------------------------------------------------------

# the issue's two dense families, and the shard_map paths with weights
# replicated over the batch split (sLSTM recurrence, MoE experts)
GLOO_ARCHS = ("olmo-1b", "llama3-8b", "xlstm-1.3b", "llama4-scout-17b-a16e")

WORKER = r'''
import json, os, sys
import torch
import torch.distributed as dist
torch.set_num_threads(1)
from repro_torch.configs import get_config, smoke_variant
from repro_torch.core.engineconfig import EngineConfig
from repro_torch.core.geometry import JobShape
from repro_torch.launch import cluster as tcluster
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import train as train_launcher
from repro_torch.models import model as lm
from repro_torch.parallel import sharding as ts
from repro_torch.serve import engine
from repro_torch.train.data import shard_batch, synthetic_batches
from repro_torch.train.optim import OptimConfig, adamw_update, init_opt_state
from repro_torch.train.train_step import value_and_grad, train_step

assert tmesh.ensure_process_group("cpu")
rank = dist.get_rank()
GLOO_ARCHS = %r
out = {"rank": rank}
full = ts.full_tensor


def excess(a, b):
    # how far b is beyond rtol 1e-5 / atol 1e-6 of a (<= 0: within)
    return float(((a - b).abs() - 1e-6 - 1e-5 * a.abs()).max())


mesh = tmesh.make_mesh((2, 2), ("data", "model"), device="cpu")
rules = ts.rules_for(mesh)
oc = OptimConfig(lr=1e-3, warmup_steps=1, total_steps=100)
for arch in GLOO_ARCHS:
    cfg = smoke_variant(get_config(arch)).replace(dtype="float32")
    params = lm.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = next(synthetic_batches(cfg, 4, 16, seed=0, device="cpu"))
    opt = init_opt_state(params)
    (_, m1), g1 = value_and_grad(cfg, params, batch)
    p1, _, _ = adamw_update(oc, params, g1, opt)
    dp = ts.distribute_params(params, mesh, rules)
    dopt = init_opt_state(dp)
    with ts.logical_rules(rules):
        p2, o2, m2 = train_step(cfg, oc, dp, dopt, shard_batch(batch, mesh))
        (_, _), g2 = value_and_grad(cfg, dp, shard_batch(batch, mesh))
    g2 = lm.tree_map(full, g2)
    p_own, _, _ = adamw_update(oc, params, g2, opt)
    out[arch] = {
        "ce": [float(m1["ce"]), float(full(m2["ce"]))],
        "grad_excess": max(excess(a, b) for a, b in
                           zip(lm.tree_leaves(g1), lm.tree_leaves(g2))),
        "adamw_excess": max(excess(a, full(b)) for a, b in
                            zip(lm.tree_leaves(p_own), lm.tree_leaves(p2))),
        "param_diff": max(float((a - full(b)).abs().max()) for a, b in
                          zip(lm.tree_leaves(p1), lm.tree_leaves(p2))),
        "placements": sorted({str(t.placements)
                              for t in lm.tree_leaves(p2)}),
    }

# zamba2 smoke: decode steps from a sharded state
cfg = smoke_variant(get_config("zamba2-1.2b"))
params = lm.init_model(cfg, torch.Generator().manual_seed(1), "cpu")
state = engine.init_state(cfg, 4, 16, device="cpu")
dp = ts.distribute_params(params, mesh, rules)
dstate = ts.distribute_tree(
    engine.init_state(cfg, 4, 16, device="cpu"),
    ts.decode_state_specs(state, mesh, rules))
gen = torch.Generator().manual_seed(2)
worst_logits, worst_state = -1.0, -1.0
for t in range(3):
    toks = torch.randint(0, cfg.vocab_size, (4, 1), generator=gen,
                         dtype=torch.int32)
    b = {"tokens": toks,
         "positions": torch.full((4, 1), t, dtype=torch.int32)}
    with torch.no_grad():
        l1, state = engine.serve_step(cfg, params, state, b)
        bs = ts.distribute_tree(b, ts.batch_specs_sharding(b, mesh, rules))
        with ts.logical_rules(rules):
            l2, dstate = engine.serve_step(cfg, dp, dstate, bs)
    worst_logits = max(worst_logits, excess(l1, full(l2)))
    # states: within 1e-5 of each leaf's largest magnitude
    worst_state = max(worst_state, max(
        float((a.float() - full(b).float()).abs().max()
              - 1e-5 * a.float().abs().max()) for a, b in
        zip(lm.tree_leaves(state), lm.tree_leaves(dstate))))
out["zamba2-1.2b"] = {"logits_excess": worst_logits,
                      "state_excess": worst_state,
                      "sharded_state": any(
                          "Shard" in str(t.placements)
                          for t in lm.tree_leaves(dstate))}

# a dim split over two mesh axes: major (pod) to minor (data)
pd = tmesh.make_mesh((2, 2), ("pod", "data"), device="cpu")
local = shard_batch({"x": torch.arange(8)}, pd)["x"].to_local()
out["split"] = {"coord": list(pd.get_coordinate()), "local": local.tolist()}

# RFold placements on every rank; a 2-rank job leaves ranks 2 and 3 out
cl = tcluster.RFoldCluster(num_xpus=64, cube_n=2,
                           engine=EngineConfig("cuda", device="cpu"),
                           device="cpu")
metas = []
for jid, (arch, shape) in enumerate([("olmo-1b", JobShape((2, 2, 1))),
                                     ("xlstm-1.3b", JobShape((2, 1, 1)))]):
    metas.append(cl.submit(jid, arch, shape, seed=jid)["placement"])
out["placements"] = metas
out["util"] = cl.utilization()
out["losses"] = cl.run_steps(1, 1)
cl.finish(0)
cl.finish(1)
out["util_after"] = cl.utilization()

# the launcher on the group torchrun would start
hist = train_launcher.main(["--arch", "olmo-1b", "--smoke", "--steps", "2",
                            "--batch", "4", "--seq", "16", "--log-every",
                            "1", "--device", "cpu", "--mesh", "2x2"])
out["history"] = [h["ce"] for h in hist]
with open(sys.argv[1] + f".{rank}", "w") as f:
    json.dump(out, f)
dist.destroy_process_group()
'''


@pytest.fixture(scope="module")
def gloo4(tmp_path_factory):
    """Four ranks as ``torchrun --nproc-per-node 4`` starts them; returns
    each rank's report and rank 0's output."""
    tmp = tmp_path_factory.mktemp("gloo4")
    script = tmp / "worker.py"
    script.write_text(WORKER % (GLOO_ARCHS,))
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               MASTER_ADDR="localhost", MASTER_PORT=str(port),
               WORLD_SIZE="4", OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(tmp / "out.json")],
        env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(4)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    reports = [json.loads((tmp / f"out.json.{r}").read_text())
               for r in range(4)]
    return reports, outs[0][0], [o[0] for o in outs]


@pytest.mark.parametrize("arch", GLOO_ARCHS)
def test_gloo_train_step_matches_single_device(gloo4, arch):
    reports, _, _ = gloo4
    for rep in reports:
        r = rep[arch]
        ce1, ce2 = r["ce"]
        assert ce2 == pytest.approx(ce1, rel=RTOL, abs=ATOL)
        assert r["grad_excess"] <= 0.0
        assert r["adamw_excess"] <= 0.0
        assert r["param_diff"] < 2.5e-3      # at most 2 lr: a sign flip
        assert any("Shard" in p for p in r["placements"])
    assert len({json.dumps(rep[arch]) for rep in reports}) == 1


def test_gloo_decode_step_with_sharded_state_matches(gloo4):
    reports, _, _ = gloo4
    for rep in reports:
        r = rep["zamba2-1.2b"]
        assert r["sharded_state"]
        assert r["logits_excess"] <= 0.0
        assert r["state_excess"] <= 0.0


def test_gloo_dim_split_over_two_axes_is_major_to_minor(gloo4):
    reports, _, _ = gloo4
    for rep in reports:
        i, j = rep["split"]["coord"]
        k = 2 * i + j
        assert rep["split"]["local"] == [2 * k, 2 * k + 1]


def test_gloo_cluster_placements_equal_on_every_rank(gloo4):
    reports, _, _ = gloo4
    ref = JRFoldPolicy(num_xpus=64, cube_n=2)
    want = [ref.try_place(0, JJobShape((2, 2, 1))).meta,
            ref.try_place(1, JJobShape((2, 1, 1))).meta]
    for rep in reports:
        assert rep["placements"] == json.loads(json.dumps(want))
        assert rep["util"] == pytest.approx(6 / 64)
        assert rep["util_after"] == 0.0
    # the 2-rank job runs on ranks 0 and 1; ranks 2 and 3 skip it
    assert len(reports[0]["losses"]) == 1
    assert reports[1]["losses"] == reports[0]["losses"]
    assert reports[2]["losses"] == [] and reports[3]["losses"] == []


def test_gloo_train_launcher_prints_on_rank_zero_only(gloo4):
    reports, out0, outs = gloo4
    lines = [json.loads(line) for line in out0.splitlines()
             if line.startswith("{")]
    assert [h["ce"] for h in lines] == reports[0]["history"]
    assert all(not o.strip() for o in outs[1:])
    cfg = smoke_variant(get_config("olmo-1b"))
    params = tlm.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    opt = init_opt_state(params)
    oc = OptimConfig(lr=3e-4, warmup_steps=1, total_steps=2)
    data = synthetic_batches(cfg, 4, 16, seed=0, device="cpu")
    for ce in reports[0]["history"]:
        params, opt, m = train_step(cfg, oc, params, opt, next(data))
        assert ce == pytest.approx(float(m["ce"]), rel=RTOL)


# ----------------------------------------------------------------------
# Dry-run and perf variants on a fake group of 8 ranks
# ----------------------------------------------------------------------

def test_mini_dryrun_train(fake8):
    """llama3-8b smoke's train step on a 4x2 mesh: per-rank counts that
    add up to the one-rank count."""
    cfg = smoke_variant(get_config("llama3-8b"))
    mesh = tmesh.make_mesh((4, 2), ("data", "model"), device="cpu")
    shape = InputShape("mini", 64, 8, "train")
    c = dryrun.trace_cost(cfg, shape, device="cpu", mesh=mesh)
    one = dryrun.one_rank_cost(cfg, shape, device="cpu")
    assert c["flops"] > 0 and c["ops"] > 0
    assert 8 * c["flops"] == pytest.approx(one["flops"], rel=1e-9)
    assert c["collectives"]["total_count"] > 0
    assert one["collectives"]["total_count"] == 0
    mem = c["memory"]
    assert 0 < mem["argument_size_in_bytes"] < \
        one["memory"]["argument_size_in_bytes"]
    assert mem["temp_size_in_bytes"] > 0


def test_mini_dryrun_decode(fake8):
    """zamba2 smoke's decode step with a sharded decode state."""
    cfg = smoke_variant(get_config("zamba2-1.2b"))
    mesh = tmesh.make_mesh((4, 2), ("data", "model"), device="cpu")
    c = dryrun.trace_cost(cfg, InputShape("mini_dec", 64, 8, "decode"),
                          device="cpu", mesh=mesh)
    assert c["flops"] > 0 and c["bytes"] > 0


def test_probes_extrapolate_to_the_full_depth_count(fake8):
    cfg = smoke_variant(get_config("olmo-1b"), n_layers=6)
    mesh = tmesh.make_mesh((4, 2), ("data", "model"), device="cpu")
    shape = InputShape("mini", 32, 8, "train")
    lo, hi = dryrun.probe_depths(cfg)
    c = {d: dryrun.trace_cost(cfg.replace(n_layers=d), shape, device="cpu",
                              mesh=mesh) for d in (lo, hi, cfg.n_layers)}
    for key in ("flops", "bytes", "collective_bytes"):
        slope = (c[hi][key] - c[lo][key]) / (hi - lo)
        assert c[lo][key] + slope * (cfg.n_layers - lo) == \
            pytest.approx(c[cfg.n_layers][key], rel=1e-12)


def test_dryrun_main_writes_repros_keys(tmp_path, monkeypatch):
    """``main`` on the 256-rank production mesh, a smoke olmo with 16
    heads (so the model axis divides them), probes included."""
    monkeypatch.setattr(dryrun, "get_config", lambda a: smoke_variant(
        get_config(a), n_heads=16, n_kv_heads=16, head_dim=16))
    assert dryrun.main(["--arch", "olmo-1b", "--shape", "train_4k",
                        "--mesh", "single", "--out", str(tmp_path),
                        "--device", "cpu"]) == 0
    assert not dist.is_initialized()
    res = json.loads((tmp_path / "olmo-1b__train_4k__single.json")
                     .read_text())
    assert set(res) == {"arch", "shape", "mesh", "chips", "lower_s",
                        "compile_s", "flops", "bytes_accessed",
                        "memory_analysis", "collectives", "hlo_ops",
                        "probes"}
    assert res["chips"] == 256 and res["flops"] > 0
    assert set(res["memory_analysis"]) >= {
        "argument_size_in_bytes", "output_size_in_bytes",
        "temp_size_in_bytes", "generated_code_size_in_bytes"}
    assert {"all-reduce", "all-gather", "reduce-scatter", "all-to-all",
            "collective-permute", "total_bytes",
            "total_count"} <= set(res["collectives"])
    ex = res["probes"]["extrapolated"]
    assert ex["flops"] == pytest.approx(res["flops"], rel=1e-12)


# variant -> (arch, shape) it is meant for
VARIANT_CASES = {
    "baseline": ("olmo-1b", "train_4k"),
    "remat_full": ("olmo-1b", "train_4k"),
    "no_fsdp": ("olmo-1b", "train_4k"),
    "seq_shard": ("olmo-1b", "prefill_32k"),
    "cap_tight": ("deepseek-v2-236b", "train_4k"),
    "cap_loose": ("deepseek-v2-236b", "train_4k"),
    "moe_local": ("deepseek-v2-236b", "train_4k"),
    "moe_local_noefsdp": ("deepseek-v2-236b", "train_4k"),
    "window_4k": ("llama3-8b", "long_500k"),
    "window_16k": ("llama3-8b", "long_500k"),
    "cache_seq_model": ("llama3-8b", "decode_32k"),
    "mla_absorb": ("deepseek-v2-236b", "decode_32k"),
    "absorb_cacheshard": ("deepseek-v2-236b", "decode_32k"),
    "absorb_cs_nofsdp": ("deepseek-v2-236b", "decode_32k"),
}


def test_variant_cases_cover_every_variant():
    assert set(VARIANT_CASES) == set(perf.VARIANTS)


@pytest.mark.parametrize("variant", sorted(VARIANT_CASES))
def test_perf_variant_runs(fake8, monkeypatch, variant):
    monkeypatch.setattr(perf, "get_config",
                        lambda a: smoke_variant(get_config(a)))
    arch, shape = VARIANT_CASES[variant]
    mesh = tmesh.make_mesh((4, 2), ("data", "model"), device="cpu")
    r = perf.run_variant(arch, shape, variant, device="cpu", mesh=mesh)
    assert r["flops_per_chip"] > 0 and r["bytes_per_chip"] > 0
    assert r["dominant"] in ("compute", "memory", "collective")
    assert r["t_compute_s"] == r["flops_per_chip"] / perf.PEAK_FLOPS[
        "float32"]


def test_perf_remat_costs_more_flops_and_fsdp_more_bytes(fake8, monkeypatch):
    monkeypatch.setattr(perf, "get_config", lambda a: get_config(a).replace(
        d_model=512, d_ff=2048, head_dim=32, vocab_size=4096, n_layers=2))
    mesh = tmesh.make_mesh((4, 2), ("data", "model"), device="cpu")
    rows = {v: perf.run_variant("olmo-1b", "train_4k", v, device="cpu",
                                mesh=mesh)
            for v in ("baseline", "remat_full", "no_fsdp")}
    assert rows["remat_full"]["flops_per_chip"] > \
        rows["baseline"]["flops_per_chip"]
    assert rows["no_fsdp"]["collective_bytes_per_chip"] < \
        rows["baseline"]["collective_bytes_per_chip"]


def test_h100_figures():
    assert perf.PEAK_FLOPS["bfloat16"] == 989e12
    assert perf.PEAK_FLOPS["float32"] == 67e12
    assert perf.HBM_BW == 3.35e12 and perf.NVLINK_BW == 450e9


def test_smoke_shape_and_dryrun_shapes():
    assert smoke_shape("decode", 8, 2) == InputShape("smoke_decode", 8, 2,
                                                     "decode")
    assert set(SHAPES) == {"train_4k", "prefill_32k", "decode_32k",
                           "long_500k"}
    assert np.prod(tmesh.allocation_mesh_shape(256)) == 256
