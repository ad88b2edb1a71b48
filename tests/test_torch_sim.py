"""Port parity for traces, the simulator and its metrics, and the
port's import boundary (no JAX, nothing of ``repro``)."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core.allocator import make_policy as ref_make_policy
from repro.sim import metrics as ref_metrics
from repro.sim.simulator import Simulator as RefSimulator
from repro.traces import generator as ref_gen
from repro_torch.core.allocator import make_policy
from repro_torch.core.engineconfig import EngineConfig
from repro_torch.sim import metrics
from repro_torch.sim.job import jobs_from_numpy
from repro_torch.sim.simulator import Simulator
from repro_torch.traces import generator as gen

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TRACE_KW = [
    dict(),
    dict(target_load=1.5, num_jobs=200),
    dict(size_duration_corr=0.6),
    dict(arrival_burstiness=0.5, priority_levels=3),
    dict(round_even=False, cube4_decomposable=False),
]


def trace_arrays(jobs):
    return (np.array([j.job_id for j in jobs]),
            np.array([j.arrival for j in jobs]),
            np.array([j.duration for j in jobs]),
            np.array([j.shape.dims for j in jobs]),
            np.array([j.priority for j in jobs]))


@pytest.mark.parametrize("kw", TRACE_KW, ids=lambda kw: ",".join(kw) or "default")
@pytest.mark.parametrize("seed", [0, 7])
def test_seeded_traces_are_byte_identical(kw, seed):
    want = ref_gen.generate_trace(ref_gen.TraceConfig(seed=seed, **kw))
    got = gen.generate_trace(gen.TraceConfig(seed=seed, **kw))
    for a, b in zip(trace_arrays(got), trace_arrays(want)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_philly_preset_is_byte_identical():
    want = ref_gen.generate_trace(ref_gen.TraceConfig.preset("philly",
                                                             num_jobs=80))
    got = gen.generate_trace(gen.TraceConfig.preset("philly", num_jobs=80))
    for a, b in zip(trace_arrays(got), trace_arrays(want)):
        assert a.tobytes() == b.tobytes()


def test_jobs_from_numpy_round_trip():
    ref_jobs = ref_gen.generate_trace(ref_gen.TraceConfig(
        num_jobs=25, seed=4, priority_levels=2))
    jobs = jobs_from_numpy(*trace_arrays(ref_jobs))
    for a, b in zip(trace_arrays(jobs), trace_arrays(ref_jobs)):
        assert a.tobytes() == b.tobytes()
    assert all(j.start is None and not j.dropped for j in jobs)
    no_prio = jobs_from_numpy(*trace_arrays(ref_jobs)[:4])
    assert all(j.priority == 0 for j in no_prio)


SIM_KW = [dict(), dict(backfill=True), dict(gated=False),
          dict(broken_ring_slowdown=1.5)]


@pytest.mark.parametrize("sim_kw", SIM_KW,
                         ids=lambda kw: ",".join(kw) or "default")
@pytest.mark.parametrize("policy,kw", [("folding", dict(dims=(8, 8, 8))),
                                       ("rfold", dict(num_xpus=512,
                                                      cube_n=4))])
def test_simulator_and_metrics_match_reference(policy, kw, sim_kw):
    cfg = dict(num_jobs=30, seed=3, size_scale=48.0, size_max=512,
               cluster_xpus=512, target_load=1.5, cube4_budget=8)
    ref_jobs = ref_gen.generate_trace(ref_gen.TraceConfig(**cfg))
    want = RefSimulator(ref_make_policy(policy, engine="numpy", **kw),
                        ref_jobs, **sim_kw).run()
    got = Simulator(make_policy(policy, engine=EngineConfig(
        "cuda", device="cpu"), **kw),
        jobs_from_numpy(*trace_arrays(ref_jobs)), **sim_kw).run()
    assert [(j.start, j.finish, j.dropped, j.slowdown, j.placement_meta)
            for j in got.jobs] == \
        [(j.start, j.finish, j.dropped, j.slowdown, j.placement_meta)
         for j in want.jobs]
    assert repr(metrics.summarize(got)) == repr(ref_metrics.summarize(want))
    for a, b in zip(metrics.utilization_cdf(got),
                    ref_metrics.utilization_cdf(want)):
        assert a.tobytes() == b.tobytes()


def test_reused_job_list_keeps_its_first_start_as_the_reference_does():
    """One job list run through rfold_be, FirstFit, Folding, Reconfig and
    RFold in turn, in each package: a job that already carries a
    ``start`` keeps it (``repro/sim/simulator.py``'s ``if job.start is
    None``), so every schedule equals the reference's."""
    cfg = dict(num_jobs=40, seed=5, cluster_xpus=512, size_max=512,
               priority_levels=2)
    ref_jobs = ref_gen.generate_trace(ref_gen.TraceConfig(**cfg))
    jobs = jobs_from_numpy(*trace_arrays(ref_jobs))
    runs = [("rfold_be", dict(num_xpus=512, cube_n=4)),
            ("firstfit", dict(dims=(8, 8, 8))),
            ("folding", dict(dims=(8, 8, 8))),
            ("reconfig", dict(num_xpus=512, cube_n=4)),
            ("rfold", dict(num_xpus=512, cube_n=4))]
    starts = set()
    for policy, kw in runs:
        want = RefSimulator(ref_make_policy(policy, engine="numpy", **kw),
                            ref_jobs).run()
        got = Simulator(make_policy(policy, engine="numpy", **kw),
                        jobs).run()
        assert [(j.start, j.finish, j.dropped, j.slowdown)
                for j in got.jobs] == \
            [(j.start, j.finish, j.dropped, j.slowdown) for j in want.jobs]
        starts.add(tuple(j.start for j in got.jobs))
    assert len(starts) == 1    # every run kept the first run's starts


def test_port_imports_no_jax_and_nothing_of_repro():
    """Import every module of the port, its benches and chip_smoke in a
    fresh process, the chaos layer, the service, its benchmarks,
    ``repro_torch.api``, the training modules and launcher, and every
    config module of the registry by name, and load each
    ``examples_torch`` script
    by path (not as ``__main__``); neither JAX nor any ``repro`` module
    may be loaded."""
    code = """
import glob, importlib.util, os, pkgutil, sys
import benchmarks_torch, repro_torch
for pkg in (repro_torch, benchmarks_torch):
    for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
        __import__(m.name)
import benchmarks_torch.chaos_bench, repro_torch.sim.faults
import repro_torch.sim.scenarios
import repro_torch.api, repro_torch.serve.scheduler
import benchmarks_torch.crash_loop, benchmarks_torch.failover_drill
import benchmarks_torch.service_bench
import repro_torch.train.optim, repro_torch.train.data
import repro_torch.train.checkpoint, repro_torch.train.train_step
import repro_torch.launch.train, repro_torch.models.xlstm
import repro_torch.parallel.sharding, repro_torch.launch.mesh
import repro_torch.launch.cluster, repro_torch.launch.dryrun
import repro_torch.launch.perf, repro_torch.configs.shapes
import repro_torch.configs.registry as reg
for mod in ("llama3_8b", "phi4_mini_3_8b", "qwen1_5_110b", "olmo_1b",
            "qwen2_vl_7b", "musicgen_medium", "zamba2_1_2b",
            "deepseek_v2_236b", "llama4_scout_17b_a16e", "xlstm_1_3b"):
    assert "repro_torch.configs." + mod in sys.modules, mod
assert len(reg.ARCH_IDS) == 10, reg.ARCH_IDS
examples = sorted(glob.glob(os.path.join("examples_torch", "*.py")))
assert len(examples) >= 2, examples
for path in examples:
    name = "example_" + os.path.basename(path)[:-3]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert callable(mod.main), path
import chip_smoke
bad = sorted(n for n in sys.modules
             if n.split(".")[0] in ("jax", "jaxlib", "repro"))
mods = sorted(n for n in sys.modules
              if n.split(".")[0] in ("repro_torch", "benchmarks_torch"))
print(len(mods))
assert not bad, bad
"""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src"), ROOT]))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 60
