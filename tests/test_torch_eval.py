"""Port parity for the evaluation subsystem (``repro_torch.eval``),
mirroring ``tests/test_eval_runner.py``: seed derivation, pool-vs-serial
equivalence, checkpoint resume, fingerprints, and — against
``repro.eval`` on the same seeded tasks — per-run records (``sim_s``
aside) and Table 1 / Fig 3 / Fig 4 byte-identical through the fleet path
and the per-task path. Also: how pool workers start (``spawn`` where the
engine runs on the card), the scenario arm (each named chaos scenario's
records equal to ``repro.eval``'s, per task and through fleets), and
the default engine raising without a card."""
import json
import os

import pytest
import torch

from repro.eval import EvalRunner as RefEvalRunner
from repro.eval import EvalTask as RefEvalTask
from repro.eval import aggregate_by_label as ref_aggregate_by_label
from repro.eval import fig3 as ref_fig3
from repro.eval import fig4 as ref_fig4
from repro.eval import make_tasks as ref_make_tasks
from repro.eval import table1 as ref_table1
from repro_torch.core import engineconfig
from repro_torch.core.engineconfig import EngineConfig
from repro_torch.eval import (EvalRunner, EvalTask, aggregate_by_label,
                              derive_seed, fig3, fig4, make_tasks,
                              prune_checkpoints, run_task, table1)
from repro_torch.eval.runner import SHARD_CHARS, iter_checkpoints, shard_dir
from repro_torch.kernels.fitmask import ops

torch.set_num_threads(1)

NUMPY = EngineConfig("numpy")
SEQ = EngineConfig("numpy", fleet_size=0)

# Small matrix: 512-XPU cluster, short traces — seconds, not minutes.
CONFIGS = [
    ("RFold (4^3)", "rfold", dict(num_xpus=512, cube_n=4)),
    ("Reconfig (4^3)", "reconfig", dict(num_xpus=512, cube_n=4)),
]

# benchmarks/paper_eval.py's eight Table 1 / Fig 3 configurations, plus
# one arm of each of two ablations (benchmarks/ablations.py).
PAPER_CONFIGS = [
    ("FirstFit (16^3)", "firstfit", dict(dims=(16, 16, 16))),
    ("Folding (16^3)", "folding", dict(dims=(16, 16, 16))),
    ("Reconfig (8^3)", "reconfig", dict(num_xpus=4096, cube_n=8)),
    ("RFold (8^3)", "rfold", dict(num_xpus=4096, cube_n=8)),
    ("Reconfig (4^3)", "reconfig", dict(num_xpus=4096, cube_n=4)),
    ("RFold (4^3)", "rfold", dict(num_xpus=4096, cube_n=4)),
    ("Reconfig (2^3)", "reconfig", dict(num_xpus=4096, cube_n=2)),
    ("RFold (2^3)", "rfold", dict(num_xpus=4096, cube_n=2)),
    ("RFold (4^3) dedicated", "rfold",
     dict(num_xpus=4096, cube_n=4, dedicate_chained=True)),
    ("RFold-BE 1.35", "rfold_be",
     dict(num_xpus=4096, cube_n=4, scatter_slowdown=1.35)),
]


def _tasks(runs=2, num_jobs=25):
    return make_tasks(CONFIGS, runs=runs, num_jobs=num_jobs, load=1.5,
                      seed0=100)


def _strip_timing(records):
    """Records without ``sim_s``, as canonical JSON (NaN equals NaN)."""
    return json.dumps([{k: v for k, v in r.items() if k != "sim_s"}
                       for r in records], sort_keys=True)


def _figures(records, agg, t1, f3, f4):
    aggs = agg(records)
    for a in aggs.values():
        a.pop("sim_s_total")
    return json.dumps({"aggs": aggs, "table1": t1(aggs), "fig3": f3(aggs),
                       "fig4": f4(aggs)}, sort_keys=True, default=float)


@pytest.fixture(autouse=True)
def _clean_selection(monkeypatch):
    monkeypatch.delenv(engineconfig.ENGINE_ENV, raising=False)
    monkeypatch.setattr(engineconfig, "_default_engine", None)


# ------------------------------------------- parity with repro.eval
@pytest.fixture(scope="module")
def reference_records():
    tasks = ref_make_tasks(PAPER_CONFIGS, runs=2, num_jobs=60, load=1.5,
                           seed0=100)
    return RefEvalRunner(workers=0, fleet_size=0).run(tasks)


PATHS = {
    "fleet-numpy": EngineConfig("numpy", fleet_size=6),
    "per-task-numpy": SEQ,
    "fleet-cuda-on-cpu": EngineConfig("cuda", device="cpu"),
    "per-task-torch-on-cpu": EngineConfig("torch", device="cpu",
                                          fleet_size=0),
}


@pytest.mark.parametrize("path", sorted(PATHS))
def test_records_and_figures_identical_to_reference(reference_records, path):
    """The paper's eight configurations and two ablation arms, 2 runs x
    60 jobs: per-run records (``sim_s`` aside) and Table 1 / Fig 3 /
    Fig 4 are byte-identical to ``repro.eval``'s."""
    tasks = make_tasks(PAPER_CONFIGS, runs=2, num_jobs=60, load=1.5,
                       seed0=100)
    runner = EvalRunner(workers=0, engine=PATHS[path])
    got = runner.run(tasks)
    assert _strip_timing(got) == _strip_timing(reference_records)
    assert _figures(got, aggregate_by_label, table1, fig3, fig4) == \
        _figures(reference_records, ref_aggregate_by_label, ref_table1,
                 ref_fig3, ref_fig4)
    if PATHS[path].fleet_size:
        broker = runner.last_stats["fleet"]["broker"]
        assert broker["engine_failovers"] == 0
        assert broker["mean_grids_per_call"] > 1


def test_fingerprints_equal_the_references():
    kw = dict(runs=2, num_jobs=60, load=1.5, seed0=100)
    want = ref_make_tasks(PAPER_CONFIGS, **kw)
    got = make_tasks(PAPER_CONFIGS, **kw)
    assert [t.fingerprint() for t in got] == [t.fingerprint() for t in want]
    assert [t.checkpoint_name() for t in got] == \
        [t.checkpoint_name() for t in want]
    extra = dict(trace_kw={"size_scale": 128.0}, sim_kw={"backfill": True})
    assert EvalTask(label="a", policy="rfold", **extra).fingerprint() == \
        RefEvalTask(label="a", policy="rfold", **extra).fingerprint()
    assert EvalTask(label="a", policy="rfold",
                    scenario="bursty").fingerprint() == \
        RefEvalTask(label="a", policy="rfold",
                    scenario="bursty").fingerprint()


# ------------------------------------------------ start method, engine
def test_workers_spawn_where_the_engine_runs_on_the_card():
    """A CUDA context does not survive fork: a pool for an engine on the
    card is spawned (decided without starting one), a host or CPU one
    forked."""
    assert EvalRunner(workers=2, engine=EngineConfig("cuda")) \
        .start_method() == "spawn"
    assert EvalRunner(workers=2).start_method() == "spawn"   # cuda default
    assert EvalRunner(workers=2, engine=EngineConfig(
        "torch", device="cuda:0")).start_method() == "spawn"
    assert EvalRunner(workers=2, engine=NUMPY).start_method() == "fork"
    assert EvalRunner(workers=2, engine=EngineConfig(
        "numpy", device="cuda")).start_method() == "fork"
    assert EvalRunner(workers=2, engine=EngineConfig(
        "cuda", device="cpu")).start_method() == "fork"


def test_workers_spawn_once_cuda_is_initialised(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    assert EvalRunner(workers=2, engine=NUMPY).start_method() == "spawn"


def test_default_engine_raises_without_a_card(monkeypatch):
    """No engine asked for means the card; with none, the run raises on
    both paths instead of carrying on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(ops, "_INSTANCES", {})
    tasks = _tasks(runs=1, num_jobs=10)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        EvalRunner(workers=0).run(tasks)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        EvalRunner(workers=0, engine=EngineConfig(fleet_size=0)).run(tasks)


@pytest.mark.parametrize("scenario", ["bursty", "healthy", "multi_tenant",
                                      "node_churn", "ocs_degraded"])
def test_scenario_records_identical_to_reference(scenario):
    """The paper's eight configurations and two ablation arms under a
    named chaos scenario, 1 run x 60 jobs: ``run_task``, ``EvalRunner``
    per task (both ``numpy``) and as fleets (``cuda`` on the CPU) each
    give ``repro.eval.runner.run_task``'s records, ``sim_s`` aside,
    chaos block included."""
    from repro.eval.runner import run_task as ref_run_task
    kw = dict(runs=1, num_jobs=60, load=1.5, seed0=100, scenario=scenario)
    want = [ref_run_task(t) for t in ref_make_tasks(PAPER_CONFIGS, **kw)]
    assert all(r["scenario"] == scenario and r["chaos"] for r in want)
    assert sum(r["chaos"]["faults"] for r in want) > 0 or \
        scenario in ("bursty", "healthy")
    tasks = make_tasks(PAPER_CONFIGS, **kw)
    direct = [run_task(t, engine=NUMPY) for t in tasks]
    assert _strip_timing(direct) == _strip_timing(want)
    assert _strip_timing(EvalRunner(workers=0, engine=SEQ).run(tasks)) == \
        _strip_timing(want)
    fleet = EvalRunner(workers=0, engine=EngineConfig("cuda", device="cpu"))
    assert _strip_timing(fleet.run(tasks)) == _strip_timing(want)
    broker = fleet.last_stats["fleet"]["broker"]
    assert broker["engine_failovers"] == 0 and broker["batched_calls"] > 0


KILL_CONFIGS = [
    ("FirstFit (8^3)", "firstfit", dict(dims=(8, 8, 8))),
    ("Folding (8^3)", "folding", dict(dims=(8, 8, 8))),
    ("Reconfig (4^3)", "reconfig", dict(num_xpus=512, cube_n=4)),
    ("RFold (4^3)", "rfold", dict(num_xpus=512, cube_n=4)),
]


def test_kill_mode_records_identical_to_reference():
    """``sim_kw={"fault_mode": "kill"}`` under ``node_churn`` at 512
    XPUs, 2 runs x 60 jobs: ``run_task`` on ``numpy`` and ``EvalRunner``
    as fleets (``cuda`` on the CPU) each give
    ``repro.eval.runner.run_task``'s records, ``sim_s`` aside; every
    victim is killed and counted as dropped."""
    from repro.eval.runner import run_task as ref_run_task
    kw = dict(runs=2, num_jobs=60, load=1.5, seed0=100,
              sim_kw={"fault_mode": "kill"}, scenario="node_churn")
    want = [ref_run_task(t) for t in ref_make_tasks(KILL_CONFIGS, **kw)]
    tasks = make_tasks(KILL_CONFIGS, **kw)
    assert [t.fingerprint() for t in tasks] == \
        [r["fingerprint"] for r in want]
    direct = [run_task(t, engine=NUMPY) for t in tasks]
    assert _strip_timing(direct) == _strip_timing(want)
    fleet = EvalRunner(workers=0, engine=EngineConfig("cuda", device="cpu"))
    assert _strip_timing(fleet.run(tasks)) == _strip_timing(want)
    broker = fleet.last_stats["fleet"]["broker"]
    assert broker["engine_failovers"] == 0 and broker["batched_calls"] > 0
    for rec in direct:
        ch = rec["chaos"]
        assert ch["victims"] == ch["killed"]
        assert ch["preempted"] == ch["migrated"] == 0
        assert rec["summary"]["num_dropped"] >= ch["killed"]
    assert sum(r["chaos"]["killed"] for r in direct) > 0


# ----------------------------------------------------- seed derivation
def test_derive_seed_depends_only_on_run_idx():
    a = [derive_seed(100, r) for r in range(8)]
    assert a == [derive_seed(100, r) for r in range(8)]
    assert len(set(a)) == len(a)


def test_task_seeds_paired_across_policies():
    by_run = {}
    for t in _tasks(runs=3):
        by_run.setdefault(t.run_idx, set()).add(t.seed)
    for r, seeds in by_run.items():
        assert len(seeds) == 1, (r, seeds)


def test_records_stable_across_worker_counts():
    """Pool width is an execution detail: identical records for
    workers=0 (inline), 1, and 2 (a forked pool on the host engine), on
    both paths."""
    for fleet_size in (2, 0):
        outs = [_strip_timing(EvalRunner(workers=w, engine=EngineConfig(
            "numpy", fleet_size=fleet_size)).run(_tasks()))
            for w in (0, 1, 2)]
        assert outs[0] == outs[1] == outs[2]


# ----------------------------------------------------- checkpoint/resume
def test_resume_from_partial_checkpoint_equals_fresh(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    fresh = EvalRunner(workers=0, engine=SEQ).run(_tasks())
    EvalRunner(checkpoint_dir=ckpt, workers=0, engine=SEQ).run(_tasks())
    files = sorted(iter_checkpoints(ckpt))
    assert len(files) == len(_tasks())
    for path in files[::2]:
        os.remove(path)
    runner = EvalRunner(checkpoint_dir=ckpt, workers=0, engine=SEQ)
    resumed = runner.run(_tasks())
    assert runner.last_stats["reused_from_checkpoint"] == \
        len(files) - len(files[::2])
    assert runner.last_stats["executed"] == len(files[::2])
    assert _strip_timing(resumed) == _strip_timing(fresh)
    assert table1(aggregate_by_label(fresh)) == \
        table1(aggregate_by_label(resumed))


def test_port_resumes_from_a_reference_checkpoint(tmp_path):
    """Records are equal across the packages, so the port resumes from a
    checkpoint the reference wrote (which is why the port's benches keep
    their own checkpoint directories)."""
    ckpt = str(tmp_path / "ckpt")
    ref_tasks = ref_make_tasks(CONFIGS, runs=1, num_jobs=20, load=1.5,
                               seed0=100)
    want = RefEvalRunner(checkpoint_dir=ckpt, workers=0).run(ref_tasks)
    runner = EvalRunner(checkpoint_dir=ckpt, workers=0, engine=NUMPY)
    got = runner.run(_tasks(runs=1, num_jobs=20))
    assert runner.last_stats["reused_from_checkpoint"] == len(ref_tasks)
    assert got == want


def test_stale_fingerprint_checkpoint_is_rerun(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    EvalRunner(checkpoint_dir=ckpt, workers=0,
               engine=NUMPY).run(_tasks(num_jobs=20))
    runner = EvalRunner(checkpoint_dir=ckpt, workers=0, engine=NUMPY)
    records = runner.run(_tasks(num_jobs=25))
    assert runner.last_stats["reused_from_checkpoint"] == 0
    assert all(r["summary"]["num_jobs"] == 25 for r in records)


def test_corrupt_checkpoint_is_rerun(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    tasks = _tasks(runs=1)
    EvalRunner(checkpoint_dir=ckpt, workers=0, engine=NUMPY).run(tasks)
    victim = os.path.join(shard_dir(ckpt, tasks[0].fingerprint()),
                          tasks[0].checkpoint_name())
    with open(victim, "w") as f:
        f.write("{not json")
    runner = EvalRunner(checkpoint_dir=ckpt, workers=0, engine=NUMPY)
    runner.run(tasks)
    assert runner.last_stats["executed"] == 1
    with open(victim) as f:
        assert json.load(f)["fingerprint"] == tasks[0].fingerprint()


def test_pool_writes_checkpoints(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    EvalRunner(checkpoint_dir=ckpt, workers=2,
               engine=SEQ).run(_tasks(runs=1))
    assert sorted(os.path.basename(p) for p in iter_checkpoints(ckpt)) \
        == sorted(t.checkpoint_name() for t in _tasks(runs=1))


# ----------------------------------------------------- sharded store
def test_checkpoints_land_in_fingerprint_shards(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    tasks = _tasks(runs=2)
    EvalRunner(checkpoint_dir=ckpt, workers=0, engine=NUMPY).run(tasks)
    assert not [n for n in os.listdir(ckpt)
                if os.path.isfile(os.path.join(ckpt, n))]
    for t in tasks:
        path = os.path.join(shard_dir(ckpt, t.fingerprint()),
                            t.checkpoint_name())
        assert os.path.exists(path), path
        assert os.path.relpath(path, ckpt).split(os.sep)[0] == \
            t.fingerprint()[:SHARD_CHARS]


def _flatten_store(ckpt):
    """Rewrite a sharded store into the legacy flat layout."""
    for path in list(iter_checkpoints(ckpt)):
        os.replace(path, os.path.join(ckpt, os.path.basename(path)))
    for name in os.listdir(ckpt):
        sub = os.path.join(ckpt, name)
        if os.path.isdir(sub):
            os.rmdir(sub)


def test_resume_from_legacy_flat_store(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    tasks = _tasks(runs=1)
    EvalRunner(checkpoint_dir=ckpt, workers=0, engine=NUMPY).run(tasks)
    _flatten_store(ckpt)
    runner = EvalRunner(checkpoint_dir=ckpt, workers=0, engine=NUMPY)
    runner.run(tasks)
    assert runner.last_stats["reused_from_checkpoint"] == len(tasks)
    assert runner.last_stats["executed"] == 0


@pytest.mark.parametrize("flat", [False, True])
def test_checkpoint_reused_across_labels(tmp_path, flat):
    """A run checkpointed under one label is reused for the same config
    under another, restamped with the new label, in sharded and flat
    stores."""
    ckpt = str(tmp_path / "ckpt")
    t1 = make_tasks([CONFIGS[0]], runs=1, num_jobs=20, load=1.5, seed0=100)
    EvalRunner(checkpoint_dir=ckpt, workers=0, engine=NUMPY).run(t1)
    if flat:
        _flatten_store(ckpt)
    t2 = make_tasks([("RFold renamed",) + CONFIGS[0][1:]], runs=1,
                    num_jobs=20, load=1.5, seed0=100)
    runner = EvalRunner(checkpoint_dir=ckpt, workers=0, engine=NUMPY)
    records = runner.run(t2)
    assert runner.last_stats["reused_from_checkpoint"] == 1
    assert records[0]["label"] == "RFold renamed"


# ----------------------------------------------------- task semantics
def test_run_task_record_shape():
    task = EvalTask(label="RFold (4^3)", policy="rfold",
                    policy_kw=dict(num_xpus=512, cube_n=4),
                    run_idx=0, seed=7, num_jobs=15, load=1.5)
    rec = run_task(task, engine=NUMPY)
    assert rec["fingerprint"] == task.fingerprint()
    assert rec["summary"]["num_jobs"] == 15
    assert 0.0 <= rec["summary"]["jcr"] <= 1.0
    assert len(rec["cdf_levels"]) == len(rec["cdf"]) == 101


def test_sim_kw_reaches_simulator():
    """backfill=True must change scheduling on a blocking trace."""
    kw = dict(label="x", policy="rfold",
              policy_kw=dict(num_xpus=512, cube_n=4), seed=3, num_jobs=40,
              load=3.0)
    base, bf = EvalTask(**kw), EvalTask(**kw, sim_kw=dict(backfill=True))
    assert base.fingerprint() != bf.fingerprint()
    r_base, r_bf = run_task(base, engine=NUMPY), run_task(bf, engine=NUMPY)
    assert r_bf["summary"]["jct_p50"] <= r_base["summary"]["jct_p50"]


def test_policy_kw_engine_wins_over_the_runner_engine():
    """A task that names its own engine keeps it on the per-task path."""
    task = EvalTask(label="x", policy="rfold",
                    policy_kw=dict(num_xpus=512, cube_n=4,
                                   engine=EngineConfig("torch",
                                                       device="cpu")),
                    num_jobs=15)
    assert _strip_timing([run_task(task, engine="cuda")]) == \
        _strip_timing([run_task(task, engine=NUMPY)])


def test_fingerprint_ignores_display_label():
    a = EvalTask(label="RFold (4^3)", policy="rfold", policy_kw={"cube_n": 4})
    b = EvalTask(label="RFold FIFO", policy="rfold", policy_kw={"cube_n": 4})
    assert a.fingerprint() == b.fingerprint()


def test_fingerprint_covers_every_outcome_field():
    base = EvalTask(label="a", policy="rfold", policy_kw={"cube_n": 4})
    variants = [
        EvalTask(label="a", policy="reconfig", policy_kw={"cube_n": 4}),
        EvalTask(label="a", policy="rfold", policy_kw={"cube_n": 2}),
        EvalTask(label="a", policy="rfold", policy_kw={"cube_n": 4},
                 run_idx=1),
        EvalTask(label="a", policy="rfold", policy_kw={"cube_n": 4},
                 seed=1),
        EvalTask(label="a", policy="rfold", policy_kw={"cube_n": 4},
                 num_jobs=10),
        EvalTask(label="a", policy="rfold", policy_kw={"cube_n": 4},
                 load=2.0),
        EvalTask(label="a", policy="rfold", policy_kw={"cube_n": 4},
                 trace_kw={"size_scale": 128.0}),
        EvalTask(label="a", policy="rfold", policy_kw={"cube_n": 4},
                 sim_kw={"backfill": True}),
    ]
    fps = {t.fingerprint() for t in variants}
    assert base.fingerprint() not in fps
    assert len(fps) == len(variants)


def test_checkpoint_name_is_filesystem_safe():
    t = EvalTask(label="RFold (4^3) / weird:label", policy="rfold")
    name = t.checkpoint_name()
    assert "/" not in name and ":" not in name and " " not in name
    assert name.endswith(f"__{t.fingerprint()}.json")


def test_workers_default_is_cpu_count():
    assert EvalRunner(engine=NUMPY).workers == os.cpu_count()
    assert EvalRunner(engine=EngineConfig(
        "cuda", device="cpu")).workers == os.cpu_count()


def test_workers_default_is_inline_on_the_card():
    """An engine on the card runs inline unless a pool is asked for:
    each spawned worker would make its own CUDA context on the card."""
    assert EvalRunner().workers == 0
    assert EvalRunner(engine=EngineConfig("torch",
                                          device="cuda")).workers == 0
    assert EvalRunner(engine=EngineConfig("cuda"), workers=2).workers == 2


# ----------------------------------------------------- store pruning
@pytest.mark.parametrize("flat", [False, True])
def test_prune_drops_stale_keeps_current(tmp_path, flat):
    ckpt = str(tmp_path / "ckpt")
    stale = _tasks(runs=1, num_jobs=20)
    current = _tasks(runs=1, num_jobs=25)
    EvalRunner(checkpoint_dir=ckpt, workers=0, engine=NUMPY).run(stale)
    EvalRunner(checkpoint_dir=ckpt, workers=0, engine=NUMPY).run(current)
    if flat:
        _flatten_store(ckpt)
    assert len(list(iter_checkpoints(ckpt))) == len(stale) + len(current)
    stats = prune_checkpoints(ckpt, current)
    assert stats["removed"] == len(stale)
    assert stats["kept"] == len(current)
    assert stats["bytes_freed"] > 0
    runner = EvalRunner(checkpoint_dir=ckpt, workers=0, engine=NUMPY)
    runner.run(current)
    assert runner.last_stats["reused_from_checkpoint"] == len(current)


def test_prune_caps_store_size_evicting_oldest(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    tasks = _tasks(runs=2)
    EvalRunner(checkpoint_dir=ckpt, workers=0, engine=NUMPY).run(tasks)
    paths = sorted(iter_checkpoints(ckpt), key=os.path.getmtime)
    for age, path in enumerate(paths):   # make mtime order deterministic
        os.utime(path, (1000 + age, 1000 + age))
    newest = max(paths, key=os.path.getmtime)
    stats = prune_checkpoints(ckpt, tasks, max_bytes=os.path.getsize(newest))
    assert list(iter_checkpoints(ckpt)) == [newest]
    assert stats["removed"] == len(paths) - 1


def test_prune_leaves_foreign_files_and_cleans_empty_shards(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    tasks = _tasks(runs=1, num_jobs=20)
    EvalRunner(checkpoint_dir=ckpt, workers=0, engine=NUMPY).run(tasks)
    foreign = os.path.join(ckpt, "notes.json")
    with open(foreign, "w") as f:
        f.write("{}")
    shards_before = [n for n in os.listdir(ckpt)
                     if os.path.isdir(os.path.join(ckpt, n))]
    stats = prune_checkpoints(ckpt, _tasks(runs=1, num_jobs=25))
    assert stats["removed"] == len(tasks)
    assert os.path.exists(foreign)
    for name in shards_before:
        assert not os.path.isdir(os.path.join(ckpt, name))
