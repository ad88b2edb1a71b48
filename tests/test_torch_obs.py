"""The port's spans and counters (``repro_torch.obs``): nesting and self
time, threads kept apart, ``diff``/``merge`` and counters, the garbage
collector's span, the bounded timeline, and the spans at the placement
path's boundaries on a CPU fleet run: ``sim_s``, ``BrokerStats.park_s``
and ``engine_s`` and ``InlineMaskClient.seconds`` are the totals of
their spans, and the timeline changes no schedule."""
import gc
import inspect
import json
import multiprocessing
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.core.engineconfig import EngineConfig
from repro_torch.core.folding import enumerate_folds
from repro_torch.core.geometry import JobShape
from repro_torch.core.maskquery import InlineMaskClient
from repro_torch.eval import EvalRunner, make_tasks
from repro_torch.kernels.fitmask import ops

torch.set_num_threads(1)

CUDA_ON_CPU = EngineConfig("cuda", device="cpu")
SMALL = {"cluster_xpus": 512, "size_scale": 32.0, "size_max": 512}
CONFIGS = [("RFold (4^3)", "rfold", {"num_xpus": 512, "cube_n": 4}),
           ("Folding (8^3)", "folding", {"dims": [8, 8, 8]})]


@pytest.fixture
def timeline():
    """Turns the timeline on for a test, and off again after it."""
    obs.keep_intervals(100_000)
    try:
        yield
    finally:
        obs.keep_intervals(0)


def _delta(fn):
    before = obs.totals()
    fn()
    return obs.diff(before, obs.totals())


def _children_s(d, path):
    """Total seconds of the spans entered directly beneath ``path`` (a
    collection that falls inside the block is one of them)."""
    return sum(a["total_s"] for p, a in d["paths"].items()
               if p.rpartition("/")[0] == path)


def _spin(seconds):
    t = time.perf_counter()
    while time.perf_counter() - t < seconds:
        pass


# -------------------------------------------------------------- the module
def test_nesting_and_self_time(timeline):
    def work():
        with obs.span("t.outer") as outer:
            _spin(0.002)
            with obs.span("t.inner"):
                _spin(0.004)
            with obs.span("t.inner"):
                _spin(0.004)
        work.outer = outer

    d = _delta(work)
    outer, inner = d["spans"]["t.outer"], d["spans"]["t.inner"]
    assert outer["count"] == 1 and inner["count"] == 2
    assert inner["parents"] == ["t.outer"] and outer["parents"] == [""]
    assert d["paths"]["t.outer/t.inner"]["count"] == 2
    assert outer["total_s"] == pytest.approx(work.outer.seconds, abs=1e-9)
    assert outer["self_s"] == pytest.approx(
        outer["total_s"] - _children_s(d, "t.outer"), abs=1e-9)
    assert inner["self_s"] == pytest.approx(
        inner["total_s"] - _children_s(d, "t.outer/t.inner"), abs=1e-9)
    assert 0.002 <= outer["self_s"] < outer["total_s"]
    kept = [iv for iv in obs.intervals() if iv[0].startswith("t.")]
    (o,) = [iv for iv in kept if iv[0] == "t.outer"]
    children = [iv for iv in kept if iv[0] == "t.inner"]
    assert len(children) == 2
    for name, parent, tid, t0, t1 in children:
        assert parent == "t.outer" and tid == o[2]
        assert o[3] <= t0 <= t1 <= o[4]


def test_decorated_function_keeps_its_signature():
    @obs.span("t.deco")
    def f(a, b=2, *, c=3):
        """Doc."""
        return a + b + c

    d = _delta(lambda: f(1, c=4))
    assert d["spans"]["t.deco"]["count"] == 1
    assert f(1) == 6 and f.__doc__ == "Doc." and f.__name__ == "f"
    assert list(inspect.signature(f).parameters) == ["a", "b", "c"]


def test_a_raising_block_is_still_closed():
    def work():
        with pytest.raises(ValueError):
            with obs.span("t.raises"):
                raise ValueError
        with obs.span("t.after"):
            pass

    d = _delta(work)
    assert d["spans"]["t.raises"]["count"] == 1
    assert d["spans"]["t.after"]["parents"] == [""]


def test_threads_do_not_mix():
    """A span open on one thread is no parent of another thread's, and
    takes no self time from it."""
    started, release = threading.Event(), threading.Event()

    def other():
        with obs.span("t.theirs"):
            started.set()
            release.wait(5)
            _spin(0.003)

    def work():
        with obs.span("t.mine") as mine:
            t = threading.Thread(target=other)
            t.start()
            assert started.wait(5)
            release.set()
            t.join(5)
            assert not t.is_alive()
        work.mine = mine

    d = _delta(work)
    assert d["spans"]["t.theirs"]["parents"] == [""]
    assert "t.mine/t.theirs" not in d["paths"]
    assert d["spans"]["t.mine"]["total_s"] == pytest.approx(
        work.mine.seconds, abs=1e-9)
    assert d["spans"]["t.mine"]["self_s"] == pytest.approx(
        work.mine.seconds - _children_s(d, "t.mine"), abs=1e-9)
    # The thread has ended: its share is folded into the totals and kept.
    again = obs.totals()["spans"]["t.theirs"]
    assert again["count"] >= 1


def _forked_view(queue):
    live = [st.thread is threading.current_thread() for st in obs._threads]
    queue.put((live, obs.totals()["spans"]["t.before_fork"]["count"]))


def test_a_forked_child_retires_the_other_threads():
    """In a forked child only the forking thread lives on: the parent's
    other threads are retired at the fork, their aggregates kept, and
    no ``is_alive()`` is asked of a thread the child does not have."""
    ready, release = threading.Event(), threading.Event()

    def other():
        with obs.span("t.before_fork"):
            pass
        ready.set()
        release.wait(10)

    t = threading.Thread(target=other)
    t.start()
    try:
        assert ready.wait(5)
        ctx = multiprocessing.get_context("fork")
        queue = ctx.Queue()
        child = ctx.Process(target=_forked_view, args=(queue,))
        child.start()
        live, count = queue.get(timeout=30)
        child.join(30)
        assert child.exitcode == 0
    finally:
        release.set()
        t.join(10)
    assert not t.is_alive()
    assert all(live) and count >= 1


def test_many_threads_count_every_span():
    """Each thread keeps its own aggregates: no increment is lost when
    many threads enter the same span at once."""
    n_threads, n_spans = 8, 500

    def one():
        for _ in range(n_spans):
            with obs.span("t.many"):
                obs.count("t.many")

    def work():
        threads = [threading.Thread(target=one) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        assert not any(t.is_alive() for t in threads)

    d = _delta(work)
    assert d["spans"]["t.many"]["count"] == n_threads * n_spans
    assert d["counters"]["t.many"] == n_threads * n_spans


def test_diff_merge_and_counters():
    def counts():
        obs.count("t.c", 3)
        obs.count("t.c")

    def one_span():
        with obs.span("t.m"):
            pass

    a = _delta(counts)
    assert a["counters"] == {"t.c": 4}
    b = _delta(one_span)
    both = obs.merge([a, b, b])
    assert both["counters"]["t.c"] == 4
    assert both["spans"]["t.m"]["count"] == 2
    assert both["spans"]["t.m"]["total_s"] == pytest.approx(
        2 * b["spans"]["t.m"]["total_s"])
    # Nothing happened: nothing moved.
    now = obs.totals()
    assert obs.diff(now, now) == {"paths": {}, "spans": {}, "counters": {}}
    assert json.loads(json.dumps(both)) == both


def test_gc_is_a_span_beneath_the_collecting_span():
    def work():
        with obs.span("t.collects") as outer:
            gc.collect()
        work.outer = outer

    d = _delta(work)
    gc_span = d["paths"]["t.collects/host.gc"]
    assert gc_span["count"] >= 1 and gc_span["total_s"] > 0
    outer = d["spans"]["t.collects"]
    assert outer["total_s"] == pytest.approx(work.outer.seconds, abs=1e-9)
    assert outer["self_s"] == pytest.approx(
        outer["total_s"] - gc_span["total_s"], abs=1e-9)


def test_timeline_is_bounded_and_off_by_default():
    assert obs.intervals() == []
    collecting = gc.isenabled()
    gc.disable()           # no collection's span among the three kept
    obs.keep_intervals(3)
    try:
        for i in range(5):
            with obs.span(f"t.iv{i}"):
                pass
        assert [iv[0] for iv in obs.intervals()] == ["t.iv2", "t.iv3",
                                                     "t.iv4"]
        name, parent, tid, t0, t1 = obs.intervals()[-1]
        assert parent == "" and tid == threading.get_ident() and t0 <= t1
    finally:
        obs.keep_intervals(0)
        if collecting:
            gc.enable()
    with obs.span("t.after_off"):
        pass
    assert obs.intervals() == []


def test_merge_by_name_and_under():
    rec = {"paths": {"a": {"count": 1, "total_s": 3.0, "self_s": 1.0},
                     "a/b": {"count": 2, "total_s": 2.0, "self_s": 2.0},
                     "c/b": {"count": 1, "total_s": 5.0, "self_s": 5.0}}}
    rec = obs.merge([rec])
    assert rec["spans"]["b"]["self_s"] == 7.0
    assert rec["spans"]["b"]["count"] == 3
    assert obs.under(rec, "a") == {"a": 1.0, "b": 2.0}
    assert rec["spans"]["b"]["parents"] == ["a", "c"]


# ---------------------------------------------- the placement path's spans
def _fleet_run(tasks):
    runner = EvalRunner(workers=0, engine=CUDA_ON_CPU)
    records = runner.run(tasks)
    return records, runner.last_stats


def _tasks(runs=2, num_jobs=30, seed0=4321):
    return make_tasks(CONFIGS, runs, num_jobs, 2.0, seed0, trace_kw=SMALL)


def _strip(records):
    return json.dumps([{k: v for k, v in r.items() if k != "sim_s"}
                       for r in records], sort_keys=True)


def test_fleet_spans_account_for_sim_s_and_the_broker():
    records, stats = _fleet_run(_tasks())
    fleet = stats["fleet"]
    trace, broker = fleet["trace"], fleet["broker"]
    spans = trace["spans"]
    beneath = obs.under(trace, "sim.run")
    sim_s = sum(r["sim_s"] for r in records)
    assert spans["sim.run"]["count"] == len(records)
    assert sum(beneath.values()) == pytest.approx(sim_s, rel=0.01)
    assert broker["park_s"] == pytest.approx(spans["broker.wait"]["total_s"],
                                             rel=1e-9)
    assert broker["engine_s"] == pytest.approx(
        spans["broker.engine"]["total_s"], rel=1e-9)
    for name in ("policy.place", "reconfig.plan_search", "reconfig.derive",
                 "torus.prefetch", "broker.lead", "fitmask.stage",
                 "fitmask.readback"):
        assert spans[name]["count"] > 0, name
    assert spans["policy.place"]["parents"] == ["sim.run"]
    assert "fitmask.launch" not in spans   # plain versions on the CPU
    c = trace["counters"]
    assert 0 < c["folding.misses"] <= c["folding.lookups"]


def test_per_task_path_carries_its_trace():
    runner = EvalRunner(workers=0, engine=EngineConfig(
        "numpy", fleet_size=0))
    records = runner.run(_tasks(runs=1, num_jobs=15))
    trace = runner.last_stats["trace"]
    assert trace["spans"]["sim.run"]["count"] == len(records)
    assert "fleet" not in runner.last_stats


def test_timeline_changes_no_schedule(timeline):
    tasks = _tasks(runs=1, num_jobs=30, seed0=97)
    on, _ = _fleet_run(tasks)
    assert any(iv[0] == "sim.run" for iv in obs.intervals())
    obs.keep_intervals(0)
    off, _ = _fleet_run(tasks)
    assert _strip(on) == _strip(off)


def test_inline_client_seconds_are_its_span():
    client = InlineMaskClient(ops.get_engine("cuda", device="cpu"))
    occ = np.random.default_rng(0).random((2, 4, 4, 4)) < 0.3

    def work():
        client.multibox(occ, [(2, 2, 2)])
        client.multibox(occ, [(1, 2, 2), (2, 2, 1)])
        client.free_counts(occ)

    d = _delta(work)
    inline = d["spans"]["maskquery.inline"]
    assert inline["count"] == 3
    assert client.seconds == pytest.approx(inline["total_s"], rel=1e-9)
    assert d["spans"]["fitmask.readback"]["parents"] == ["maskquery.inline"]


def test_fold_lookups_and_misses():
    shape = JobShape((6, 10, 14))   # a shape no other test enumerates

    def work():
        enumerate_folds(shape, max_dim=64)
        enumerate_folds(shape, max_dim=64)

    d = _delta(work)
    assert d["counters"]["folding.lookups"] == 2
    assert d["counters"]["folding.misses"] == 1
    assert d["spans"]["folding.enumerate"]["count"] == 1
