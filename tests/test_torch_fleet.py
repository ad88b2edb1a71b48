"""Port parity for the fleet layer (``repro_torch.sim.fleet`` and the eval
runner's two-level pool), mirroring ``tests/test_fleet.py``: broker
coalescing and bit-exactness on every CPU-capable engine (``numpy``,
``torch`` and ``cuda`` on ``device="cpu"``, the kernels' plain
versions), continuous (quorum/timeout) flush scheduling, the host
boundary (answers copied with ``.cpu()``, never ``np.asarray``),
engine errors reaching the caller unless failover down
``cuda → torch → numpy`` is asked for, and fleet records equal to
``repro.eval``'s."""
import json
import sys
import threading
import time

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.eval import make_tasks as ref_make_tasks
from repro.eval.runner import run_fleet_tasks as ref_run_fleet_tasks
from repro_torch.core.allocator import make_policy
from repro_torch.core.engineconfig import EngineConfig, failover_candidates
from repro_torch.eval import EvalRunner, make_tasks
from repro_torch.eval.runner import (iter_checkpoints, make_fleet_chunks,
                                     run_fleet_tasks, task_grid_bucket)
from repro_torch.kernels import _build
from repro_torch.kernels.fitmask import ops
from repro_torch.sim.fleet import Fleet, QueryBroker
from repro_torch.sim.simulator import Simulator
from repro_torch.traces.generator import TraceConfig, generate_trace

torch.set_num_threads(1)

NUMPY = EngineConfig("numpy")
TORCH = EngineConfig("torch", device="cpu")
CUDA = EngineConfig("cuda", device="cpu")
ENGINES = [NUMPY, TORCH, CUDA]


def engine_id(cfg):
    return cfg.engine


# Small matrix covering both cluster models and two grid cell shapes.
CONFIGS = [
    ("RFold (4^3)", "rfold", dict(num_xpus=512, cube_n=4)),
    ("Reconfig (4^3)", "reconfig", dict(num_xpus=512, cube_n=4)),
    ("Folding (8^3)", "folding", dict(dims=(8, 8, 8))),
    ("FirstFit (8^3)", "firstfit", dict(dims=(8, 8, 8))),
]


def _tasks(runs=2, num_jobs=25, mk=make_tasks):
    return mk(CONFIGS, runs=runs, num_jobs=num_jobs, load=1.5, seed0=100)


def _strip(records):
    """Records without ``sim_s``, as canonical JSON: a NaN percentile (no
    job finished) then compares equal to itself."""
    return json.dumps([{k: v for k, v in r.items() if k != "sim_s"}
                       for r in records], sort_keys=True)


def _occ(rng, b, cell):
    return rng.random((b,) + cell) < 0.4


def _oracle():
    return ops.get_engine("numpy")


def _run_threads(target, n, timeout=30):
    threads = [threading.Thread(target=target, args=(i,), daemon=True)
               for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=timeout)
    assert not any(t.is_alive() for t in threads)


# ------------------------------------------------------------- broker
@pytest.mark.parametrize("cfg", ENGINES, ids=engine_id)
def test_solo_broker_matches_inline_engine(cfg):
    """An unregistered broker answers immediately and bit-exactly, with
    host numpy arrays."""
    rng = np.random.default_rng(0)
    occ = _occ(rng, 3, (6, 6, 6))
    boxes = ((2, 2, 1), (3, 1, 2), (6, 6, 6))
    broker = QueryBroker(cfg)
    planes = broker.multibox(occ, boxes)
    free = broker.free_counts(occ)
    assert isinstance(planes, np.ndarray) and isinstance(free, np.ndarray)
    np.testing.assert_array_equal(planes != 0,
                                  _oracle().multibox(occ, boxes) != 0)
    np.testing.assert_array_equal(free, _oracle().free_counts(occ))
    assert free.dtype == np.int64
    assert broker.stats.batched_calls == 0
    assert broker.stats.engine_failovers == 0


@pytest.mark.parametrize("cfg", ENGINES, ids=engine_id)
def test_broker_coalesces_and_splits_exactly(cfg):
    """Three concurrent requests over the same cell shape: one engine
    call, every requester gets its own grids and its own boxes back,
    in its own order."""
    rng = np.random.default_rng(1)
    cell = (5, 5, 5)
    reqs = [(_occ(rng, b, cell), boxes) for b, boxes in
            [(1, ((2, 2, 2), (1, 1, 4))),
             (4, ((1, 1, 4), (3, 3, 1))),
             (2, ((5, 5, 5),))]]
    broker = QueryBroker(cfg)
    results = [None] * len(reqs)

    def worker(i):
        occ, boxes = reqs[i]
        results[i] = broker.multibox(occ, boxes)

    for _ in reqs:
        broker.register()
    _run_threads(worker, len(reqs))
    for (occ, boxes), out in zip(reqs, results):
        np.testing.assert_array_equal(out != 0,
                                      _oracle().multibox(occ, boxes) != 0)
    assert broker.stats.engine_calls == 1          # one coalesced call
    assert broker.stats.batched_calls == 1
    assert broker.stats.max_coalesced == 3
    assert broker.stats.max_grids == 7             # 1 + 4 + 2 stacked


@pytest.mark.parametrize("cfg", ENGINES, ids=engine_id)
def test_broker_buckets_by_cell_shape(cfg):
    """Different grid cell shapes cannot share a pass: two engine
    calls, both answered correctly."""
    rng = np.random.default_rng(2)
    grids = {"a": (_occ(rng, 2, (4, 4, 4)), ((2, 2, 2),)),
             "b": (_occ(rng, 1, (8, 8, 8)), ((3, 3, 3),))}
    broker = QueryBroker(cfg)
    results = {}

    def worker(i):
        key = "ab"[i]
        results[key] = broker.multibox(*grids[key])

    broker.register()
    broker.register()
    _run_threads(worker, 2)
    for key, (occ, boxes) in grids.items():
        np.testing.assert_array_equal(results[key] != 0,
                                      _oracle().multibox(occ, boxes) != 0)
    assert broker.stats.engine_calls == 2
    assert broker.stats.batched_calls == 0


def test_deactivate_triggers_pending_flush():
    """A simulator finishing while its peer waits must flush the
    peer's round — nobody else will (no quorum possible, no deadline
    set)."""
    broker = QueryBroker(CUDA)
    broker.register()
    broker.register()
    occ = np.zeros((1, 4, 4, 4), dtype=bool)
    out = {}

    def waiter():
        out["res"] = broker.multibox(occ, ((2, 2, 2),))

    t = threading.Thread(target=waiter, daemon=True)
    t.start()
    deadline = time.monotonic() + 10
    while not broker.stats.requests and time.monotonic() < deadline:
        time.sleep(0.001)              # parked, waiting for its peer
    broker.deactivate()                # peer finishes without querying
    t.join(timeout=5)
    assert not t.is_alive()
    assert int(np.count_nonzero(out["res"])) == 27   # 3^3 origins fit
    assert broker.stats.flush_all_parked == 1


def test_host_free_counts_answered_inline():
    """On the host engine a free-count query never parks."""
    broker = QueryBroker(NUMPY)
    broker.register()
    broker.register()      # a peer that never queries
    occ = np.zeros((2, 4, 4, 4), dtype=bool)
    assert broker.free_counts(occ).tolist() == [64, 64]
    assert broker.stats.fc_inline == 1
    assert broker.stats.flushes == 0
    broker.deactivate()
    broker.deactivate()


@pytest.mark.parametrize("cfg", [NUMPY, CUDA], ids=engine_id)
def test_quorum_flush_does_not_wait_for_stragglers(cfg):
    """With a half-fleet quorum, two parked steppers out of four are
    answered without the other two ever querying."""
    broker = QueryBroker(cfg, quorum=0.5)
    for _ in range(4):
        broker.register()
    occ = np.zeros((1, 4, 4, 4), dtype=bool)
    outs = [None, None]

    def worker(i):
        outs[i] = broker.multibox(occ, ((1, 1, 1),))

    _run_threads(worker, 2, timeout=5)
    for out in outs:
        assert int(np.count_nonzero(out)) == 64
    assert broker.stats.flush_quorum >= 1
    for _ in range(4):
        broker.deactivate()


@pytest.mark.parametrize("cfg", [NUMPY, CUDA], ids=engine_id)
def test_timeout_flush_bounds_the_wait(cfg):
    """A lone parked query in a live fleet is answered once the
    deadline elapses, not when the fleet drains."""
    broker = QueryBroker(cfg, timeout=0.005)
    broker.register()
    broker.register()      # peer that never queries
    occ = np.zeros((1, 4, 4, 4), dtype=bool)
    t0 = time.monotonic()
    out = broker.multibox(occ, ((4, 4, 4),))
    assert time.monotonic() - t0 < 2.0
    assert int(np.count_nonzero(out)) == 1
    assert broker.stats.flush_timeout == 1
    broker.deactivate()
    broker.deactivate()


@pytest.mark.parametrize("cfg", [TORCH, CUDA], ids=engine_id)
def test_fc_content_cache_serves_free_counts_after_multibox(cfg):
    """Device engines: a multibox flush's fused free counts are
    remembered, so free_counts on the same occupancy never parks."""
    broker = QueryBroker(cfg)
    rng = np.random.default_rng(8)
    occ = rng.random((2, 5, 5, 5)) < 0.4
    broker.multibox(occ, ((2, 2, 2),))
    flushes = broker.stats.flushes
    fc = broker.free_counts(occ)
    np.testing.assert_array_equal(fc, _oracle().free_counts(occ))
    assert fc.dtype == np.int64
    assert broker.stats.fc_cache_hits == 1
    assert broker.stats.flushes == flushes   # answered without a round


class _ShapeSpy:
    """Wraps an engine and records the (B, K) of every multibox call."""

    def __init__(self, engine):
        self.engine = engine
        self.calls = []

    def multibox(self, occ, boxes):
        self.calls.append((occ.shape[0], tuple(boxes)))
        return self.engine.multibox(occ, boxes)

    def free_counts(self, occ):
        return self.engine.free_counts(occ)


def test_device_engines_do_not_pad():
    """The port's engines take B and K as launch arguments: a flush
    stacks exactly its requests' grids and the sorted union of their
    boxes, and each request gets its own planes in its own box order."""
    spy = _ShapeSpy(ops.get_engine("cuda", device="cpu"))
    broker = QueryBroker(spy, timeout=None)
    rng = np.random.default_rng(9)
    occs = [_occ(rng, 2, (5, 5, 5)), _occ(rng, 1, (5, 5, 5))]
    boxes = [((3, 1, 2), (1, 1, 1)), ((2, 2, 2), (1, 1, 1))]
    outs = [None, None]
    for _ in range(2):
        broker.register()

    def worker(i):
        try:
            outs[i] = broker.multibox(occs[i], boxes[i])
        finally:
            broker.deactivate()

    _run_threads(worker, 2)
    assert spy.calls == [(3, ((1, 1, 1), (2, 2, 2), (3, 1, 2)))]
    for occ, bx, out in zip(occs, boxes, outs):
        np.testing.assert_array_equal(out != 0,
                                      _oracle().multibox(occ, bx) != 0)
    assert broker.stats.grids == 3 and broker.stats.max_coalesced == 2


class _Boom:
    def multibox(self, occ, boxes):
        raise RuntimeError("engine down")

    def free_counts(self, occ):
        raise RuntimeError("engine down")


def test_broker_propagates_engine_errors():
    broker = QueryBroker(_Boom())
    assert broker.engine_name is None
    with pytest.raises(RuntimeError, match="engine down"):
        broker.multibox(np.zeros((1, 4, 4, 4), dtype=bool), ((1, 1, 1),))
    with pytest.raises(RuntimeError, match="engine down"):
        broker.free_counts(np.zeros((1, 4, 4, 4), dtype=bool))


def test_broker_rejects_unbatched_grids():
    with pytest.raises(ValueError, match=r"\(B, X, Y, Z\)"):
        QueryBroker(NUMPY).free_counts(np.zeros((4, 4, 4), dtype=bool))


def test_fleet_surfaces_unit_exception():
    def bad(broker):
        raise ValueError("sim exploded")

    def good(broker):
        return int(broker.free_counts(
            np.zeros((1, 2, 2, 2), dtype=bool))[0])

    with pytest.raises(ValueError, match="sim exploded"):
        Fleet(NUMPY).run([bad, good])


# ------------------------------------------------------ the host boundary
class _DeviceAnswer:
    """Stands in for a CUDA tensor: ``np.asarray`` raises on it (as on a
    tensor on the card), ``.detach().cpu()`` gives the host tensor."""

    def __init__(self, t):
        self._t = t

    def __array__(self, *args, **kwargs):
        raise TypeError("can't convert cuda:0 device type tensor to numpy")

    def detach(self):
        return self

    def cpu(self):
        return self._t


class _CardLikeEngine(ops.CudaEngine):
    def multibox(self, occ, boxes):
        return _DeviceAnswer(super().multibox(occ, boxes))

    def free_counts(self, occ):
        return _DeviceAnswer(super().free_counts(occ))

    def multibox_bucketed(self, occ, boxes):
        planes, free = super().multibox_bucketed(occ, boxes)
        return _DeviceAnswer(planes), _DeviceAnswer(free)


def test_answers_that_refuse_np_asarray_are_copied_without_failover(
        monkeypatch):
    """The broker takes answers with ``.cpu()``: an answer that
    ``np.asarray`` refuses, as it refuses a CUDA tensor, is answered on
    the ``cuda`` engine itself, with no retry and no failover."""
    monkeypatch.setitem(ops._INSTANCES, ("cuda", "cpu"),
                        _CardLikeEngine(device="cpu"))
    rng = np.random.default_rng(3)
    occ = _occ(rng, 3, (5, 5, 5))
    with pytest.raises(TypeError):
        np.asarray(ops.get_engine("cuda", device="cpu").free_counts(occ))
    broker = QueryBroker(CUDA)
    assert isinstance(broker.engine, _CardLikeEngine)
    boxes = ((2, 2, 2), (1, 3, 1))
    planes = broker.multibox(occ, boxes)
    np.testing.assert_array_equal(planes, _oracle().multibox(occ, boxes) != 0)
    other = _occ(rng, 2, (5, 5, 5))          # misses the content cache
    np.testing.assert_array_equal(broker.free_counts(other),
                                  _oracle().free_counts(other))
    s = broker.stats
    assert (s.engine_retries, s.engine_failovers, s.canary_checks) == (0, 0, 0)
    assert broker.engine_name == "cuda" and s.fc_cache_misses == 1


# ------------------------------------------------ containment and failover
def test_engine_error_reaches_the_waiters_without_failover():
    """By default the broker neither retries nor fails over: an engine
    error ends the query, and the engine stays the one asked for."""
    broker = QueryBroker(CUDA)
    occ = _occ(np.random.default_rng(5), 2, (5, 5, 5))
    broker.inject_engine_faults(1)
    with pytest.raises(RuntimeError, match="injected engine fault"):
        broker.multibox(occ, ((2, 2, 2),))
    s = broker.stats
    assert (s.engine_retries, s.engine_failovers, s.canary_checks) == (0, 0, 0)
    assert broker.engine_name == "cuda" and s.failover_engine is None
    np.testing.assert_array_equal(broker.multibox(occ, ((2, 2, 2),)) != 0,
                                  _oracle().multibox(occ, ((2, 2, 2),)) != 0)


class _FailingCuda(ops.CudaEngine):
    def multibox_bucketed(self, occ, boxes):
        raise RuntimeError("kernel launch failed")


def test_eval_fleet_raises_when_the_engine_fails(monkeypatch):
    """A fleet eval whose engine fails raises: it never goes on in the
    plain version or on the host."""
    monkeypatch.setitem(ops._INSTANCES, ("cuda", "cpu"),
                        _FailingCuda(device="cpu"))
    runner = EvalRunner(workers=0, engine=CUDA)
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        runner.run(_tasks(runs=1, num_jobs=10))


def test_failover_chain_is_the_ports():
    assert failover_candidates("cuda") == ("torch", "numpy")
    assert failover_candidates("torch") == ("numpy",)
    assert failover_candidates("numpy") == ()


def test_injected_faults_fail_over_on_the_same_device():
    """Two injected faults exhaust the attempt and the retry on ``cuda``;
    the broker adopts ``torch`` on the same device, answers bit-exactly
    and canary-checks the next flushes against numpy."""
    broker = QueryBroker(CUDA, failover=True)
    rng = np.random.default_rng(2)
    occ = _occ(rng, 4, (5, 5, 5))
    boxes = ((2, 2, 1), (3, 1, 2))
    broker.inject_engine_faults(2)
    np.testing.assert_array_equal(broker.multibox(occ, boxes) != 0,
                                  _oracle().multibox(occ, boxes) != 0)
    assert broker.engine_name == "torch"
    assert broker.engine is ops.get_engine("torch", device="cpu")
    s = broker.stats
    assert (s.engine_retries, s.engine_failovers) == (1, 1)
    assert s.failover_engine == "torch"
    assert s.canary_checks == 1 and s.canary_mismatches == 0
    broker.inject_engine_faults(2)             # torch fails too: numpy
    other = _occ(rng, 2, (5, 5, 5))            # misses the cache
    np.testing.assert_array_equal(broker.free_counts(other),
                                  _oracle().free_counts(other))
    assert broker.engine_name == "numpy" and s.engine_failovers == 2


def test_single_transient_fault_retries_in_place():
    broker = QueryBroker(CUDA, failover=True)
    occ = _occ(np.random.default_rng(3), 2, (5, 5, 5))
    broker.inject_engine_faults(1)
    planes = broker.multibox(occ, ((2, 2, 2),))
    np.testing.assert_array_equal(planes != 0,
                                  _oracle().multibox(occ, ((2, 2, 2),)) != 0)
    assert broker.engine_name == "cuda"
    assert broker.stats.engine_retries == 1
    assert broker.stats.engine_failovers == 0


def test_dead_stepper_is_reaped():
    """A registered stepper that dies without deactivating cannot hang
    the survivor: the watchdog reaps it and the round flushes."""
    broker = QueryBroker(CUDA)
    occ = _occ(np.random.default_rng(4), 2, (5, 5, 5))
    boxes = ((2, 2, 1),)

    def doomed():
        broker.register(thread=threading.current_thread())

    t_dead = threading.Thread(target=doomed, daemon=True)
    t_dead.start()
    t_dead.join(timeout=5)
    out = {}

    def survivor(_):
        broker.register(thread=threading.current_thread())
        try:
            out["planes"] = broker.multibox(occ, boxes)
        finally:
            broker.deactivate()

    _run_threads(survivor, 1)
    np.testing.assert_array_equal(out["planes"] != 0,
                                  _oracle().multibox(occ, boxes) != 0)
    assert broker.stats.steppers_reaped == 1


# ------------------------------------------------------- fleet policy
def test_fleet_takes_device_and_flush_fields_from_the_config():
    cfg = EngineConfig("cuda", device="cpu", quorum=0.5, timeout=0.25,
                       max_inflight=3)
    broker = Fleet(cfg).broker
    assert (broker.engine_name, str(broker.device)) == ("cuda", "cpu")
    assert (broker.quorum, broker.timeout, broker.max_inflight) == \
        (0.5, 0.25, 3)
    assert Fleet(cfg, quorum=1.0).broker.quorum == 1.0   # kwargs win
    assert cfg.fleet_kwargs() == {"engine": "cuda", "device": "cpu",
                                  "quorum": 0.5, "timeout": 0.25,
                                  "max_inflight": 3}
    assert Fleet(**cfg.fleet_kwargs()).broker.max_inflight == 3


def test_fleet_auto_policy_is_engine_aware():
    """Device engines get the barrier quorum, the 5 ms deadline and two
    lanes; the host engine drain mode with one lane."""
    dev = Fleet(CUDA).broker
    assert (dev.quorum, dev.timeout, dev.max_inflight, dev.host_free) == \
        (1.0, 0.005, 2, False)
    host = Fleet(NUMPY).broker
    assert (host.quorum, host.timeout, host.max_inflight, host.host_free) == \
        (0.0, 0.002, 1, True)


# ---------------------------------------------------- fleet-of-sims
def test_fleet_records_byte_identical_to_sequential():
    """Fleets produce the same records (minus timing) as the per-task
    oracle path, for both cluster models, while batching engine calls.
    The strict all-parked barrier makes the batching deterministic: the
    host engine's drain mode batches only queries that happen to park
    behind a live flush, which a loaded machine may never see."""
    tasks = _tasks()
    seq = EvalRunner(workers=0, engine=EngineConfig(
        "numpy", fleet_size=0)).run(tasks)
    runner = EvalRunner(workers=0, engine=EngineConfig(
        "numpy", fleet_size=4, quorum=1.0, timeout=None))
    fl = runner.run(tasks)
    assert _strip(seq) == _strip(fl)
    broker = runner.last_stats["fleet"]["broker"]
    assert broker["batched_calls"] > 0
    assert broker["mean_grids_per_call"] > 1
    for key in ("flush_all_parked", "flush_quorum", "flush_timeout",
                "requeued", "fc_inline", "park_s", "engine_s"):
        assert key in broker


@pytest.mark.parametrize("cfg", ENGINES, ids=engine_id)
def test_fleet_records_equal_the_references(cfg):
    """One chunk through the port's ``run_fleet_tasks`` on each engine
    gives ``repro.eval.run_fleet_tasks``'s records, ``sim_s`` aside."""
    want, _ = ref_run_fleet_tasks(_tasks(runs=1, num_jobs=20,
                                         mk=ref_make_tasks), engine="numpy")
    got, stats = run_fleet_tasks(_tasks(runs=1, num_jobs=20), engine=cfg)
    assert _strip(got) == _strip(want)
    assert stats["engine_failovers"] == 0 and stats["engine_calls"] > 0


def test_fleet_pool_records_identical(tmp_path):
    """Two-level pool (processes x fleets) returns the same records
    and writes every checkpoint worker-side."""
    tasks = _tasks(runs=2)
    seq = EvalRunner(workers=0, engine=EngineConfig(
        "numpy", fleet_size=0)).run(tasks)
    ckpt = str(tmp_path / "ckpt")
    runner = EvalRunner(checkpoint_dir=ckpt, workers=2,
                        engine=EngineConfig("numpy", fleet_size=2))
    assert runner.start_method() == "fork" or sys.platform != "linux"
    fl = runner.run(tasks)
    assert _strip(seq) == _strip(fl)
    assert len(list(iter_checkpoints(ckpt))) == len(tasks)
    resumed = EvalRunner(checkpoint_dir=ckpt, workers=2,
                         engine=EngineConfig("numpy", fleet_size=2))
    resumed.run(tasks)
    assert resumed.last_stats["reused_from_checkpoint"] == len(tasks)


def test_run_fleet_tasks_engine_override_is_bit_exact():
    """The broker's engine choice cannot change records."""
    tasks = _tasks(runs=1, num_jobs=15)
    base, _ = run_fleet_tasks(tasks, engine=NUMPY)
    ref, stats = run_fleet_tasks(tasks, engine=EngineConfig("ref",
                                                            device="cpu"))
    assert _strip(base) == _strip(ref)
    assert stats["engine_calls"] > 0


# ------------------------------------- continuous-scheduling parity
def _random_query_plan(rng, cell, n_steppers):
    """Per-stepper deterministic query sequences over one cell shape:
    a mix of multibox (random B, random boxes) and free_counts."""
    plans = []
    for _ in range(n_steppers):
        steps = []
        for _s in range(int(rng.integers(1, 5))):
            occ = rng.random((int(rng.integers(1, 4)),) + cell) < 0.5
            if rng.random() < 0.75:
                boxes = tuple(
                    tuple(int(v) for v in rng.integers(1, 5, size=3))
                    for _ in range(int(rng.integers(1, 4))))
                steps.append(("multibox", occ, boxes))
            else:
                steps.append(("free_counts", occ, None))
        plans.append(steps)
    return plans


def _check_interleaving(broker, plans, seed):
    """Run the plans on steppers with random pauses and check every
    answer against the numpy oracle on the same inputs."""
    n = len(plans)
    outs = [[] for _ in range(n)]
    errs = []

    def stepper(i):
        r = np.random.default_rng(seed ^ (i + 1))
        try:
            for kind, occ, boxes in plans[i]:
                time.sleep(float(r.random()) * 0.002)  # interleave
                if kind == "multibox":
                    outs[i].append(broker.multibox(occ, boxes))
                else:
                    outs[i].append(broker.free_counts(occ))
        except BaseException as e:  # noqa: BLE001 — surfaced below
            errs.append(e)
        finally:
            broker.deactivate()

    for _ in range(n):
        broker.register()
    _run_threads(stepper, n)
    assert not errs
    for i, steps in enumerate(plans):
        for (kind, occ, boxes), got in zip(steps, outs[i]):
            if kind == "multibox":
                np.testing.assert_array_equal(
                    got != 0, _oracle().multibox(occ, boxes) != 0)
            else:
                np.testing.assert_array_equal(got,
                                              _oracle().free_counts(occ))
    assert broker.stats.requests == sum(len(p) for p in plans)


@settings(max_examples=12, deadline=None)
@given(st.integers(0, 2**31 - 1),
       st.sampled_from([0.25, 0.5, 0.75, 1.0]),
       st.sampled_from([-1, 0, 1, 3]),    # -1: no deadline; ms otherwise
       st.sampled_from([0, 1, 2]))        # engine: numpy, torch, cuda
def test_schedules_byte_identical_under_random_interleaving(
        seed, quorum, timeout_ms, engine):
    """Across randomized stepper interleavings, quorum fractions and
    timeout firings (0 ms forces a deadline flush on every tick), every
    query's answer equals the inline oracle's on the same inputs."""
    timeout = None if timeout_ms < 0 else timeout_ms / 1000.0
    rng = np.random.default_rng(seed)
    cell = tuple(int(v) for v in rng.integers(3, 7, size=3))
    plans = _random_query_plan(rng, cell, int(rng.integers(2, 5)))
    _check_interleaving(QueryBroker(ENGINES[engine], quorum=quorum,
                                    timeout=timeout), plans, seed)


@pytest.mark.parametrize("cfg", [TORCH, CUDA], ids=engine_id)
def test_interleaving_parity_with_fused_counts(cfg):
    """Fused free counts, the content cache, a quorum of half and a
    deadline all stay invisible in the answers."""
    seed = 1234
    rng = np.random.default_rng(seed)
    plans = _random_query_plan(rng, (5, 5, 5), 3)
    broker = QueryBroker(cfg, quorum=0.5, timeout=0.003)
    _check_interleaving(broker, plans, seed)


# ------------------------------------------------- chunking / sizing
def test_task_grid_bucket_defaults_mirror_make_policy():
    tasks = _tasks(runs=1)
    buckets = {t.label: task_grid_bucket(t) for t in tasks}
    assert buckets["RFold (4^3)"] == ("cube", 4)
    assert buckets["Folding (8^3)"] == ("static", (8, 8, 8))
    t = make_tasks([("x", "folding", {})], runs=1, num_jobs=5, load=1.0,
                   seed0=0)[0]
    assert task_grid_bucket(t) == ("static", (16, 16, 16))


def test_make_fleet_chunks_groups_buckets_and_caps_size():
    tasks = _tasks(runs=3)             # 6 cube tasks + 6 static tasks
    chunks = make_fleet_chunks(tasks, list(range(len(tasks))), 4)
    assert sorted(i for c in chunks for i in c) == list(range(len(tasks)))
    for chunk in chunks:
        assert len(chunk) <= 4
        assert len({task_grid_bucket(tasks[i]) for i in chunk}) == 1


def test_auto_fleet_size_scales_with_pending_and_workers():
    r = EvalRunner(workers=2, engine=EngineConfig("torch", device="cpu",
                                                  fleet_size="auto"))
    assert r._resolve_fleet_size(24) == 3     # ceil(24 / (4*2))
    assert r._resolve_fleet_size(800) == 8    # capped
    assert r._resolve_fleet_size(2) == 2      # floor
    assert EvalRunner(workers=2, engine=EngineConfig(
        fleet_size=6))._resolve_fleet_size(24) == 6
    assert EvalRunner(workers=2, engine=EngineConfig(
        fleet_size=0))._resolve_fleet_size(24) is None


def test_auto_fleets_on_device_engines_and_runs_numpy_per_task():
    assert EvalRunner(workers=2)._resolve_fleet_size(24) == 3
    assert EvalRunner(workers=2, engine=CUDA)._resolve_fleet_size(24) == 3
    assert EvalRunner(workers=2, engine=TORCH)._resolve_fleet_size(24) == 3
    assert EvalRunner(workers=2, engine=NUMPY)._resolve_fleet_size(24) \
        is None
    assert EvalRunner(workers=2, engine=EngineConfig(
        "numpy", fleet_size=4))._resolve_fleet_size(24) == 4
    assert EvalRunner(workers=2, engine=EngineConfig(
        fleet_size=None))._resolve_fleet_size(24) is None


# ------------------------------------------ kernels' build and counters
def test_launch_counter_loses_no_count_across_threads():
    """``count_launch`` under contention (8 threads, a short switch
    interval): every bump lands."""
    def fn():
        pass
    fn.launches = 0
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        _run_threads(lambda i: [_build.count_launch(fn)
                                for _ in range(2000)], 8)
    finally:
        sys.setswitchinterval(old)
    assert fn.launches == 16000


def test_library_loads_once_across_threads():
    """Threads that miss together build and load a library once."""
    calls = []
    barrier = threading.Barrier(8, timeout=10)

    def factory():
        calls.append(1)
        time.sleep(0.01)
        return object()

    lib = _build.load_once(factory)
    got = [None] * 8

    def worker(i):
        barrier.wait()
        got[i] = lib()

    _run_threads(worker, 8)
    assert len(calls) == 1 and all(g is got[0] for g in got)
