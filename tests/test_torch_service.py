"""Port tests of the allocator service (``repro_torch.serve.scheduler``
and ``repro_torch.api``), mirroring ``tests/test_service.py``: protocol
round-trips, pushed topology events, client reconnect, crash-recovery
journal replay, admission control under overload, simulator-as-client
parity, broker sharing and the chaos ops over the wire.

Each test does what its namesake does, on the port. The daemon places
on the ``cuda`` engine's plain version on CPU tensors (``CUDA``) unless
a test is parametrized over the three engines (``numpy``, ``torch`` and
``cuda`` on the CPU); the default engine, the card's, raises here. The
schedules of the simulator-as-client test are also held to the
reference package's. ``tests/test_torch_service_parity.py`` holds
every reply, event, journal record and state digest of a seeded op
stream to ``repro``'s.
"""
import json
import time

import pytest
import torch

from repro.core.allocator import make_policy as ref_make_policy
from repro.sim.simulator import Simulator as RefSimulator
from repro.traces.generator import TraceConfig as RefTraceConfig
from repro.traces.generator import generate_trace as ref_generate_trace
from repro_torch import api
from repro_torch.api import (EngineConfig, JobShape, Scheduler,
                             SchedulerConfig, Simulator, TraceConfig,
                             generate_trace, make_policy)
from repro_torch.serve.scheduler import (DROPPED, EV_FAULT, EV_MIGRATE,
                                         EV_PREEMPT, EV_RECONFIG, EV_RELEASE,
                                         EV_REPAIR, EV_SETUP, MIGRATED,
                                         PLACED, PREEMPTED, QUEUED, REJECTED,
                                         AllocatorCore)
from repro_torch.sim.fleet import QueryBroker

torch.set_num_threads(1)

SMALL = dict(num_xpus=64, cube_n=4)      # one 4^3 cube: trivially full
MEDIUM = dict(num_xpus=512, cube_n=4)    # 8 cubes

NUMPY = EngineConfig("numpy")
TORCH = EngineConfig("torch", device="cpu")
CUDA = EngineConfig("cuda", device="cpu")
ENGINES = {"numpy": NUMPY, "torch-on-cpu": TORCH, "cuda-on-cpu": CUDA}
engines = pytest.mark.parametrize("engine", sorted(ENGINES))


def small_scheduler(engine=CUDA, **kw):
    return Scheduler(SchedulerConfig(policy="rfold", policy_kw=SMALL,
                                     engine=engine, **kw))


def medium_scheduler(engine=CUDA, **kw):
    return Scheduler(SchedulerConfig(policy="rfold", policy_kw=MEDIUM,
                                     engine=engine, **kw))


def pushed(s, n, max_wait=5.0):
    """Pushed events until ``n`` have arrived (or ``max_wait``), plus
    whatever follows within 50 ms: the whole list, without sleeping
    through a fixed window."""
    out = []
    deadline = time.monotonic() + max_wait
    while len(out) < n and time.monotonic() < deadline:
        out += s.events(max_wait=0.05)
    return out + s.events(max_wait=0.05)


# ---------------------------------------------------------- round-trips
@engines
def test_submit_place_done_roundtrip(engine):
    with small_scheduler(ENGINES[engine]) as s:
        r = s.submit((4, 4, 4))
        assert r["outcome"] == PLACED
        assert r["placement"]["shape"] == [4, 4, 4]
        st = s.status()
        assert st["busy_xpus"] == 64 and st["allocated"] == 1
        d = s.done(r["job_id"])
        assert d["ok"] and d["started"] == []
        assert s.status()["busy_xpus"] == 0


def test_fifo_queue_and_drain_on_done():
    with small_scheduler() as s:
        first = s.submit((4, 4, 4))
        second = s.submit((2, 2, 2))
        assert first["outcome"] == PLACED
        assert second["outcome"] == QUEUED  # head-of-line: cluster full
        d = s.done(first["job_id"])
        assert [x["job_id"] for x in d["started"]] == [second["job_id"]]
        assert d["started"][0]["outcome"] == PLACED


def test_infeasible_shape_dropped():
    with small_scheduler() as s:
        r = s.submit((100, 1, 1))  # 100 > 64 XPUs: never placeable
        assert r["outcome"] == DROPPED
        assert s.status()["queue_depth"] == 0


def test_duplicate_and_unknown_ids_error():
    with small_scheduler() as s:
        r = s.submit((4, 4, 4), job_id=7)
        assert r["outcome"] == PLACED
        with pytest.raises(RuntimeError, match="already known"):
            s.submit((2, 2, 2), job_id=7)
        with pytest.raises(RuntimeError, match="not known"):
            s.done(99)


def test_cancel_while_queued():
    with small_scheduler() as s:
        s.submit((4, 4, 4))
        q = s.submit((4, 4, 4))
        assert q["outcome"] == QUEUED
        d = s.done(q["job_id"])  # cancel the queued job
        assert d["ok"] and s.status()["queue_depth"] == 0


def test_bad_requests_keep_daemon_alive():
    with small_scheduler() as s:
        with pytest.raises(RuntimeError, match="unknown op"):
            s.client.call("frobnicate")
        with pytest.raises(RuntimeError, match="shape"):
            s.client.call("submit", shape=[4, 4])
        assert s.status()["ok"]  # daemon survived both


# -------------------------------------------------------------- events
def test_setup_reconfig_release_events():
    with medium_scheduler() as s:
        # 128 XPUs across 2 chained cubes: reconfiguration guaranteed.
        r = s.submit((8, 4, 4))
        assert r["outcome"] == PLACED
        s.done(r["job_id"])
        names = [e["event"] for e in pushed(s, 3)]
        assert names == [EV_SETUP, EV_RECONFIG, EV_RELEASE]


def test_single_cube_job_emits_no_reconfig():
    with small_scheduler() as s:
        r = s.submit((2, 2, 2))
        s.done(r["job_id"])
        evs = pushed(s, 2)
        assert [e["event"] for e in evs] == [EV_SETUP, EV_RELEASE]
        assert evs[1]["reconfigured"] is False


def test_events_carry_placement_detail():
    with small_scheduler() as s:
        s.submit((4, 4, 4))
        ev = pushed(s, 1)[0]
        assert ev["event"] == EV_SETUP
        assert "fold" in ev["detail"]
        assert ev["detail"]["cubes"] == [0]  # which cubes got wired up


def test_unsubscribed_client_gets_no_events():
    with small_scheduler() as s:
        other = s.new_client(subscribe=False)
        s.submit((2, 2, 2))
        assert pushed(s, 1)  # the subscribed handle sees them
        assert other.events(max_wait=0.2) == []
        other.close()


# ----------------------------------------------------------- reconnect
def test_client_reconnect_resumes_session():
    with small_scheduler() as s:
        r = s.submit((4, 4, 4))
        c = s.new_client()
        assert c.status()["allocated"] == 1
        c.close()
        c.connect()  # daemon state is server-side: nothing lost
        assert c.status()["allocated"] == 1
        c.done(r["job_id"])
        assert c.status()["allocated"] == 0
        c.close()


# ----------------------------------------------------------- admission
def test_admission_rejects_when_queue_full():
    with small_scheduler(max_queue=2) as s:
        assert s.submit((4, 4, 4))["outcome"] == PLACED
        assert s.submit((4, 4, 4))["outcome"] == QUEUED
        assert s.submit((4, 4, 4))["outcome"] == QUEUED
        r = s.submit((4, 4, 4))
        assert r["outcome"] == REJECTED
        # Rejection is stateless: no id consumed, no journal entry.
        st = s.status()
        assert st["queue_depth"] == 2 and st["journal_ops"] == 3


def test_rejected_submits_not_replayed(tmp_path):
    cfg = SchedulerConfig(policy="rfold", policy_kw=SMALL, max_queue=1,
                          engine=CUDA, checkpoint_dir=str(tmp_path),
                          checkpoint_every=1)
    with Scheduler(cfg) as s:
        s.submit((4, 4, 4))
        s.submit((4, 4, 4))
        assert s.submit((4, 4, 4))["outcome"] == REJECTED
        digest = s.status()["state_digest"]
    s2 = Scheduler(cfg).start()
    try:
        st = s2.status()
        assert st["state_digest"] == digest and st["journal_ops"] == 2
    finally:
        s2.stop()


# ------------------------------------------------------ crash recovery
@engines
def test_crash_recovery_byte_identical(tmp_path, engine):
    cfg = SchedulerConfig(policy="rfold", policy_kw=MEDIUM,
                          engine=ENGINES[engine],
                          checkpoint_dir=str(tmp_path), checkpoint_every=1)
    s = Scheduler(cfg).start()
    ids = [s.submit((4, 4, 4))["job_id"] for _ in range(6)]
    s.done(ids[2])
    digest, ops = (s.status()[k] for k in ("state_digest", "journal_ops"))
    s.kill()  # crash: no final checkpoint written

    s2 = Scheduler(cfg).start()
    try:
        st = s2.status()
        assert st["state_digest"] == digest
        assert st["journal_ops"] == ops
        assert s2._daemon.core.recovered_ops == ops
        # And the recovered daemon keeps allocating with fresh ids.
        r = s2.submit((4, 4, 4))
        assert r["outcome"] == PLACED and r["job_id"] not in ids
    finally:
        s2.stop()


def test_graceful_stop_checkpoints_without_cadence(tmp_path):
    """checkpoint_every=0 disables periodic snapshots; the final
    checkpoint on graceful shutdown still persists everything."""
    cfg = SchedulerConfig(policy="rfold", policy_kw=SMALL, engine=CUDA,
                          checkpoint_dir=str(tmp_path), checkpoint_every=0)
    with Scheduler(cfg) as s:
        s.submit((4, 4, 4))
        digest = s.status()["state_digest"]
    core = AllocatorCore.recover(cfg)
    assert core.state_digest() == digest and core.recovered_ops == 1


def test_changed_config_refuses_stale_journal(tmp_path):
    cfg = SchedulerConfig(policy="rfold", policy_kw=SMALL, engine=CUDA,
                          checkpoint_dir=str(tmp_path), checkpoint_every=1)
    with Scheduler(cfg) as s:
        s.submit((4, 4, 4))
    other = SchedulerConfig(policy="rfold", policy_kw=SMALL, backfill=True,
                            engine=CUDA, checkpoint_dir=str(tmp_path))
    assert cfg.fingerprint() != other.fingerprint()
    core = AllocatorCore.recover(other)
    assert core.recovered_ops == 0 and not core.journal


def test_fingerprint_ignores_transport_fields(tmp_path):
    a = SchedulerConfig(policy="rfold", port=1234, checkpoint_every=8)
    b = SchedulerConfig(policy="rfold", port=5678, checkpoint_every=99,
                        host="0.0.0.0")
    assert a.fingerprint() == b.fingerprint()


def test_fingerprint_ignores_the_engine_device(tmp_path):
    """The device is not part of the checkpoint identity: a journal
    written on the card resumes on the CPU and back, under every
    spelling of the device."""
    prints = {SchedulerConfig(policy="rfold", policy_kw=MEDIUM,
                              engine=EngineConfig("cuda", device=d))
              .fingerprint()
              for d in (None, "cuda", "cuda:0", torch.device("cuda", 0),
                        "cpu", torch.device("cpu"))}
    assert len(prints) == 1
    assert SchedulerConfig(engine=CUDA).fingerprint() != \
        SchedulerConfig(engine=NUMPY).fingerprint()
    # Moving a journal across devices: written on cuda-on-cpu, the
    # same config on another device spelling recovers it.
    cfg = SchedulerConfig(policy="rfold", policy_kw=MEDIUM, engine=CUDA,
                          checkpoint_dir=str(tmp_path), checkpoint_every=2)
    with Scheduler(cfg) as s:
        for dims in [(4, 4, 4), (8, 4, 4), (2, 2, 2)]:
            s.submit(dims)
        digest = s.status()["state_digest"]
    moved = SchedulerConfig(policy="rfold", policy_kw=MEDIUM,
                            engine=EngineConfig("cuda",
                                                device=torch.device("cpu")),
                            checkpoint_dir=str(tmp_path))
    core = AllocatorCore.recover(moved)
    assert core.recovered_ops == 3 and core.state_digest() == digest


def test_midtrace_restart_matches_uninterrupted_run(tmp_path):
    """Daemon killed mid-trace; the recovered daemon finishes the op
    stream and lands on the same final state as one that never died."""
    ops = ([("submit", (4, 4, 4))] * 5 + [("done", 1)]
           + [("submit", (2, 2, 2))] * 3 + [("done", 3), ("done", 0)])

    def play(sched, stream):
        for kind, arg in stream:
            if kind == "submit":
                sched.submit(arg)
            else:
                sched.done(arg)

    cfg = SchedulerConfig(policy="rfold", policy_kw=MEDIUM, engine=CUDA,
                          checkpoint_dir=str(tmp_path), checkpoint_every=1)
    s = Scheduler(cfg).start()
    play(s, ops[:6])
    s.kill()
    s = Scheduler(cfg).start()
    play(s, ops[6:])
    interrupted = s.status()["state_digest"]
    s.stop()

    with medium_scheduler() as ref:
        play(ref, ops)
        assert ref.status()["state_digest"] == interrupted


# ------------------------------------------- simulator-as-client parity
def _job_record(jobs):
    return json.dumps(
        [[j.job_id, j.start, j.finish, j.dropped, j.slowdown,
          j.placement_meta] for j in jobs],
        sort_keys=True, default=list)


@pytest.mark.parametrize("engine", ["numpy", "cuda-on-cpu"])
@pytest.mark.parametrize("policy,kw", [
    ("firstfit", dict(dims=(8, 8, 8))),
    ("folding", dict(dims=(8, 8, 8))),
    ("reconfig", MEDIUM),
    ("rfold", MEDIUM),
    ("rfold_be", MEDIUM),
])
def test_simulator_as_client_byte_identical(policy, kw, engine):
    """RemotePolicy through the Simulator gives the in-process schedule,
    which is the reference package's."""
    cfg = dict(num_jobs=40, cluster_xpus=512, size_max=512, seed=3)
    eng = ENGINES[engine]
    local = Simulator(make_policy(policy, engine=eng, **kw),
                      generate_trace(TraceConfig(**cfg))).run()
    with Scheduler(SchedulerConfig(policy=policy, policy_kw=kw,
                                   engine=eng)) as s:
        remote = Simulator(s.remote_policy(),
                           generate_trace(TraceConfig(**cfg))).run()
    ref = RefSimulator(ref_make_policy(policy, engine="numpy", **kw),
                       ref_generate_trace(RefTraceConfig(**cfg))).run()
    assert _job_record(remote.jobs) == _job_record(local.jobs)
    assert _job_record(remote.jobs) == _job_record(ref.jobs)


def test_remote_policy_contract():
    with small_scheduler() as s:
        pol = s.remote_policy()
        assert pol.name == "rfold" and pol.num_xpus == 64
        assert pol.can_ever_place(JobShape((4, 4, 4)))
        assert not pol.can_ever_place(JobShape((100, 1, 1)))
        p = pol.try_place(0, JobShape((2, 2, 2)))
        assert p.job_id == 0 and p.shape.dims == (2, 2, 2)
        assert isinstance(p.broken_rings, tuple)
        assert pol.try_place(1, JobShape((4, 4, 4))) is None  # full now
        assert pol.utilization() == pytest.approx(8 / 64)
        pol.release(0)
        assert pol.busy_xpus == 0
        pol.client.close()


# ------------------------------------------------------- broker sharing
@pytest.mark.parametrize("engine", ["numpy", "cuda-on-cpu"])
def test_daemon_shares_query_broker(engine):
    """The daemon registers as one more broker client: its placement
    queries ride the same batched engine path as fleet simulation, and
    results match the unshared daemon bit-for-bit."""
    eng = ENGINES[engine]
    broker = QueryBroker(eng, quorum=0)  # drain mode: solo-safe
    with Scheduler(SchedulerConfig(policy="rfold", policy_kw=MEDIUM,
                                   engine=eng),
                   mask_client=broker) as shared, \
            medium_scheduler(NUMPY) as plain:
        for sched in (shared, plain):
            for dims in [(8, 4, 4), (2, 2, 2), (16, 1, 1)]:
                sched.submit(dims)
        assert (shared.status()["state_digest"]
                == plain.status()["state_digest"])
    assert broker.stats.requests > 0  # daemon queries really brokered
    assert broker.stats.engine_failovers == 0


# ------------------------------------------------- chaos ops
def test_preempt_roundtrip_requeues_at_head():
    with medium_scheduler() as s:
        a = s.submit((4, 4, 4))
        b = s.submit((2, 2, 2))
        assert a["outcome"] == b["outcome"] == PLACED
        r = s.preempt(a["job_id"])
        assert r["outcome"] == PREEMPTED
        st = s.status()
        assert st["queue_depth"] == 1 and st["allocated"] == 1
        # deliberately NOT auto-drained: the head would re-place into
        # its own hole. The next scheduling point re-places it.
        d = s.done(b["job_id"])
        assert [x["job_id"] for x in d["started"]] == [a["job_id"]]
        evs = [e["event"] for e in pushed(s, 6)]
        assert EV_PREEMPT in evs


def test_preempt_requires_allocation():
    with medium_scheduler() as s:
        q = s.submit((4, 4, 4))
        s.preempt(q["job_id"])
        with pytest.raises(RuntimeError, match="not allocated"):
            s.preempt(q["job_id"])  # already queued, not allocated
        with pytest.raises(RuntimeError, match="not"):
            s.preempt(12345)


def test_migrate_replaces_when_space_else_preempts():
    with medium_scheduler() as s:
        a = s.submit((4, 4, 4))
        r = s.migrate(a["job_id"])
        assert r["outcome"] == MIGRATED
        assert r["placement"]["shape"] == [4, 4, 4]
        assert s.status()["allocated"] == 1
        evs = [e["event"] for e in pushed(s, 4)]
        assert EV_MIGRATE in evs
        # Migration is work-conserving: even in a full cluster the
        # released hole is available to the re-place, so a migrate
        # never degrades an allocated job into a queued one.
        ids = [s.submit((4, 4, 4))["job_id"] for _ in range(7)]
        assert s.status()["busy_xpus"] == 512
        r2 = s.migrate(ids[-1])
        assert r2["outcome"] == MIGRATED
        assert s.status()["queue_depth"] == 0


def test_fault_replan_failure_preempts_victim():
    """When a fault's victims cannot be re-placed (every other cube
    full), the disposition degrades to PREEMPTED: the victim is queued
    at the head, never dropped."""
    with medium_scheduler() as s:
        for _ in range(8):
            s.submit((4, 4, 4))
        assert s.status()["busy_xpus"] == 512
        r = s.fault("node", [(0, 0, 0, 0)])
        assert r["ok"] and len(r["victims"]) == 1
        assert r["victims"][0]["outcome"] == PREEMPTED
        st = s.status()
        assert st["queue_depth"] == 1 and st["allocated"] == 7
        # repair brings the cube back and drains the queued victim
        rep = s.repair("node", [(0, 0, 0, 0)])
        assert [x["job_id"] for x in rep["started"]] == \
            [r["victims"][0]["job_id"]]
        assert s.status()["allocated"] == 8


def test_fault_evicts_and_replans_victims():
    with medium_scheduler() as s:
        a = s.submit((4, 4, 4))
        b = s.submit((2, 4, 8))
        assert a["outcome"] == b["outcome"] == PLACED
        r = s.fault("node", [(0, 0, 0, 0)])
        assert r["ok"] and r["applied"] == [[0, 0, 0, 0]]
        # exactly the job(s) on cube 0 were evicted, each replanned
        assert r["victims"]
        for v in r["victims"]:
            assert v["outcome"] in (PREEMPTED, MIGRATED)
        # plenty of healthy cubes: eviction must not lose capacity
        st = s.status()
        assert st["allocated"] + st["queue_depth"] == 2
        evs = [e["event"] for e in pushed(s, 5)]
        assert EV_FAULT in evs
        assert EV_MIGRATE in evs or EV_PREEMPT in evs


def test_fault_on_free_nodes_has_no_victims():
    with small_scheduler() as s:
        r = s.fault("node", [(0, 0, 0, 0)])
        assert r["ok"] and r["victims"] == []
        assert r["applied"] == [[0, 0, 0, 0]]
        assert EV_FAULT in [e["event"] for e in pushed(s, 1)]


def test_repair_restores_capacity_and_drains():
    with small_scheduler() as s:
        s.fault("node", [(0, 0, 0, 0)])
        q = s.submit((4, 4, 4))          # whole cube: blocked by fault
        assert q["outcome"] == QUEUED
        r = s.repair("node", [(0, 0, 0, 0)])
        assert r["ok"] and r["applied"] == [[0, 0, 0, 0]]
        assert [x["job_id"] for x in r["started"]] == [q["job_id"]]
        assert EV_REPAIR in [e["event"] for e in pushed(s, 3)]


def test_repair_of_never_failed_is_noop():
    with small_scheduler() as s:
        r = s.repair("node", [(0, 1, 2, 3)])
        assert r["ok"] and r["applied"] == []
        assert s.status()["journal_ops"] == 1  # still journaled


def test_ocs_port_fault_over_wire():
    with medium_scheduler() as s:
        a = s.submit((8, 4, 4))  # 2-cube chained job
        assert a["outcome"] == PLACED
        r = s.fault("ocs_port", [0])
        assert r["ok"] and r["applied"] == [0]
        if r["victims"]:  # chained through cube 0: evicted + replanned
            assert all(v["outcome"] in (PREEMPTED, MIGRATED)
                       for v in r["victims"])
        s.repair("ocs_port", [0])
        assert s.status()["ok"]


@engines
def test_crash_under_fault_replays_chaos_ops(tmp_path, engine):
    """The chaos ops are journaled as intent and replayed: killing the
    daemon mid-scenario (faults + preempt + migrate + repair in the
    journal, no final checkpoint) must restore a byte-identical state
    digest — including failed masks, cut links and shape bookkeeping."""
    cfg = SchedulerConfig(policy="rfold", policy_kw=MEDIUM,
                          engine=ENGINES[engine],
                          checkpoint_dir=str(tmp_path),
                          checkpoint_every=1)
    s = Scheduler(cfg).start()
    for dims in [(4, 4, 4), (2, 4, 8), (4, 4, 8)]:
        s.submit(dims)  # 256 of 512 XPUs: victims can migrate
    assert s.fault("node", [(0, 0, 0, 0), (1, 0, 0, 0)])["applied"]
    s.fault("ocs_port", [5])
    s.preempt(0)
    s.migrate(1)
    s.repair("node", [(0, 0, 0, 0)])
    before = s.status()
    s.kill()  # crash: no final checkpoint

    s2 = Scheduler(cfg).start()
    try:
        after = s2.status()
        assert after["state_digest"] == before["state_digest"]
        assert after["journal_ops"] == before["journal_ops"]
        # the recovered daemon still knows about the standing fault
        q = s2.submit((4, 4, 4), job_id=900)
        assert q["outcome"] in (PLACED, QUEUED)
    finally:
        s2.stop()


# -------------------------------------------- the card by default
def test_default_engine_needs_the_card():
    """With no engine the service places on the card: without one the
    daemon refuses to come up, and the api's default scheduler raises
    on first use. Nothing falls back to the host."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default engine runs")
    assert SchedulerConfig().engine.resolve_name() == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Scheduler().start()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        AllocatorCore(SchedulerConfig(policy="firstfit",
                                      policy_kw=dict(dims=(8, 8, 8))))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.submit((4, 4, 4))
    assert api._default_scheduler is None


def test_api_default_scheduler_lifecycle():
    """submit/events on the process-wide scheduler: the config given to
    the first start holds until stop_scheduler()."""
    api.stop_scheduler()
    try:
        api.start_scheduler(policy="rfold", policy_kw=SMALL, engine=CUDA)
        with pytest.raises(RuntimeError, match="already running"):
            api.start_scheduler(policy="firstfit")
        r = api.submit((2, 2, 2))
        assert r["outcome"] == PLACED
        names = []
        deadline = time.monotonic() + 5.0
        while not names and time.monotonic() < deadline:
            names = [e["event"] for e in api.events(max_wait=0.05)]
        assert names == [EV_SETUP]
        assert api.start_scheduler().status()["busy_xpus"] == 8
    finally:
        api.stop_scheduler()
    assert api._default_scheduler is None
    assert api.FAILOVER_CHAIN == ("cuda", "torch", "numpy")
    assert set(api.__all__) <= set(dir(api))
