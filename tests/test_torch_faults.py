"""Port parity for the chaos layer, mirroring ``tests/test_faults.py``:
fault models, injection, generation and the simulator's eviction and
preemption semantics.

Each test does what its namesake in ``tests/test_faults.py`` does, on
``repro_torch`` and on ``repro`` with the same inputs, and holds the
port both to the reference test's assertions and to the reference's
state and results (occupancy, failed cells, cut links, OCS health,
placements, fault timelines, schedules and chaos records). Tests that
place jobs run on the ``numpy`` engine and on the tensor engines on the
CPU (``cuda`` and ``torch`` with ``device="cpu"``), whose masks are
cached per occupancy epoch: a fault or repair that misses an epoch bump
shows only there.
"""
import json

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core.allocator import make_policy as ref_make_policy
from repro.core.geometry import JobShape as RefJobShape
from repro.core.reconfig import ReconfigTorus as RefReconfigTorus
from repro.core.torus import FaultConflictError as RefFaultConflictError
from repro.core.torus import StaticTorus as RefStaticTorus
from repro.sim import faults as ref_faults
from repro.sim.job import Job as RefJob
from repro.sim.simulator import Simulator as RefSimulator
from repro.traces.generator import TraceConfig as RefTraceConfig
from repro.traces.generator import generate_trace as ref_generate_trace
from repro_torch.core.allocator import make_policy
from repro_torch.core.engineconfig import EngineConfig
from repro_torch.core.folding import enumerate_folds
from repro_torch.core.geometry import JobShape
from repro_torch.core.reconfig import ReconfigTorus
from repro_torch.core.torus import FAILED, FaultConflictError, StaticTorus
from repro_torch.sim.faults import (ChaosObserver, FaultConfig, FaultEvent,
                                    FaultGenerator, FaultInjector)
from repro_torch.sim.job import Job
from repro_torch.sim.simulator import Simulator
from repro_torch.traces.generator import TraceConfig, generate_trace

torch.set_num_threads(1)

SMALL = dict(num_xpus=64, cube_n=4)
MEDIUM = dict(num_xpus=512, cube_n=4)
TRACE_512 = dict(cluster_xpus=512, size_max=512)

ENGINES = {
    "numpy": EngineConfig("numpy"),
    "cuda-on-cpu": EngineConfig("cuda", device="cpu"),
    "torch-on-cpu": EngineConfig("torch", device="cpu"),
}
engines = pytest.mark.parametrize("engine", sorted(ENGINES))


def policies(name, engine, **kw):
    """The same policy in both packages: the port's on ``engine``, the
    reference's on ``numpy``."""
    return (make_policy(name, engine=ENGINES[engine], **kw),
            ref_make_policy(name, engine="numpy", **kw))


def model(pol):
    return getattr(pol, "cluster", None) or pol.torus


def same_state(got, want):
    """The two models hold the same occupancy and fault state."""
    assert got.occ.tobytes() == want.occ.tobytes()
    assert got.failed.tobytes() == want.failed.tobytes()
    assert (got.num_failed, got.busy_xpus, got.free_xpus) == \
        (want.num_failed, want.busy_xpus, want.free_xpus)
    if isinstance(got, StaticTorus):
        assert got.owner.tobytes() == want.owner.tobytes()
        assert got.cut_links == want.cut_links
    else:
        assert got.ocs_ok.tobytes() == want.ocs_ok.tobytes()
    got.check_invariants()
    want.check_invariants()


def placed(p):
    return None if p is None else repr(
        (p.job_id, tuple(p.shape.dims), p.broken_rings,
         sorted(p.meta.items())))


def try_place(pols, jid, dims):
    """Place on both; the placements must be equal. Returns the port's."""
    got = pols[0].try_place(jid, JobShape(dims))
    want = pols[1].try_place(jid, RefJobShape(dims))
    assert placed(got) == placed(want)
    return got


# ---------------------------------------------------- static torus model
def test_static_fail_marks_occupied_and_unplaceable():
    t, r = StaticTorus((4, 4, 4)), RefStaticTorus((4, 4, 4))
    applied = t.fail_nodes([(0, 0, 0), (1, 1, 1)])
    assert applied == r.fail_nodes([(0, 0, 0), (1, 1, 1)])
    assert applied == [(0, 0, 0), (1, 1, 1)]
    assert t.occ[0, 0, 0] and t.owner[0, 0, 0] == FAILED
    assert t.num_failed == 2
    assert t.busy_xpus == 0 and t.free_xpus == 64 - 2
    same_state(t, r)
    assert t.repair_nodes([(0, 0, 0), (1, 1, 1)]) == \
        r.repair_nodes([(0, 0, 0), (1, 1, 1)]) == [(0, 0, 0), (1, 1, 1)]
    assert t.num_failed == 0 and t.free_xpus == 64
    same_state(t, r)


@engines
def test_static_fail_owned_node_refused(engine):
    pols = policies("firstfit", engine, dims=(4, 4, 4))
    assert try_place(pols, 0, (4, 4, 4)) is not None
    for pol, error in zip(pols, (FaultConflictError, RefFaultConflictError)):
        with pytest.raises(error):
            pol.torus.fail_nodes([(0, 0, 0)])
        pol.torus.check_invariants()
        pol.release(0)
        assert pol.torus.fail_nodes([(0, 0, 0)]) == [(0, 0, 0)]
    same_state(pols[0].torus, pols[1].torus)
    # The failed node is routed around on the next query.
    try_place(pols, 1, (4, 4, 2))
    try_place(pols, 2, (4, 4, 4))


def test_static_repair_of_never_failed_node_is_noop():
    t, r = StaticTorus((4, 4, 4)), RefStaticTorus((4, 4, 4))
    assert t.repair_nodes([(2, 2, 2)]) == r.repair_nodes([(2, 2, 2)]) == []
    assert t.num_failed == 0
    same_state(t, r)


def test_static_fail_is_idempotent():
    t, r = StaticTorus((4, 4, 4)), RefStaticTorus((4, 4, 4))
    for m in (t, r):
        m.fail_nodes([(0, 0, 0)])
    assert t.fail_nodes([(0, 0, 0)]) == r.fail_nodes([(0, 0, 0)]) == []
    assert t.num_failed == 1
    same_state(t, r)


def test_cut_link_blocks_commit_and_repair_restores():
    coords = [(0, 0, z) for z in range(4)]
    links = [((0, 0, z), (0, 0, (z + 1) % 4)) for z in range(4)]
    t, r = StaticTorus((4, 4, 4)), RefStaticTorus((4, 4, 4))
    for m in (t, r):
        assert m.cut_link((0, 0, 0), (0, 0, 1))
        assert not m.cut_link((0, 0, 0), (0, 0, 1))   # already cut
        with pytest.raises(ValueError, match="cut"):
            m.commit(1, coords, links)
        assert m.repair_link((0, 0, 0), (0, 0, 1))
        m.commit(1, coords, links)                    # after the repair
    same_state(t, r)
    with pytest.raises(ValueError, match="not a torus link"):
        t.cut_link((0, 0, 0), (0, 2, 0))


@engines
def test_cut_link_under_job_refused(engine):
    pols = policies("firstfit", engine, dims=(4, 4, 4))
    try_place(pols, 0, (4, 4, 4))
    u, v = next(iter(sorted(pols[0].torus.allocations[0].links)))
    assert sorted(pols[0].torus.allocations[0].links) == \
        sorted(pols[1].torus.allocations[0].links)
    assert pols[0].torus.link_jobs([(u, v)]) == [0]
    with pytest.raises(FaultConflictError):
        pols[0].torus.cut_link(u, v)
    same_state(pols[0].torus, pols[1].torus)


@engines
def test_cut_link_routes_fold_around_as_broken_axis(engine):
    """A fold whose ring would traverse a cut link still places, but
    with that axis counted broken, as in the reference."""
    pols = policies("folding", engine, dims=(4, 4, 4))
    assert try_place(pols, 0, (4, 4, 4)).broken_rings == ()
    for pol in pols:
        pol.release(0)
        pol.torus.cut_link((0, 0, 0), (0, 0, 1))
    degraded = try_place(pols, 1, (4, 4, 4))
    assert degraded is not None and 2 in degraded.broken_rings
    assert pols[0].torus.link_failed(((0, 0, 0), (0, 0, 1)))
    same_state(pols[0].torus, pols[1].torus)


STATIC_OPS = [
    ("fail_nodes", ([(0, 0, 3), (1, 2, 3)],)),
    ("fail_nodes", ([(0, 0, 3)],)),                 # already failed
    ("cut_link", ((3, 3, 3), (3, 3, 0))),
    ("cut_link", ((3, 3, 3), (3, 3, 0))),           # already cut
    ("repair_link", ((3, 3, 0), (3, 3, 3))),
    ("repair_link", ((3, 3, 0), (3, 3, 3))),        # never cut now
    ("repair_nodes", ([(0, 0, 3), (2, 2, 2)],)),
]
RECONFIG_OPS = [
    ("fail_cells", ([(1, 0, 0, 0), (2, 3, 3, 3)],)),
    ("fail_cells", ([(1, 0, 0, 0)],)),              # already failed
    ("fail_ocs_port", ([3, 4],)),
    ("fail_ocs_port", ([3],)),                      # already failed
    ("repair_ocs_port", ([3, 5],)),
    ("repair_cells", ([(1, 0, 0, 0), (0, 0, 0, 0)],)),
]


@pytest.mark.parametrize("policy,kw,ops", [
    ("firstfit", dict(dims=(4, 4, 4)), STATIC_OPS),
    ("rfold", MEDIUM, RECONFIG_OPS)], ids=["static", "reconfig"])
def test_every_fault_and_repair_starts_a_new_epoch(policy, kw, ops):
    """Masks are cached per occupancy epoch (host integral image, device
    mask caches, candidate orders): every transition a fault or repair
    applies starts a new epoch, and a no-op starts none, as in the
    reference."""
    pols = policies(policy, "cuda-on-cpu", **kw)
    try_place(pols, 0, (2, 2, 2))
    for name, args in ops:
        results = [getattr(model(pol), name)(*args) for pol in pols]
        assert results[0] == results[1], name
        assert model(pols[0])._epoch == model(pols[1])._epoch, name
        same_state(model(pols[0]), model(pols[1]))
        try_place(pols, 1, (2, 4, 4))
        for pol in pols:
            if 1 in model(pol).allocations:
                pol.release(1)


@engines
def test_masks_cached_before_a_fault_are_not_reused(engine):
    """A query answered before a fault on free nodes (no victim, so no
    release starts a new epoch) must not answer after it."""
    pols = policies("firstfit", engine, dims=(4, 4, 4))
    try_place(pols, 0, (4, 4, 2))
    assert try_place(pols, 1, (4, 4, 4)) is None      # masks now cached
    # The one free half cannot take job 2 once a node of it fails.
    cell = tuple(int(v) for v in np.argwhere(~pols[0].torus.occ)[-1])
    for pol in pols:
        assert pol.torus.fail_nodes([cell]) == [cell]
    assert try_place(pols, 2, (4, 4, 2)) is None
    for pol in pols:
        assert pol.torus.repair_nodes([cell]) == [cell]
    assert try_place(pols, 3, (4, 4, 2)) is not None
    same_state(pols[0].torus, pols[1].torus)


# -------------------------------------------------- reconfig torus model
@engines
def test_reconfig_fail_cells_and_repair(engine):
    pols = policies("rfold", engine, **SMALL)
    m, r = pols[0].cluster, pols[1].cluster
    applied = m.fail_cells([(0, 0, 0, 0), (0, 1, 1, 1)])
    assert applied == r.fail_cells([(0, 0, 0, 0), (0, 1, 1, 1)])
    assert applied == [(0, 0, 0, 0), (0, 1, 1, 1)]
    assert m.busy_xpus == 0 and m.free_xpus == 64 - 2
    same_state(m, r)
    assert try_place(pols, 0, (4, 4, 4)) is None
    assert try_place(pols, 1, (2, 2, 2)) is not None
    for pol in pols:
        pol.release(1)
    assert m.repair_cells(applied) == r.repair_cells(applied) == applied
    assert try_place(pols, 2, (4, 4, 4)) is not None
    same_state(m, r)


@engines
def test_reconfig_fail_owned_cell_refused(engine):
    pols = policies("rfold", engine, **SMALL)
    try_place(pols, 0, (4, 4, 4))
    assert pols[0].cluster.jobs_on([(0, 0, 0, 0)]) == \
        pols[1].cluster.jobs_on([(0, 0, 0, 0)]) == [0]
    with pytest.raises(FaultConflictError):
        pols[0].cluster.fail_cells([(0, 0, 0, 0)])
    same_state(pols[0].cluster, pols[1].cluster)


def test_reconfig_repair_never_failed_noop():
    m, r = ReconfigTorus(**SMALL), RefReconfigTorus(**SMALL)
    assert m.repair_cells([(0, 3, 3, 3)]) == \
        r.repair_cells([(0, 3, 3, 3)]) == []
    same_state(m, r)


def _cubes_of(m, job_id):
    return sorted({piece.cube_id for piece in m.allocations[job_id]})


@engines
def test_ocs_port_fault_excludes_cube_from_chains(engine):
    """With a dead OCS port the cube still hosts OCS-free local jobs but
    never joins a multi-cube chain or closes a wrap ring."""
    pols = policies("rfold", engine, **MEDIUM)
    m = pols[0].cluster
    assert m.fail_ocs_port([0]) == pols[1].cluster.fail_ocs_port([0]) == [0]
    p = try_place(pols, 0, (8, 4, 4))
    assert p is not None and p.meta["num_cubes"] >= 2
    assert 0 not in _cubes_of(m, 0)
    for jid in range(1, 6):
        q = try_place(pols, jid, (4, 4, 4))
        assert q is not None and 0 not in _cubes_of(m, jid)
    assert try_place(pols, 8, (4, 4, 4)) is None
    q = try_place(pols, 9, (2, 2, 2))
    assert q is not None and _cubes_of(m, 9) == [0]
    assert q.meta["ocs_links"] == 0
    same_state(m, pols[1].cluster)
    # Repairing the port lets the cube close a wrap ring again.
    for pol in pols:
        pol.release(9)
        assert pol.cluster.repair_ocs_port([0]) == [0]
    assert try_place(pols, 10, (4, 4, 4)) is not None
    assert _cubes_of(m, 10) == [0]


@engines
def test_ocs_port_fault_with_chained_job_refused(engine):
    pols = policies("rfold", engine, **MEDIUM)
    p = try_place(pols, 0, (8, 4, 4))
    assert p is not None and p.meta["ocs_links"] > 0
    cube = _cubes_of(pols[0].cluster, 0)[0]
    with pytest.raises(FaultConflictError):
        pols[0].cluster.fail_ocs_port([cube])
    assert pols[0].cluster.jobs_using_ocs([cube]) == \
        pols[1].cluster.jobs_using_ocs([cube]) == [0]
    same_state(pols[0].cluster, pols[1].cluster)


def test_ocs_repair_never_failed_noop():
    m, r = ReconfigTorus(**MEDIUM), RefReconfigTorus(**MEDIUM)
    assert m.repair_ocs_port([3]) == r.repair_ocs_port([3]) == []
    same_state(m, r)


@engines
def test_ocs_degraded_batched_matches_naive(engine):
    """Plan search under OCS degradation: the batched search, the naive
    oracle and the reference pick identical plans."""
    from repro.core.folding import enumerate_folds as ref_enumerate_folds
    rt = ReconfigTorus(512, 4, engine=ENGINES[engine])
    ref = RefReconfigTorus(512, 4, engine="numpy")
    for m in (rt, ref):
        m.fail_ocs_port([0, 3])
        m.fail_cells([(1, 0, 0, 0), (1, 1, 0, 0)])
    jid = 0
    for dims in [(8, 4, 4), (4, 4, 4), (2, 2, 4), (8, 8, 4), (4, 4, 8),
                 (2, 4, 2), (16, 4, 4)]:
        folds = enumerate_folds(JobShape(dims), max_dim=rt.max_extent)
        ref_folds = ref_enumerate_folds(RefJobShape(dims),
                                        max_dim=ref.max_extent)
        assert [str(f) for f in folds] == [str(f) for f in ref_folds]
        for f, rf in zip(folds, ref_folds):
            plan = rt.place_fold(f)
            assert plan == rt.place_fold_naive(f), (dims, f)
            want = ref.place_fold(rf)
            assert repr(plan) == repr(want)
            if plan is not None:
                rt.commit(jid, plan)
                ref.commit(jid, want)
                jid += 1
                break
    same_state(rt, ref)


# ------------------------------------------------------- FaultEvent wire
def test_fault_event_wire_roundtrip():
    for ev in [
        FaultEvent(1.5, "fault", "node", ((0, 1, 2), (3, 0, 1))),
        FaultEvent(2.0, "repair", "node", ((2, 1, 2, 3),)),
        FaultEvent(0.25, "fault", "link", (((0, 0, 0), (0, 0, 1)),)),
        FaultEvent(9.0, "fault", "ocs_port", (5,)),
    ]:
        wire = json.loads(json.dumps(ev.to_wire()))
        back = FaultEvent.from_wire(wire)
        assert back == ev
        # The two packages speak one wire format.
        assert json.dumps(ev.to_wire()) == json.dumps(
            ref_faults.FaultEvent.from_wire(wire).to_wire())


# ----------------------------------------------------- FaultGenerator
def events(timeline):
    return [(e.time, e.action, e.kind, e.targets) for e in timeline]


@settings(max_examples=20, deadline=None)
@given(st.integers(0, 10_000), st.integers(1, 5), st.integers(0, 3),
       st.integers(1, 8))
def test_generator_reproducible_and_well_formed(seed, node_faults,
                                                fabric_faults, blast):
    cfg = FaultConfig(seed=seed, num_node_faults=node_faults,
                      num_fabric_faults=fabric_faults,
                      nodes_per_fault=blast)
    m = ReconfigTorus(**SMALL)
    a = FaultGenerator(cfg).generate(m, horizon=100.0)
    b = FaultGenerator(cfg).generate(m, horizon=100.0)
    assert a == b
    want = ref_faults.FaultGenerator(ref_faults.FaultConfig(
        seed=seed, num_node_faults=node_faults,
        num_fabric_faults=fabric_faults, nodes_per_fault=blast)).generate(
            RefReconfigTorus(**SMALL), horizon=100.0)
    assert events(a) == events(want)   # the same seed fails the same cells
    assert len([e for e in a if e.action == "fault"]) == cfg.total_events
    assert all(a[i].time <= a[i + 1].time for i in range(len(a) - 1))
    for ev in a:
        assert ev.kind in ("node", "link", "ocs_port")
        if ev.kind == "node":
            assert len(ev.targets) == min(blast, 64)
            assert all(len(t) == 4 for t in ev.targets)
    faults = [e for e in a if e.action == "fault"]
    repairs = [e for e in a if e.action == "repair"]
    assert sorted((f.targets for f in faults), key=repr) == \
        sorted((r.targets for r in repairs), key=repr)


def test_generator_static_vs_reconfig_target_concretization():
    kw = dict(seed=7, num_node_faults=2, nodes_per_fault=3,
              num_fabric_faults=2)
    gen = FaultGenerator(FaultConfig(**kw))
    ref_gen = ref_faults.FaultGenerator(ref_faults.FaultConfig(**kw))
    static = gen.generate(StaticTorus((8, 8, 8)), horizon=50.0)
    reconf = gen.generate(ReconfigTorus(**MEDIUM), horizon=50.0)
    # same flat draws, concretized per model: 3-coords vs 4-cells
    assert all(len(t) == 3 for e in static if e.kind == "node"
               for t in e.targets)
    assert all(len(t) == 4 for e in reconf if e.kind == "node"
               for t in e.targets)
    assert [e.time for e in static] == [e.time for e in reconf]
    assert {e.kind for e in static} == {"node", "link"}
    assert {e.kind for e in reconf} == {"node", "ocs_port"}
    assert events(static) == events(ref_gen.generate(
        RefStaticTorus((8, 8, 8)), horizon=50.0))
    assert events(reconf) == events(ref_gen.generate(
        RefReconfigTorus(**MEDIUM), horizon=50.0))


# ------------------------------------------------- simulator + injector
def _chaos_sims(engine, policy="rfold", policy_kw=MEDIUM, num_jobs=50,
                seed=0, fault_kw=None, observers=False, **sim_kw):
    """The same chaos run in both packages: (port sim, reference sim,
    port faults)."""
    fault_kw = fault_kw or dict(seed=seed, num_node_faults=4,
                                nodes_per_fault=8)
    got_pol, ref_pol = policies(policy, engine, **policy_kw)
    jobs = generate_trace(TraceConfig(num_jobs=num_jobs, seed=seed,
                                      **TRACE_512))
    ref_jobs = ref_generate_trace(RefTraceConfig(num_jobs=num_jobs,
                                                 seed=seed, **TRACE_512))
    horizon = max(j.arrival for j in jobs)
    faults = FaultGenerator(FaultConfig(**fault_kw)).generate(
        model(got_pol), horizon)
    ref_fault_list = ref_faults.FaultGenerator(ref_faults.FaultConfig(
        **fault_kw)).generate(model(ref_pol), horizon)
    assert events(faults) == events(ref_fault_list)
    got = Simulator(got_pol, jobs, faults=faults,
                    observer=ChaosObserver() if observers else None,
                    **sim_kw)
    want = RefSimulator(ref_pol, ref_jobs, faults=ref_fault_list,
                        observer=(ref_faults.ChaosObserver() if observers
                                  else None), **sim_kw)
    return got, want, faults


def schedule(result):
    return json.dumps(
        {"chaos": result.chaos, "util": result.utilization_samples,
         "jobs": [[j.job_id, j.start, j.finish, j.dropped, j.slowdown,
                   j.preemptions, j.migrations, j.remaining,
                   repr(sorted(j.placement_meta.items()))]
                  for j in result.jobs]}, sort_keys=True)


@engines
@pytest.mark.parametrize("fault_kw", [
    None, dict(seed=1, num_node_faults=6, nodes_per_fault=16)],
    ids=["4x8", "6x16"])
def test_fault_on_hosting_node_preempts_or_migrates_never_corrupts(
        engine, fault_kw):
    sim, ref, _ = _chaos_sims(engine, observers=True, fault_kw=fault_kw)
    result = sim.run()
    assert schedule(result) == schedule(ref.run())
    obs = sim.observer
    model(sim.policy).check_invariants()
    assert obs.victims > 0
    assert obs.victims == obs.preempted + obs.migrated
    assert obs.killed == 0
    assert sum(j.preemptions + j.migrations
               for j in result.jobs) >= obs.victims
    for j in result.jobs:
        assert (j.preemptions + j.migrations == 0) or j.scheduled
        if j.finish is not None and j.migrations + j.preemptions == 0:
            assert j.finish == pytest.approx(
                j.start + j.duration * j.slowdown)


@engines
def test_fault_mode_kill_fail_stops_victims(engine):
    """``fault_mode="kill"`` fail-stops every victim: dropped, never
    replanned, with the reference's schedule, flags and chaos record."""
    sim, ref, _ = _chaos_sims(
        engine, observers=True, fault_mode="kill",
        fault_kw=dict(seed=1, num_node_faults=6, nodes_per_fault=16))
    result, want = sim.run(), ref.run()
    assert schedule(result) == schedule(want)
    assert [(j.job_id, j.dropped, j.killed) for j in result.jobs] == \
        [(j.job_id, j.dropped, j.killed) for j in want.jobs]
    obs = sim.observer
    model(sim.policy).check_invariants()
    assert obs.killed > 0
    assert obs.victims == obs.killed
    assert obs.preempted == obs.migrated == 0
    killed = [j for j in result.jobs if j.killed]
    assert len(killed) == obs.killed
    assert all(j.dropped and j.finish is None for j in killed)
    assert len(result.dropped) >= obs.killed


def test_job_fields_bind_positionally_as_the_references():
    """``Job``'s fields are in ``repro``'s order (``killed`` after
    ``migrations``), so a positional call binds alike in both packages."""
    import dataclasses

    names = [f.name for f in dataclasses.fields(Job)]
    assert names == [f.name for f in dataclasses.fields(RefJob)]
    head = (1, 0.0, 1.0)
    port = Job(*head, JobShape((2, 1, 1)), 0, None, None, False, 2.0)
    ref = RefJob(*head, RefJobShape((2, 1, 1)), 0, None, None, False, 2.0)
    assert (port.slowdown, port.killed) == (ref.slowdown, ref.killed) == \
        (2.0, False)
    tail = (0, 1.0, 2.0, True, 1.5, {"k": 1}, 2, 3, True, 0.25)
    port = Job(*head, JobShape((2, 1, 1)), *tail)
    ref = RefJob(*head, RefJobShape((2, 1, 1)), *tail)
    rest = [n for n in names if n != "shape"]
    assert [getattr(port, n) for n in rest] == [getattr(ref, n) for n in rest]
    assert port.shape.dims == ref.shape.dims


@pytest.mark.parametrize("sim_cls", [Simulator, RefSimulator],
                         ids=["port", "reference"])
def test_unknown_fault_mode_raises(sim_cls):
    pol = make_policy("rfold", engine="numpy", **SMALL)
    with pytest.raises(ValueError, match="unknown fault_mode 'bogus'"):
        sim_cls(pol, [], fault_mode="bogus")


@pytest.mark.parametrize("policy,policy_kw", [
    ("firstfit", dict(dims=(8, 8, 8))), ("folding", dict(dims=(8, 8, 8))),
    ("reconfig", MEDIUM), ("rfold_be", MEDIUM)])
@pytest.mark.parametrize("fabric", [False, True], ids=["nodes", "fabric"])
def test_chaos_simulation_deterministic(policy, policy_kw, fabric):
    """Two runs of one chaos simulation give one record, equal to the
    reference's, for every policy under node faults and under fabric
    faults (link cuts on the static tori, OCS ports on the cubes), on
    the ``cuda`` engine on the CPU."""
    fault_kw = dict(seed=2, num_node_faults=3, nodes_per_fault=8,
                    num_fabric_faults=3 if fabric else 0)
    recs = []
    for _ in range(2):
        sim, ref, _ = _chaos_sims("cuda-on-cpu", policy, policy_kw,
                                  fault_kw=fault_kw, observers=True)
        recs.append(schedule(sim.run()))
        assert recs[-1] == schedule(ref.run())
    assert recs[0] == recs[1]


@engines
def test_observer_is_pure_observation(engine):
    """Attaching an observer does not change the schedule."""
    sim_a, _, _ = _chaos_sims(engine, observers=False)
    sim_b, ref_b, _ = _chaos_sims(engine, observers=True)
    ra, rb = sim_a.run(), sim_b.run()
    assert [(j.job_id, j.start, j.finish) for j in ra.jobs] == \
        [(j.job_id, j.start, j.finish) for j in rb.jobs]
    assert ra.chaos is None and rb.chaos is not None
    assert schedule(rb) == schedule(ref_b.run())


@engines
def test_no_faults_byte_identical_to_legacy_simulator(engine):
    """With no faults, no observer and no priorities, the chaos plumbing
    leaves the schedule as the fault-free simulator made it, and as the
    reference makes it."""
    def run(pkg_make, pkg_sim, pkg_gen, pkg_cfg, eng, **kw):
        return pkg_sim(pkg_make("rfold", engine=eng, **MEDIUM),
                       pkg_gen(pkg_cfg(num_jobs=60, seed=3, **TRACE_512)),
                       **kw).run()
    legacy = run(make_policy, Simulator, generate_trace, TraceConfig,
                 ENGINES[engine])
    chaosy = run(make_policy, Simulator, generate_trace, TraceConfig,
                 ENGINES[engine], faults=(), observer=None)
    want = run(ref_make_policy, RefSimulator, ref_generate_trace,
               RefTraceConfig, "numpy")
    assert schedule(legacy) == schedule(chaosy) == schedule(want)
    assert legacy.utilization_samples == chaosy.utilization_samples


def test_injector_victims_and_apply_dispatch():
    pol = make_policy("rfold", engine="numpy", **SMALL)
    pol.try_place(0, JobShape((4, 4, 4)))
    inj = FaultInjector(pol)
    ev = FaultEvent(0.0, "fault", "node", ((0, 0, 0, 0),))
    assert inj.victims(ev) == [0]
    pol.release(0)
    assert inj.victims(ev) == []
    assert inj.apply(ev) == [(0, 0, 0, 0)]
    repair = FaultEvent(1.0, "repair", "node", ((0, 0, 0, 0),))
    assert inj.victims(repair) == []
    assert inj.apply(repair) == [(0, 0, 0, 0)]
    pol.cluster.check_invariants()
    # Links on a static torus: victims, cut, repair.
    st_pol = make_policy("firstfit", engine="numpy", dims=(4, 4, 4))
    st_pol.try_place(0, JobShape((4, 4, 4)))
    inj = FaultInjector(st_pol)
    link = next(iter(sorted(st_pol.torus.allocations[0].links)))
    cut = FaultEvent(0.0, "fault", "link", (link,))
    assert inj.victims(cut) == [0]
    st_pol.release(0)
    assert inj.apply(cut) == [link]
    assert inj.apply(FaultEvent(1.0, "repair", "link", (link,))) == [link]
    with pytest.raises(ValueError, match="fault kind"):
        inj.victims(FaultEvent(0.0, "fault", "rack", ()))
    with pytest.raises(TypeError):
        FaultInjector(object())


@engines
def test_observer_finalize_degradation_metrics(engine):
    sim, ref, faults = _chaos_sims(engine, num_jobs=80, observers=True)
    result = sim.run()
    ch = result.chaos
    assert json.dumps(ch, sort_keys=True) == \
        json.dumps(ref.run().chaos, sort_keys=True)
    n_faults = sum(1 for f in faults if f.action == "fault")
    assert ch["faults"] == n_faults and ch["repairs"] == n_faults
    assert 0.0 <= ch["util_overall"] <= 1.0
    assert ch["dip_depth"] >= 0.0
    assert ch["max_queue_depth"] >= ch["requeue_depth_max"] >= 0
    if ch["recovered"]:
        assert ch["time_to_recover"] is not None


# ------------------------------------------------- priority preemption
def _two_jobs(job_cls, shape_cls, prio0, prio1):
    return [job_cls(job_id=0, arrival=0.0, duration=100.0,
                    shape=shape_cls((4, 4, 4)), priority=prio0),
            job_cls(job_id=1, arrival=1.0, duration=10.0,
                    shape=shape_cls((4, 4, 4)), priority=prio1)]


@engines
def test_priority_preemption_evicts_lower_priority(engine):
    got_pol, ref_pol = policies("rfold", engine, **SMALL)
    obs = ChaosObserver()
    result = Simulator(got_pol, _two_jobs(Job, JobShape, 0, 2),
                       observer=obs, priority_preemption=True).run()
    want = RefSimulator(ref_pol, _two_jobs(RefJob, RefJobShape, 0, 2),
                        observer=ref_faults.ChaosObserver(),
                        priority_preemption=True).run()
    assert schedule(result) == schedule(want)
    j0, j1 = result.jobs
    assert j1.start == 1.0
    assert j0.preemptions == 1
    assert j0.finish > j1.finish
    assert j0.finish == pytest.approx(j1.finish + 99.0)
    assert obs.preempted == 1


@engines
def test_priority_preemption_never_evicts_equal_or_higher(engine):
    got_pol, ref_pol = policies("rfold", engine, **SMALL)
    result = Simulator(got_pol, _two_jobs(Job, JobShape, 1, 1),
                       priority_preemption=True).run()
    want = RefSimulator(ref_pol, _two_jobs(RefJob, RefJobShape, 1, 1),
                        priority_preemption=True).run()
    assert schedule(result) == schedule(want)
    j0, j1 = result.jobs
    assert j0.preemptions == 0
    assert j1.start == pytest.approx(j0.finish)
