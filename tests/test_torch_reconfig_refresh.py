"""The port's per-epoch fit-mask cache (``repro_torch.core.reconfig``)
held to the reference (``repro.core.reconfig``): after partial
refreshes, full rebuilds and the growth of the mask stack, every cached
mask and the free counts equal those of the reference's torus built
from scratch on the same occupancy. Also: a partial refresh through a
``QueryBroker`` parks once, and an RFold sweep gives the reference
``EvalRunner``'s records through a fleet, per task and on the host."""
import json

import numpy as np
import pytest
import torch

from repro.core.reconfig import ReconfigTorus as RefReconfigTorus
from repro.eval import EvalRunner as RefEvalRunner
from repro.eval import make_tasks as ref_make_tasks
from repro_torch.core.engineconfig import EngineConfig
from repro_torch.core.folding import enumerate_folds
from repro_torch.core.geometry import JobShape
from repro_torch.core.reconfig import ReconfigTorus
from repro_torch.eval import EvalRunner, make_tasks
from repro_torch.sim.fleet import QueryBroker

torch.set_num_threads(1)


def _random_fill(rt: ReconfigTorus, rng, steps=14):
    """Random occupancy via real commit/release traffic."""
    live = []
    jid = 0
    for _ in range(steps):
        if live and rng.random() < 0.3:
            rt.release(live.pop(int(rng.integers(len(live)))))
            continue
        dims = tuple(int(rng.integers(1, 9)) for _ in range(3))
        for f in enumerate_folds(JobShape(dims), max_dim=rt.max_extent):
            plan = rt.place_fold(f)
            if plan is not None:
                rt.commit(jid, plan)
                live.append(jid)
                jid += 1
                break
    return live


def _torus(kind: str, num_xpus: int, cube_n: int) -> ReconfigTorus:
    """The port on the host ``numpy`` engine, or on a ``QueryBroker``
    over the ``torch`` engine on the CPU."""
    if kind == "host":
        return ReconfigTorus(num_xpus, cube_n, engine="numpy")
    broker = QueryBroker(EngineConfig("torch", device="cpu"))
    return ReconfigTorus(num_xpus, cube_n, mask_client=broker)


def _assert_matches_reference(rt: ReconfigTorus, shape) -> None:
    """The mask of ``shape``, every other cached mask and the free
    counts of ``rt`` equal those of the reference's torus rebuilt from
    scratch on the same occupancy."""
    ref = RefReconfigTorus(rt.num_xpus, rt.cube_n, engine="numpy")
    ref.occ[:] = rt.occ
    ref.dedicated[:] = rt.dedicated
    ref.bump_epoch()
    rt._derived()
    shapes = [shape] + list(rt._shape_masks)
    for s in shapes:
        assert np.array_equal(rt._shape_fit_mask(s),
                              ref._shape_fit_mask(s)), s
    assert np.array_equal(rt._free_cnt, ref._free_cnt)
    assert np.array_equal(rt._cube_empty, ref._cube_empty)


def _assert_stacked(rt: ReconfigTorus) -> None:
    """Every cached mask is a column of the one stack, in stack order."""
    assert list(rt._shape_masks) == rt._stack_shapes
    assert rt._stack.shape[1] >= len(rt._stack_shapes)
    for s in rt._stack_shapes:
        assert rt._shape_masks[s].base is rt._stack


@pytest.mark.parametrize("kind", ["host", "broker"])
@pytest.mark.parametrize("num_xpus,cube_n", [(4096, 2), (4096, 4)])
def test_partial_refresh_matches_reference(num_xpus, cube_n, kind):
    """A commit touching few cubes takes the partial-refresh path; the
    derived state equals the reference's from-scratch rebuild after a
    partial refresh each way, a full rebuild, and the growth of the mask
    stack past its first capacity; on either client every cached mask
    stays a column of the stack."""
    rng = np.random.default_rng(7)
    rt = _torus(kind, num_xpus, cube_n)
    _random_fill(rt, rng, steps=10)
    shape = (2, 2, cube_n)
    rt._shape_fit_mask(shape)          # warm caches at this epoch
    fold = enumerate_folds(JobShape((2, 2, 2)), max_dim=rt.max_extent)[0]
    plan = rt.place_fold(fold)
    assert plan is not None
    rt.commit(12345, plan)             # marks only the touched cubes dirty
    assert rt._dirty                   # partial path is armed
    _assert_matches_reference(rt, shape)

    rt.release(12345)                  # partial again, the other way
    _assert_matches_reference(rt, shape)

    rt.bump_epoch()                    # full rebuild
    _assert_matches_reference(rt, shape)
    _assert_stacked(rt)

    # More shapes than the stack's first capacity (8 columns), each
    # asked at its own epoch, then partial refreshes of all of them (a
    # 2-cube holds 8 shapes in all).
    shapes = [(a, b, c) for a in range(1, cube_n + 1)
              for b in range(1, cube_n + 1) for c in range(1, cube_n + 1)]
    for s in shapes[:12]:
        rt._shape_fit_mask(s)
        rt.commit(777, rt.place_fold(fold))
        rt.release(777)
    assert set(shapes[:12]) <= set(rt._shape_masks)
    assert len(rt._stack_shapes) >= min(12, len(shapes))
    _assert_stacked(rt)
    plan = rt.place_fold(fold)
    rt.commit(12346, plan)
    _assert_matches_reference(rt, shape)
    rt.release(12346)
    _assert_matches_reference(rt, shape)
    rt.bump_epoch()                    # full rebuild keeps every column
    _assert_matches_reference(rt, shape)
    _assert_stacked(rt)
    rt.check_invariants()


def test_broker_partial_refresh_parks_once():
    """On a broker over the fused engine pass, a partial refresh asks
    for every stacked mask and then the free counts of the same cubes:
    one flush, and the counts come from the broker's cache."""
    broker = QueryBroker(EngineConfig("torch", device="cpu"))
    rt = ReconfigTorus(512, 4, mask_client=broker)
    _random_fill(rt, np.random.default_rng(3), steps=6)
    rt._shape_fit_mask((2, 2, 4))
    rt._shape_fit_mask((1, 3, 2))
    fold = enumerate_folds(JobShape((2, 2, 2)), max_dim=rt.max_extent)[0]
    rt.commit(99, rt.place_fold(fold))
    assert rt._dirty
    st = broker.stats
    before = (st.flushes, st.fc_cache_hits, st.fc_cache_misses)
    rt._derived()
    assert (st.flushes, st.fc_cache_hits, st.fc_cache_misses) == \
        (before[0] + 1, before[1] + 1, before[2])
    # The first refresh of a torus has no stacked shape: its counts are
    # a round of their own (the occupancy-count kernel's launch).
    fresh = ReconfigTorus(512, 4, mask_client=broker)
    fresh.occ[0, 0, 0, 0] = True
    fresh.bump_epoch()
    before = (st.flushes, st.fc_cache_misses)
    fresh._derived()
    assert (st.flushes, st.fc_cache_misses) == (before[0] + 1, before[1] + 1)


def _strip_timing(records):
    """Records without ``sim_s``, as canonical JSON (NaN equals NaN)."""
    return json.dumps([{k: v for k, v in r.items() if k != "sim_s"}
                       for r in records], sort_keys=True)


def test_rfold_records_equal_the_references():
    """An RFold sweep through a fleet (stacked masks refreshed through
    the broker), per task on an inline client and on the host path
    gives the reference ``EvalRunner``'s records on the same tasks."""
    args = ([("rfold", "rfold", {"num_xpus": 512, "cube_n": 4})],
            2, 60, 2.0, 31)
    kw = {"trace_kw": {"cluster_xpus": 512, "size_scale": 32.0,
                       "size_max": 512}}
    want = _strip_timing(RefEvalRunner(workers=0, fleet_size=0).run(
        ref_make_tasks(*args, **kw)))
    tasks = make_tasks(*args, **kw)
    for cfg in (EngineConfig("cuda", device="cpu", fleet_size=2),
                EngineConfig("cuda", device="cpu", fleet_size=0),
                EngineConfig("numpy", fleet_size=0)):
        got = EvalRunner(checkpoint_dir=None, workers=0,
                         engine=cfg).run(tasks)
        assert _strip_timing(got) == want, cfg
