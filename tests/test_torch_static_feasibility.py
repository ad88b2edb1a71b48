"""Empty-cluster feasibility on a static torus (``_StaticBase``): the
port answers ``can_ever_place`` from the policy's fold list, with no
clone. Held, shape by shape, to the port's own clone probe
(``empty_clone().try_place``) and to the reference's ``can_ever_place``
on the shapes of the trace generator's 1D/2D/3D rule; held to the
empty cluster's answer on a torus with faults and jobs; counted by
``policy.feasibility`` and never by ``policy.clone_probes``; and the
Folding and FirstFit records equal the reference ``run_task``'s."""
import json

import pytest
import torch

from repro.core.allocator import make_policy as ref_make_policy
from repro.eval import make_tasks as ref_make_tasks
from repro.eval import run_task as ref_run_task
from repro_torch import obs
from repro_torch.core.allocator import (FoldingPolicy, PlacementPolicy,
                                        make_policy, shape_key)
from repro_torch.core.engineconfig import EngineConfig
from repro_torch.core.geometry import (JobShape, factor_pairs,
                                       factorizations3, volume)
from repro_torch.eval import make_tasks, run_task
from repro_torch.traces.generator import TraceConfig, _cube_grid_size

torch.set_num_threads(1)

POLICIES = ("firstfit", "folding")
# Every size of a small torus; on 16^3 (whose cold shapes cost
# milliseconds each to fold) the small sizes, then sizes spread to the
# full torus, each with every shape the rule gives it.
SIZES = {(8, 8, 8): range(1, 513),
         (16, 8, 4): range(1, 513),
         (16, 16, 16): [*range(1, 65), 96, 128, 256, 512, 1024, 2048,
                        4096]}


def _rule_shapes(size: int, cube_filter: bool = True):
    """Every shape the trace generator's rule can give a job of ``size``
    (``traces.generator.sample_shape``): the 1D shape, the 2D and 3D
    factorizations with no unit axis, those that decompose into the
    configured cube budget."""
    cfg = TraceConfig()

    def ok(dims):
        return not cube_filter or \
            _cube_grid_size(dims, cfg.cube4_n) <= cfg.cube4_budget

    out = [(size, 1, 1)] if ok((size, 1, 1)) else []
    out += [(a, b, 1) for a, b in factor_pairs(size)
            if min(a, b) > 1 and ok((a, b, 1))]
    out += [t for t in factorizations3(size) if min(t) > 1 and ok(t)]
    return out


def _shapes(dims):
    """The rule's shapes for this torus's sizes, and a few sizes above
    its volume (no cube budget there: the rule would give none on
    16^3), each once up to rotation."""
    n = volume(dims)
    shapes = [s for size in SIZES[dims] for s in _rule_shapes(size)]
    for size in (n + 1, n + 2, 2 * n):
        shapes += _rule_shapes(size, cube_filter=False)
    keys = {}
    for s in shapes:
        keys.setdefault(tuple(sorted(s, reverse=True)), JobShape(s))
    return list(keys.values())


def _counters(fn):
    before = obs.totals()
    out = fn()
    return out, obs.diff(before, obs.totals())["counters"]


@pytest.mark.parametrize("dims", sorted(SIZES))
@pytest.mark.parametrize("name", POLICIES)
def test_feasibility_equals_the_clone_and_the_reference(name, dims):
    """Shape by shape: the analytic answer equals the port's own clone
    probe and the reference policy's ``can_ever_place``; the shapes
    include placeable and unplaceable ones."""
    shapes = _shapes(dims)
    policy = make_policy(name, dims=dims, engine="numpy")
    ref = ref_make_policy(name, dims=dims, engine="numpy")
    got, counters = _counters(
        lambda: [policy.can_ever_place(s) for s in shapes])
    clone = [policy.empty_clone().try_place(-1, s) is not None
             for s in shapes]
    want = [ref.can_ever_place(s) for s in shapes]
    bad = [s.dims for s, g, c, w in zip(shapes, got, clone, want)
           if not g == c == w]
    assert not bad, bad[:10]
    assert 0 < sum(got) < len(got)
    assert counters.get("policy.feasibility") == len(shapes)
    assert "policy.clone_probes" not in counters


def test_feasibility_on_the_cuda_engine_equals_the_clone():
    """The same answer where the clone's search runs on the ``cuda``
    engine's plain versions (one inline launch a clone)."""
    dims = (8, 8, 8)
    shapes = _shapes(dims)[::7]
    for name in POLICIES:
        policy = make_policy(name, dims=dims,
                             engine=EngineConfig("cuda", device="cpu"))
        got = [policy.can_ever_place(s) for s in shapes]
        clone = [policy.empty_clone().try_place(-1, s) is not None
                 for s in shapes]
        assert got == clone, name


@pytest.mark.parametrize("name", POLICIES)
def test_faults_and_jobs_do_not_change_feasibility(name):
    """A torus with failed nodes, cut links and a running job answers as
    an empty one does: feasibility is a property of the cluster's shape,
    as it was when a fresh clone answered it."""
    dims = (8, 8, 8)
    shapes = _shapes(dims)
    empty = make_policy(name, dims=dims, engine="numpy")
    want = [empty.can_ever_place(s) for s in shapes]
    hurt = make_policy(name, dims=dims, engine="numpy")
    assert hurt.try_place(1, JobShape((4, 4, 4))) is not None
    hurt.torus.fail_nodes([(7, 7, 7), (0, 7, 3), (6, 0, 0)])
    for u, v in [((5, 5, 5), (5, 5, 6)), ((0, 0, 7), (0, 0, 0)),
                 ((7, 1, 2), (0, 1, 2))]:
        assert hurt.torus.cut_link(u, v)
    assert [hurt.can_ever_place(s) for s in shapes] == want
    # Not placeable now, but on the empty cluster it is.
    whole = JobShape(dims)
    assert hurt.try_place(2, whole) is None
    assert hurt.can_ever_place(whole) is True


def test_cache_hits_are_not_counted():
    """``policy.feasibility`` counts the per-policy cache's misses: a
    rotation of a shape already asked is a hit."""
    policy = make_policy("folding", dims=(8, 8, 8), engine="numpy")
    asks = [(4, 2, 1), (1, 2, 4), (2, 4, 1), (3, 3, 3), (3, 3, 3),
            (600, 1, 1)]
    _, counters = _counters(
        lambda: [policy.can_ever_place(JobShape(s)) for s in asks])
    assert counters.get("policy.feasibility") == \
        len({shape_key(JobShape(s)) for s in asks}) == 3
    assert "policy.clone_probes" not in counters


def test_the_base_clone_path_still_counts_its_clones():
    """A policy with no analytic answer of its own still probes a clone,
    and ``policy.clone_probes`` counts each; the cube policies' naive
    escape hatch builds clones too."""

    class Probed(FoldingPolicy):
        _can_ever_place = PlacementPolicy._can_ever_place

        def empty_clone(self):
            return Probed(self.torus.dims, engine="numpy")

    policy = Probed((8, 8, 8), engine="numpy")
    got, counters = _counters(lambda: [
        policy.can_ever_place(JobShape(s))
        for s in [(8, 8, 8), (9, 9, 9), (8, 8, 8)]])
    assert got == [True, False, True]
    assert counters.get("policy.clone_probes") == 2
    assert "policy.feasibility" not in counters

    naive = make_policy("rfold", num_xpus=512, cube_n=4, engine="numpy")
    naive.use_naive = True
    _, counters = _counters(lambda: naive.can_ever_place(JobShape((4, 4, 4))))
    assert counters.get("policy.clone_probes") == 1


def _strip(rec):
    """A record without ``sim_s``, as canonical JSON (NaN equals NaN)."""
    return json.dumps({k: v for k, v in rec.items() if k != "sim_s"},
                      sort_keys=True)


@pytest.mark.parametrize("engine", ["numpy", "cuda_on_cpu"])
def test_static_records_equal_the_references(engine):
    """Folding and FirstFit runs give the reference ``run_task``'s
    records, with a trace that drops shapes the torus can never hold."""
    cfgs = [("Folding (8^3)", "folding", {"dims": [8, 8, 8]}),
            ("FirstFit (8^3)", "firstfit", {"dims": [8, 8, 8]})]
    kw = {"trace_kw": {"cluster_xpus": 512, "size_scale": 64.0,
                       "size_max": 1024}}
    ref_tasks = ref_make_tasks(cfgs, 1, 60, 1.5, 77, **kw)
    tasks = make_tasks(cfgs, 1, 60, 1.5, 77, **kw)
    eng = EngineConfig("cuda", device="cpu") if engine == "cuda_on_cpu" \
        else EngineConfig("numpy")
    dropped = 0
    for ref_task, task in zip(ref_tasks, tasks):
        want = ref_run_task(ref_task)
        got = run_task(task, engine=eng)
        assert _strip(got) == _strip(want), task.label
        dropped += got["summary"]["num_dropped"]
    assert dropped > 0
