"""A static torus's fold commit (``_StaticBase._commit_fold``): the port
builds a commit's XPUs and ring links from the fold's mapping as arrays.
Held, fold by fold and origin by origin, to the reference's
``_commit_fold`` (the XPU sequence, the link set, the broken rings and
the meta), with and without cut links; and, over seeded sweeps of both
static policies, every ``StaticTorus.commit`` gets the very arguments
(links in order) that the per-node and per-edge loop gave, kept here as
the oracle."""
import itertools
import json

import numpy as np
import pytest
import torch

from repro.core.allocator import make_policy as ref_make_policy
from repro.core.folding import enumerate_folds as ref_enumerate_folds
from repro.core.folding import fold_links as ref_fold_links
from repro.core.folding import verify_fold as ref_verify_fold
from repro.eval import make_tasks as ref_make_tasks
from repro.eval import run_task as ref_run_task
from repro_torch.core import allocator
from repro_torch.core.allocator import make_policy
from repro_torch.core.folding import fold_links, ring_edge_index, ring_edges
from repro_torch.core.geometry import JobShape, is_torus_neighbor, volume
from repro_torch.core.torus import StaticTorus, canon_link
from repro_torch.eval import make_tasks, run_task

torch.set_num_threads(1)

DIMS = (16, 16, 16)
# 1D, 2D and 3D shapes; 2-rings and size-1 axes; boxes that span a full
# 16 on one, two or three axes, so that their wrap links count.
SHAPES = [(1, 1, 1), (2, 1, 1), (7, 1, 1), (18, 1, 1), (16, 1, 1),
          (64, 1, 1), (2, 2, 1), (4, 6, 1), (2, 8, 1), (16, 4, 1),
          (16, 16, 1), (6, 5, 1), (2, 2, 2), (4, 8, 2), (8, 6, 3),
          (4, 4, 4), (16, 4, 2), (16, 16, 2), (16, 16, 16)]


def _id(shape):
    return "x".join(map(str, shape))


def _folds(name, shape):
    """The policy's folds and the reference's, paired; in-bounds boxes."""
    identity = name == "firstfit"
    got = [f for f in make_policy(name, dims=DIMS, engine="numpy")
           ._folds(JobShape(shape))
           if all(b <= d for b, d in zip(f.box, DIMS))]
    want = [f for f in ref_enumerate_folds(JobShape(shape), max_dim=16)
            if (not identity or f.kind == "identity")
            and all(b <= d for b, d in zip(f.box, DIMS))]
    assert [(f.job_dims, f.box, f.kind, f.mapping) for f in got] == \
        [(f.job_dims, f.box, f.kind, f.mapping) for f in want]
    return list(zip(got, want))


def _origins(box):
    """The near corner, the far faces, and points between."""
    far = tuple(d - b for b, d in zip(box, DIMS))
    mid = tuple(f // 2 for f in far)
    mixed = (far[0], 0, far[2])
    return sorted({(0, 0, 0), far, mid, mixed})


def _broken(fold, origin):
    wrap = tuple(b == d for b, d in zip(fold.box, DIMS))
    ok, broken = ref_verify_fold(fold, wrap)
    return ok, tuple(broken)


def _commit_both(name, fold, ref_fold, origin, cuts=()):
    """Commit one fold at ``origin`` on a fresh port policy and a fresh
    reference policy, with ``cuts`` cut on both; return (Placement,
    Allocation) of each."""
    ok, broken = _broken(ref_fold, origin)
    out = []
    for f, policy in ((fold, make_policy(name, dims=DIMS, engine="numpy")),
                      (ref_fold, ref_make_policy(name, dims=DIMS,
                                                 engine="numpy"))):
        for u, v in cuts:
            assert policy.torus.cut_link(u, v)
        placement = policy._commit_fold(7, f, origin, broken)
        out.append((placement, policy.torus.allocations[7]))
    return ok, out


def _assert_same(got, want):
    (gp, ga), (wp, wa) = got, want
    assert ga.coords == wa.coords
    assert ga.links == wa.links
    assert ga.meta == wa.meta
    assert gp.broken_rings == wp.broken_rings == ga.meta["broken_rings"]
    assert gp.shape.dims == wp.shape.dims and gp.job_id == wp.job_id


@pytest.mark.parametrize("shape", SHAPES, ids=_id)
@pytest.mark.parametrize("name", ["folding", "firstfit"])
def test_commit_equals_the_reference(name, shape):
    """Every fold of the shape, at every origin: the XPUs in order, the
    link set, the broken rings and the meta equal the reference's."""
    pairs = _folds(name, shape)
    if not pairs:  # FirstFit places only the shape's own rotations
        assert name == "firstfit" and max(shape) > max(DIMS)
        return
    committed = 0
    for fold, ref_fold in pairs:
        for origin in _origins(fold.box):
            ok, (got, want) = _commit_both(name, fold, ref_fold, origin)
            if not ok:
                continue
            _assert_same(got, want)
            committed += 1
    assert committed


CUT_SHAPES = [(18, 1, 1), (4, 6, 1), (16, 6, 1), (16, 4, 2), (4, 8, 2)]
# Links of which each job's ring misses at least one.
AWAY = [canon_link((0, 0, 0), (0, 0, 1)), canon_link((8, 8, 8), (8, 9, 8)),
        canon_link((15, 15, 15), (0, 15, 15))]


@pytest.mark.parametrize("shape", CUT_SHAPES, ids=_id)
def test_cut_links_break_the_same_rings(shape):
    """With cut links on the job's ring, the dropped links and the extra
    broken axes equal the reference's; a cut elsewhere changes nothing."""
    rng = np.random.default_rng(sum(shape))
    extra = 0
    for fold, ref_fold in _folds("folding", shape):
        origin = _origins(fold.box)[-1]
        ok, (_, (_, whole)) = _commit_both("folding", fold, ref_fold, origin)
        if not ok:
            continue
        links = sorted(whole.links)
        picks = rng.choice(len(links), size=min(2, len(links)),
                           replace=False)
        elsewhere = next(l for l in AWAY if l not in whole.links)
        cuts = {links[int(i)] for i in picks} | {elsewhere}
        ok, (got, want) = _commit_both("folding", fold, ref_fold, origin,
                                       cuts=cuts)
        _assert_same(got, want)
        assert not got[1].links & set(cuts)
        extra += len(got[0].broken_rings) > len(whole.meta["broken_rings"])
    assert extra


@pytest.mark.parametrize("shape", SHAPES, ids=_id)
def test_ring_edge_index_and_fold_links(shape):
    """The index form of ``ring_edges`` keeps its order, and
    ``fold_links`` gives the reference's list, in order."""
    iu, iv = ring_edge_index(shape)
    flat = [(int(np.ravel_multi_index(u, shape)),
             int(np.ravel_multi_index(v, shape)))
            for u, v, _ax in ring_edges(shape)]
    assert list(zip(iu.tolist(), iv.tolist())) == flat
    for fold, ref_fold in _folds("folding", shape)[:6]:
        origin = _origins(fold.box)[-1]
        assert fold_links(fold, origin, DIMS) == \
            ref_fold_links(ref_fold, origin, DIMS)


def _loop_commit_args(policy, fold, origin):
    """The per-node and per-edge loop the port's ``_commit_fold`` used
    to run: the ``coords`` and ``links`` it gave ``StaticTorus.commit``."""
    torus = policy.torus
    coords = []
    d0, d1, d2 = fold.job_dims
    for i in range(d0):
        for j in range(d1):
            for k in range(d2):
                e = fold.embed((i, j, k))
                coords.append(tuple(o + v for o, v in zip(origin, e)))
    wrap = policy._wrap_for_box(fold.box, origin)
    links = []
    for (u, v, _ax) in ring_edges(fold.job_dims):
        u = tuple(o + e for o, e in zip(origin, fold.embed(u)))
        v = tuple(o + e for o, e in zip(origin, fold.embed(v)))
        if is_torus_neighbor(u, v, torus.dims, torus.wrap_flags()):
            direct = all(abs(a - b) <= 1 for a, b in zip(u, v))
            if direct or any(
                    wrap[ax] and abs(u[ax] - v[ax]) == torus.dims[ax] - 1
                    for ax in range(3)):
                l = canon_link(u, v)
                if l not in torus.cut_links:
                    links.append(l)
    return coords, links


def _strip(rec):
    """A record without ``sim_s``, as canonical JSON (NaN equals NaN)."""
    return json.dumps({k: v for k, v in rec.items() if k != "sim_s"},
                      sort_keys=True)


@pytest.mark.parametrize("name", ["folding", "firstfit"])
def test_sweep_commits_equal_the_loop(name, monkeypatch):
    """A seeded 2 x 200-job sweep on a 16^3 torus: each commit's
    ``coords`` and ``links`` list, in order, equal the old loop's, the
    tuples hold Python ints, and the records equal the reference's."""
    calls, seen = [], []
    commit_fold = allocator._StaticBase._commit_fold
    commit = StaticTorus.commit

    def spy_commit_fold(self, job_id, fold, origin, broken):
        calls.append(_loop_commit_args(self, fold, origin))
        return commit_fold(self, job_id, fold, origin, broken)

    def spy_commit(self, job_id, coords, links, meta=None):
        seen.append((coords, links))
        return commit(self, job_id, coords, links, meta)

    monkeypatch.setattr(allocator._StaticBase, "_commit_fold",
                        spy_commit_fold)
    monkeypatch.setattr(StaticTorus, "commit", spy_commit)
    label = f"{name} (16^3)"
    cfgs = [(label, name, {"dims": list(DIMS)})]
    tasks = make_tasks(cfgs, 2, 200, 1.5, 2**31 + 34)
    ref_tasks = ref_make_tasks(cfgs, 2, 200, 1.5, 2**31 + 34)
    for task, ref_task in zip(tasks, ref_tasks):
        got = run_task(task, engine="numpy")
        assert _strip(got) == _strip(ref_run_task(ref_task))
    assert len(seen) == len(calls) > 50
    big = 0
    for (coords, links), (want_coords, want_links) in zip(seen, calls):
        assert coords == want_coords
        assert links == want_links
        assert all(type(v) is int for c in itertools.islice(coords, 3)
                   for v in c)
        big += len(coords) >= 256
    assert big


def test_commit_reports_the_first_taken_xpu():
    """``StaticTorus.commit`` names the first occupied XPU in ``coords``
    order, checks duplicates before it, and frees every cell on
    release."""
    t = StaticTorus((4, 4, 4), engine="numpy")
    t.commit(1, [(0, 0, 1), (3, 3, 3)], [])
    with pytest.raises(ValueError, match=r"XPU \(3, 3, 3\) already owned by 1"):
        t.commit(2, [(1, 1, 1), (3, 3, 3), (0, 0, 1)], [])
    with pytest.raises(ValueError, match="duplicate XPUs"):
        t.commit(2, [(0, 0, 1), (0, 0, 1)], [])
    assert t.busy_xpus == 2 and not t.occ[1, 1, 1]
    t.commit(2, [(1, 1, 1)], [])
    assert t.owner[1, 1, 1] == 2 and t.owner[0, 0, 1] == 1
    t.release(1)
    assert t.busy_xpus == 1 == int(t.occ.sum())
    assert (t.owner >= 0).sum() == 1 and volume(t.dims) == 64
