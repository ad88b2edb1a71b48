"""The static torus's per-epoch fit-mask cache
(``repro_torch.core.torus.StaticTorus``): on the host ``numpy`` engine,
an inline ``torch`` client on the CPU and a ``QueryBroker`` over
``torch``, every box's first free origin and fit count equal those of
the reference's ``StaticTorus`` on ``numpy`` through seeded commits,
releases and faults; and one ``FoldingPolicy`` step asks its client
once, for exactly the step's missing in-bounds boxes."""
import itertools

import numpy as np
import pytest
import torch

from repro.core.torus import StaticTorus as RefStaticTorus
from repro_torch.core.allocator import FoldingPolicy
from repro_torch.core.engineconfig import EngineConfig
from repro_torch.core.geometry import JobShape
from repro_torch.core.torus import StaticTorus
from repro_torch.kernels.fitmask import ops
from repro_torch.sim.fleet import QueryBroker

torch.set_num_threads(1)

DIMS = (5, 6, 4)
# Every box that fits the grid, and one per axis that overhangs it.
BOXES = [b for b in itertools.product(*(range(1, d + 1) for d in DIMS))] \
    + [(DIMS[0] + 1, 1, 1), (1, DIMS[1] + 1, 1), (1, 1, DIMS[2] + 1)]


def _torus(kind: str) -> StaticTorus:
    if kind == "numpy":
        return StaticTorus(DIMS, engine="numpy")
    if kind == "inline":
        return StaticTorus(DIMS, engine=EngineConfig("torch", device="cpu"))
    broker = QueryBroker(EngineConfig("torch", device="cpu"))
    return StaticTorus(DIMS, mask_client=broker)


def _free_cells(t, rng, k):
    free = np.argwhere(~t.occ)
    pick = rng.choice(len(free), size=min(k, len(free)), replace=False)
    return [tuple(int(v) for v in free[i]) for i in pick]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("kind", ["numpy", "inline", "broker"])
def test_box_answers_match_reference(kind, seed):
    """Through seeded commits, releases, node faults and repairs, every
    box's ``find_free_box`` and ``count_free_boxes`` equal the
    reference's on ``numpy``. Even steps prefetch every box first (one
    pass); odd steps fill the cache one miss at a time."""
    rng = np.random.default_rng(seed)
    t, ref = _torus(kind), RefStaticTorus(DIMS, engine="numpy")
    live, jid = [], 0
    for step in range(16):
        op = rng.random()
        if op < 0.15 and t.num_failed:
            cells = [tuple(int(v) for v in c)
                     for c in np.argwhere(t.failed)[:2]]
            assert t.repair_nodes(cells) == ref.repair_nodes(cells)
        elif op < 0.3:
            cells = _free_cells(t, rng, 3)
            assert t.fail_nodes(cells) == ref.fail_nodes(cells)
        elif op < 0.5 and live:
            j = live.pop(int(rng.integers(len(live))))
            t.release(j)
            ref.release(j)
        else:
            box = tuple(int(rng.integers(1, d + 1)) for d in DIMS)
            origin = ref.find_free_box(box)
            if origin is not None:
                t.commit_box(jid, origin, box)
                ref.commit_box(jid, origin, box)
                live.append(jid)
                jid += 1
        if step % 2 == 0:
            t.prefetch_boxes(BOXES)
        for b in BOXES:
            assert t.find_free_box(b) == ref.find_free_box(b), (step, b)
            assert t.count_free_boxes(b) == ref.count_free_boxes(b), \
                (step, b)
        t.check_invariants()
    assert np.array_equal(t.occ, ref.occ)


class _Recorder:
    """A mask client over the host engine that keeps every call as
    ``(method, B, boxes)``."""

    def __init__(self):
        self.engine = ops.get_engine("numpy")
        self.calls = []

    def multibox(self, occ, boxes):
        self.calls.append(("multibox", len(occ),
                           [tuple(b) for b in boxes]))
        return self.engine.multibox(occ, boxes)

    def free_counts(self, occ):
        self.calls.append(("free_counts", len(occ), None))
        return self.engine.free_counts(occ)


def test_folding_step_asks_once_for_its_missing_boxes():
    """One ``FoldingPolicy.try_place`` step sends exactly one
    ``multibox`` call, with the step's sorted in-bounds fold boxes that
    are not yet cached at this epoch; its ``find_free_box`` calls send
    none, and nor do queries of those boxes after a prefetch."""
    rec = _Recorder()
    pol = FoldingPolicy(DIMS, mask_client=rec)
    t = pol.torus
    assert pol.try_place(1, JobShape((2, 2, 2))) is not None
    shape = JobShape((4, 6, 1))
    folds = pol._folds(shape)
    boxes = sorted({f.box for f in folds
                    if all(b <= d for b, d in zip(f.box, DIMS))})
    assert len(boxes) > 2
    # One box already cached at this epoch is not asked for again.
    rec.calls.clear()
    t.find_free_box(boxes[0])
    assert rec.calls == [("multibox", 1, [boxes[0]])]
    rec.calls.clear()
    assert pol.try_place(2, shape) is not None
    assert rec.calls == [("multibox", 1, boxes[1:])]

    # At a fresh epoch a prefetch asks once; the queries then ask none.
    rec.calls.clear()
    t.prefetch_boxes(boxes + boxes[:1])
    assert rec.calls == [("multibox", 1, boxes)]
    for b in boxes:
        t.find_free_box(b)
        t.count_free_boxes(b)
    t.prefetch_boxes(boxes)
    assert len(rec.calls) == 1
