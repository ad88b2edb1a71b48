"""The comparison that decides ``correct`` has to fail where the served
side is wrong: the control (the reference with FIFO admission broken,
in the program's place) and the faults a cell can have, planted under
a whole run at a CPU size: an answer altered where it is produced, half
of the batch left out, a step that leaves its state unchanged.

Each run skips the look for a card and drives the rest of the harness;
the engine is ``cuda`` on ``device="cpu"`` (the kernels' plain
versions). No cell spans chips, so there is no exchange to leave out.
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from bench import control, harness  # noqa: E402

from bench_test_cells import SPEC  # noqa: E402
from bench_test_cells import small_cell as _small  # noqa: E402

torch.set_num_threads(1)
SWEEPS = [w["name"] for w in SPEC["workloads"]]


def small_cell(name: str, seed: int = 98_765_432_101) -> harness.Cell:
    return _small(SPEC, name, seed)


def run(cell: harness.Cell, seconds: float = 1.0) -> harness.Verdict:
    return harness.run_cell(SPEC, cell, seconds, time.perf_counter())[1]


def run_planted(cell: harness.Cell, plant, monkeypatch) -> harness.Verdict:
    """A run whose fault is planted once set-up is done: the timed path
    is broken, the warm-up is not."""
    load = harness.driver_module

    def driver_module(c, bench=harness.BENCH):
        mod = load(c, bench)
        measure = mod.measure

        def broken(state, seconds):
            plant(monkeypatch)
            return measure(state, seconds)
        mod.measure = broken
        return mod
    monkeypatch.setattr(harness, "driver_module", driver_module)
    return run(cell)


@pytest.mark.parametrize("name", SWEEPS)
@pytest.mark.parametrize("seed", [1, 2])
def test_sweep_control_is_not_correct(name, seed):
    cell = small_cell(name, seed)
    v = control.sweep_control(cell, harness.driver_module(cell))
    assert not v.correct
    assert v.checks["runs_differing"].value > 0


def _drop_first_fit(planes):
    """Turn off the first fitting origin of each plane: an altered answer
    that never offers a busy cell."""
    out = planes.clone()
    flat = out.reshape(out.shape[0] * out.shape[1], -1)
    hit = flat.ne(0)
    first = hit.float().argmax(dim=1)
    rows = torch.nonzero(hit.any(dim=1)).flatten()
    flat[rows, first[rows]] = 0
    return out


def altered_answers(monkeypatch):
    from repro_torch.kernels.fitmask import ops
    eng = ops.CudaEngine
    multibox, bucketed, fitmask = (eng.multibox, eng.multibox_bucketed,
                                   eng.fitmask)
    monkeypatch.setattr(eng, "multibox", lambda self, occ, boxes:
                        _drop_first_fit(multibox(self, occ, boxes)))
    monkeypatch.setattr(eng, "fitmask", lambda self, occ, box:
                        _drop_first_fit(fitmask(self, occ, box)[:, None])[:, 0])

    def bucketed_altered(self, occ, boxes):
        planes, free = bucketed(self, occ, boxes)
        return _drop_first_fit(planes), free
    monkeypatch.setattr(eng, "multibox_bucketed", bucketed_altered)


def unchanged_state(monkeypatch):
    """Releasing a job leaves the occupancy as it was."""
    from repro_torch.core import reconfig, torus
    monkeypatch.setattr(torus.StaticTorus, "release", lambda self, j: None)
    monkeypatch.setattr(reconfig.ReconfigTorus, "release",
                        lambda self, j: None)


@pytest.mark.parametrize("name", SWEEPS)
def test_sweep_answer_altered_is_not_correct(name, restore_program,
                                             monkeypatch):
    v = run_planted(small_cell(name), altered_answers, monkeypatch)
    assert not v.correct
    assert v.checks["jobs_differing"].value > 0


@pytest.mark.parametrize("name", SWEEPS)
def test_sweep_half_batch_left_out_is_not_correct(name, restore_program,
                                                  monkeypatch):
    from repro_torch.eval import EvalRunner
    full = EvalRunner.run

    def half(mp):
        mp.setattr(EvalRunner, "run", lambda self, tasks:
                   full(self, tasks)[:len(tasks) // 2])
    v = run_planted(small_cell(name), half, monkeypatch)
    assert not v.correct
    assert v.failed >= v.attempted // 2


@pytest.mark.parametrize("name", SWEEPS)
def test_sweep_state_unchanged_is_not_correct(name, restore_program,
                                              monkeypatch):
    v = run_planted(small_cell(name), unchanged_state, monkeypatch)
    assert not v.correct


def test_missing_run_outside_the_sample_is_not_correct():
    """A run that never came back fails the cell even where the
    reference replays none of the window's runs."""
    cell = small_cell(SWEEPS[0])
    sweep = harness.driver_module(cell)
    batch = sweep.batch_tasks(cell, 0)
    v = sweep.compare([{"tasks": batch, "records": [], "jobs": {}}],
                      cell.traffic["num_jobs"], 0, cell.seed)
    assert not v.correct
    assert v.checks["runs_missing"].value == len(batch)
    assert v.checks["runs_differing"].value == 0


def test_drop_first_fit_changes_only_fitting_cells():
    planes = torch.zeros((2, 3, 2, 2, 2), dtype=torch.int32)
    planes[0, 1, 1, 0, 1] = 1
    planes[0, 1, 1, 1, 1] = 1
    out = _drop_first_fit(planes)
    assert int(out.sum()) == 1 and int(out[0, 1, 1, 1, 1]) == 1
    assert np.array_equal(planes.numpy() >= out.numpy(),
                          np.ones(planes.shape, dtype=bool))
