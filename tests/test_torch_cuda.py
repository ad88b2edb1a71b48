"""Tests of the port that need a CUDA card: the hand-written kernels
against their plain PyTorch versions on the card, and the placement
loop through the ``cuda`` engine against the host ``numpy`` engine.
Every test is marked ``cuda`` and skips without a card. This file
imports neither JAX nor ``repro``, so it also runs where only the
port's requirements are installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core.allocator import make_policy
from repro_torch.kernels.fitmask import kernel as tk
from repro_torch.sim.simulator import Simulator
from repro_torch.traces.generator import TraceConfig, generate_trace

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _case(seed):
    rng = np.random.default_rng(seed)
    bsz = int(rng.integers(1, 9))
    grid = tuple(int(v) for v in rng.integers(2, 17, size=3))
    boxes = [tuple(int(v) for v in rng.integers(1, 18, size=3))
             for _ in range(int(rng.integers(1, 40)))]
    occ = rng.uniform(size=(bsz,) + grid) < rng.uniform(0.0, 0.5)
    return occ, boxes


@pytest.mark.parametrize("seed", range(6))
def test_kernels_match_plain_on_card(card, seed):
    occ, boxes = _case(seed)
    t = torch.from_numpy(occ).to(card)
    tk.reset_launch_counts()
    assert torch.equal(tk.fitmask_multibox(t, boxes),
                       tk.fitmask_multibox_plain(t, boxes))
    assert torch.equal(tk.fitmask_batched(t, boxes[0]),
                       tk.fitmask_batched_plain(t, boxes[0]))
    assert torch.equal(tk.occupancy_counts(t), tk.occupancy_counts_plain(t))
    torch.cuda.synchronize()
    assert tk.launch_counts() == {"fitmask_multibox": 1,
                                  "fitmask_batched": 1,
                                  "occupancy_counts": 1}


def test_kernel_refuses_grid_beyond_shared_memory(card):
    t = torch.zeros((1, 38, 38, 38), dtype=torch.bool, device=card)
    with pytest.raises(ValueError, match="shared memory"):
        tk.fitmask_multibox(t, [(1, 1, 1)])
    assert tk.fitmask_multibox(t, []).shape == (1, 0, 38, 38, 38)


@pytest.mark.parametrize("policy,kw", [
    ("firstfit", dict(dims=(8, 8, 8))), ("folding", dict(dims=(8, 8, 8))),
    ("reconfig", dict(num_xpus=512, cube_n=4)),
    ("rfold", dict(num_xpus=512, cube_n=2)),
    ("rfold_be", dict(num_xpus=512, cube_n=4))])
def test_cuda_schedules_match_numpy_on_card(card, policy, kw):
    cfg = TraceConfig(num_jobs=30, seed=3, size_scale=48.0, size_max=512,
                      cluster_xpus=512, target_load=1.5, cube4_budget=8)
    want = Simulator(make_policy(policy, engine="numpy", **kw),
                     generate_trace(cfg)).run()
    tk.reset_launch_counts()
    got = Simulator(make_policy(policy, **kw), generate_trace(cfg)).run()
    assert [(j.start, j.finish, j.dropped, j.placement_meta)
            for j in got.jobs] == \
        [(j.start, j.finish, j.dropped, j.placement_meta) for j in want.jobs]
    assert tk.launch_counts()["fitmask_multibox"] > 0
