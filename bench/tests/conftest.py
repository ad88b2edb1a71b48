"""Fixtures shared by the benchmark's tests."""
from __future__ import annotations

import pytest


@pytest.fixture
def restore_program():
    """The sweep driver wraps two functions of the program to keep each
    run's jobs; put them back after the test."""
    from repro_torch.eval import runner
    from repro_torch.sim import simulator
    saved = runner.run_task, simulator.Simulator.run
    yield
    runner.run_task, simulator.Simulator.run = saved
