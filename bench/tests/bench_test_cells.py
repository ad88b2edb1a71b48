"""Cells cut to a CPU run, for the benchmark's tests.

The runs skip the look for a card and run the ``cuda`` engine on
``device="cpu"`` (the kernels' plain versions): they prove the control
flow and the comparison, not a speed.

The cut is one rule for every cell, read from the cell's own files: the
cluster shrinks to 512 XPUs (``num_xpus`` 512, ``dims`` 8^3, where the
configuration's ``policy_kw`` has them; every other key stays), the
traces to :data:`SMALL_TRACE` laid over the traffic's own ``trace_kw``.
"""
from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from bench import harness  # noqa: E402

# A 512-XPU cluster busy enough that FIFO admission blocks.
SMALL_TRACE = {"cluster_xpus": 512, "size_scale": 32.0, "size_max": 512}
SMALL_CLUSTER = {"num_xpus": 512, "dims": [8, 8, 8]}
SPEC = harness.benchmark_spec()


def small_cell(spec, name: str, seed: int = 123_456_789_012,
               trace: bool = False, num_jobs: int = 60,
               bench: Path = harness.BENCH) -> harness.Cell:
    """A cell of ``spec`` (files under ``bench``) at 512 XPUs and
    ``num_jobs``-job traces."""
    cell = harness.load_cell(spec, name, seed, trace, bench=bench)
    cell.device, cell.require_card, cell.forbid_modules = "cpu", False, False
    kw = cell.config["policy_kw"]
    cut = {k: v for k, v in SMALL_CLUSTER.items() if k in kw}
    cell.config["policy_kw"] = {**kw, **cut}
    trace_kw = {**cell.traffic.get("trace_kw", {}), **SMALL_TRACE}
    cell.traffic = {**cell.traffic, "num_jobs": num_jobs, "load": 2.0,
                    "warm_jobs": 20, "trace_kw": trace_kw}
    return cell
