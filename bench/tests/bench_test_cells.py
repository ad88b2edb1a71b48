"""Cells cut to a CPU run, for the benchmark's tests.

The runs skip the look for a card and run the ``cuda`` engine on
``device="cpu"`` (the kernels' plain versions): they prove the control
flow and the comparison, not a speed.
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
SPEC = harness.benchmark_spec()
def small_cell(spec, name: str, seed: int = 123_456_789_012,
               trace: bool = False, num_jobs: int = 60) -> harness.Cell:
    """A cell of ``spec`` at 512 XPUs and ``num_jobs``-job traces."""
    cell = harness.load_cell(spec, name, seed, trace)
    cell.device, cell.require_card, cell.forbid_modules = "cpu", False, False
    cell.config["policy_kw"] = ({"num_xpus": 512, "cube_n": 4}
                                if cell.config["policy"] == "rfold"
                                else {"dims": [8, 8, 8]})
    cell.traffic.update(num_jobs=num_jobs, load=2.0, trace_kw=SMALL_TRACE,
                        warm_jobs=20)
    return cell
