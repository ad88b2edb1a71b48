"""The benchmark's general machinery: find a cell's files by name, check
the card, run the cell's driver through set-up, window and check, read
the per-layer metrics, and print the result line.

Everything that belongs to one configuration, traffic mix or per-layer
metric lives in a file of its own, found by the name that
``BENCHMARK.json`` gives it:

  ``bench/configs/<config>.json``   a deployment of the scheduler
  ``bench/traffic/<traffic>.json``  a traffic mix; its ``driver`` names
  ``bench/drivers/<driver>.py``     the module that drives it
  ``bench/metrics/<metric>.py``     one per-layer metric's reader

A driver module defines ``prepare(cell)`` (set-up and warm-up; returns
its state), ``measure(state, seconds)`` (the window; returns the
end-to-end values by name) and ``check(state)`` (the comparison with the
reference; returns a :class:`Verdict`). It also fills ``state.layers``,
the context the metric readers read. A metric module defines
``read(ctx)``, returning a number or ``None`` where it finds nothing to
read.
"""
from __future__ import annotations

import importlib.util
import json
import os
import sys
import time
import traceback
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List, Optional, Tuple

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# Top-level module names that must never be loaded in a run: JAX and the
# JAX package. Compared whole: the port's name begins with the JAX
# package's.
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")
# The cores this process could use when the harness was imported, before
# :func:`pin_to_core` narrowed them.
ALLOWED_CORES = tuple(sorted(os.sched_getaffinity(0)))


class CellError(RuntimeError):
    """The cell cannot run as asked (no card, a missing file)."""


@dataclass
class Check:
    """One number compared, with its limit: ``value <= limit`` where
    ``at_most``, else ``value >= limit``."""

    value: float
    limit: float
    at_most: bool = True

    @property
    def ok(self) -> bool:
        return self.value <= self.limit if self.at_most \
            else self.value >= self.limit

    def as_dict(self) -> Dict[str, Any]:
        return {"value": self.value, "limit": self.limit,
                "rule": "at_most" if self.at_most else "at_least"}


@dataclass
class Verdict:
    attempted: int
    failed: int
    checks: Dict[str, Check] = field(default_factory=dict)
    notes: List[str] = field(default_factory=list)

    @property
    def correct(self) -> bool:
        return self.failed == 0 and all(c.ok for c in self.checks.values())


@dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with its files read."""

    name: str
    chips: int
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    seed: int
    trace: bool
    device: Optional[str] = None      # None: the card
    require_card: bool = True
    seconds: float = 0.0
    # False only in tests, whose process other tests share: there JAX
    # may be loaded already.
    forbid_modules: bool = True


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path) -> ModuleType:
    """Import one file of the benchmark by its path (names may hold dots)."""
    if not path.is_file():
        raise CellError(f"no file {path}")
    name = "bench_" + path.stem.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def benchmark_spec(root: Path = ROOT) -> Dict[str, Any]:
    return load_json(root / "BENCHMARK.json")


def find_workload(spec: Dict[str, Any], name: str) -> Dict[str, Any]:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise CellError(f"no workload {name!r} in BENCHMARK.json")


def load_cell(spec: Dict[str, Any], workload: str, seed: int, trace: bool,
              bench: Path = BENCH) -> Cell:
    w = find_workload(spec, workload)
    conf = next((c for c in spec["configs"] if c["name"] == w["config"]),
                None)
    if conf is None:
        raise CellError(f"no configuration {w['config']!r}")
    config = load_json(bench / "configs" / f"{w['config']}.json")
    traffic = load_json(bench / "traffic" / f"{w['traffic']}.json")
    return Cell(name=workload, chips=int(w["chips"]), config=config,
                traffic=traffic, seed=int(seed), trace=bool(trace))


def metrics_for(spec: Dict[str, Any], kind: str, cell: str) -> List[Dict]:
    """The ``end_to_end`` or ``per_layer`` entries this cell reports."""
    return [m for m in spec[kind]
            if "workloads" not in m or cell in m["workloads"]]


def driver_module(cell: Cell, bench: Path = BENCH) -> ModuleType:
    return load_module(bench / "drivers" / f"{cell.traffic['driver']}.py")


def read_layers(spec: Dict[str, Any], cell: str, ctx: Dict[str, Any],
                bench: Path = BENCH) -> Dict[str, Dict[str, Any]]:
    """Each per-layer metric's reader, run on the traced run's context.
    A reader that finds nothing returns ``None`` and the metric is left
    out."""
    out: Dict[str, Dict[str, Any]] = {}
    for m in metrics_for(spec, "per_layer", cell):
        value = load_module(bench / "metrics" / f"{m['name']}.py").read(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


# -- the card -----------------------------------------------------------

def require_card(chips: int) -> None:
    import torch
    if not torch.cuda.is_available():
        raise CellError("no CUDA card: torch.cuda.is_available() is false")
    if torch.cuda.device_count() < chips:
        raise CellError(f"the cell asks for {chips} cards, "
                        f"{torch.cuda.device_count()} present")


def device_info(cell: Cell) -> Dict[str, Any]:
    import torch
    if cell.device is None or cell.device.startswith("cuda"):
        return {"platform": "gpu",
                "kind": torch.cuda.get_device_name(0),
                "count": cell.chips,
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}
    return {"platform": "cpu", "kind": "cpu", "count": cell.chips,
            "memory_peak_bytes": 0}


def forbidden_loaded() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN_MODULES))


# -- one run --------------------------------------------------------------

def run_cell(spec: Dict[str, Any], cell: Cell, seconds: float,
             t_start: float, bench: Path = BENCH) -> Tuple[Dict, Verdict]:
    """Set up, measure, check; returns the result line and the verdict."""
    if cell.require_card:
        require_card(cell.chips)
    driver = driver_module(cell, bench)
    cell.seconds = seconds
    state = driver.prepare(cell)
    if cell.device is None:
        import torch
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_start
    tracer = None
    if cell.trace:
        from bench.trace import Tracer
        tracer = Tracer(on_card=cell.device is None)
        tracer.start()
    try:
        values = driver.measure(state, seconds)
    except Exception:  # noqa: BLE001 - a program that raises is not correct
        values, error = {}, traceback.format_exc()
    else:
        error = None
    if tracer is not None:
        tracer.stop()
    device = device_info(cell)
    loaded = forbidden_loaded() if cell.forbid_modules else []
    if loaded:
        raise CellError("modules of JAX or the JAX package were loaded: "
                        + ", ".join(loaded))
    if tracer is not None and error is None:
        state.layers["profile"] = tracer.summary()
    if error is None:
        verdict = driver.check(state)
    else:
        verdict = Verdict(attempted=1, failed=1, notes=[error])
        verdict.checks["window_errors"] = Check(1, 0)
    result: Dict[str, Any] = {"correct": verdict.correct,
                              "attempted": verdict.attempted,
                              "failed": verdict.failed}
    if cell.trace and error is None:
        result["metrics"] = read_layers(spec, cell.name, state.layers, bench)
        prof = state.layers["profile"]
        device["busy_s"] = prof["busy_s"]
        device["window_s"] = prof["window_s"]
        result["device"] = device
        result["breakdown"] = {"device_ops": prof["device_ops"],
                               "idle_gaps": prof["idle_gaps"]}
    else:
        metrics = {}
        for m in metrics_for(spec, "end_to_end", cell.name):
            if m["name"] == "setup_s":
                metrics["setup_s"] = {"value": setup_s, "unit": "s"}
            elif m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
        result["metrics"] = metrics
        result["device"] = device
    result["checks"] = {k: c.as_dict() for k, c in verdict.checks.items()}
    return result, verdict


def print_result(result: Dict[str, Any], verdict: Verdict) -> None:
    for note in verdict.notes:
        print(f"# {note}", file=sys.stderr)
    print(json.dumps(result))
    sys.stdout.flush()
    for name, c in verdict.checks.items():
        rule = "<=" if c.at_most else ">="
        print(f"check {name} {c.value} {rule} {c.limit} "
              f"{'ok' if c.ok else 'FAILED'}", file=sys.stderr)
    print(f"correct {verdict.correct} attempted {verdict.attempted} "
          f"failed {verdict.failed}", file=sys.stderr)


def quiet_threads() -> None:
    """One process with few threads: the host's numpy and torch work runs
    on one thread, so runs on a shared host stay steady."""
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ.setdefault(var, "1")


def pin_to_core() -> Optional[int]:
    """Keep this process, and every thread and process it starts after
    this call, to one core: the last this process may use. The
    scheduler's host work is one Python thread at a time; on a card's
    machine, whose cores the host shares with others, threads that
    wander between cores read up to half again slower from one run to
    the next, and on one core they do not. The program may widen the set
    for processes it starts."""
    if len(ALLOWED_CORES) < 2:
        return None
    core = ALLOWED_CORES[-1]
    os.sched_setaffinity(0, {core})
    return core
