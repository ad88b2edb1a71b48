"""The port has a counterpart for every public name of ``repro``.

Each module of ``src/repro``, ``benchmarks/`` and ``examples/`` is read
with ``ast`` (nothing of the reference is imported). From it come the
public top-level functions and classes, their public methods, class
attributes and dataclass fields, the parameters of each function, method
and ``__init__``, the UPPER_CASE constants, and the names a package's
``__init__.py`` re-exports. Modules whose own name is private (a leading
underscore) are skipped, as are names defined under ``if __name__ ==
"__main__":``.

Each of them is looked up at run time in the counterpart module of
``repro_torch``, ``benchmarks_torch`` or ``examples_torch`` (``src/repro/
a/b.py`` is ``repro_torch.a.b``, ``benchmarks/x.py`` is
``benchmarks_torch.x``) with ``importlib``, ``hasattr`` and
``inspect.signature``, so re-exports and inherited methods count. A
parameter is present when the port's callable has a parameter of that
name; the port may add parameters of its own.

What the port names otherwise stands in ``RENAMED``; what it leaves out
on purpose stands in ``NOT_PORTED``; each with its reason. A name that is
neither present nor listed fails, and so does a listed entry that no
longer matches a missing name (a stale entry).
"""
from __future__ import annotations

import ast
import dataclasses
import fnmatch
import importlib
import inspect
import os
import re
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for _path in (ROOT, os.path.join(ROOT, "src")):
    if _path not in sys.path:
        sys.path.insert(0, _path)

UPPER = re.compile(r"^[A-Z][A-Z0-9_]*$")
SOURCES = ("src/repro", "benchmarks", "examples")

# Names the port gives otherwise. Keys are ``path:qualname`` or
# ``path:qualname(param)`` (fnmatch patterns over the reference's
# items); values are (the port's name, reason).
RENAMED = {
    "src/repro/models/*.py:*(key)": (
        "generator",
        "a JAX PRNG key becomes a torch.Generator in every initialiser"),
    "src/repro/launch/mesh.py:mesh_from_allocation(devices)": (
        "ranks",
        "a DeviceMesh is built from process ranks, not JAX devices"),
    "src/repro/kernels/ssd_scan/kernel.py:ssd_scan_kernel": (
        "ssd_scan",
        "the kernel's wrapper carries the ops-level name; it launches "
        "csrc/ssd_scan.cu on the card, the plain version on the CPU"),
    "benchmarks/fitmask_bench.py:run_sweep": (
        "singlepass_sweep",
        "the same single-pass sweep (K1 vs K launches of K3, numpy for "
        "scale) timed on the card"),
    "benchmarks/fitmask_bench.py:run_sweep(grids)": (
        "cells",
        "the sweep takes its (grid, B, K) cells as one list"),
    "benchmarks/fitmask_bench.py:run_sweep(batches)": (
        "cells", "as grids"),
    "benchmarks/fitmask_bench.py:run_sweep(ks)": (
        "cells", "as grids"),
}

# Names the port leaves out on purpose: ``path:qualname`` or
# ``path:qualname(param)`` (fnmatch patterns) -> reason.
NOT_PORTED = {
    "src/repro/core/torus.py:StaticTorus.set_mask_client":
        "deprecated in repro itself; the ported mask_client= takes its "
        "place",
    "src/repro/core/reconfig.py:ReconfigTorus.set_mask_client":
        "deprecated in repro itself; the ported mask_client= takes its "
        "place",
    "src/repro/sim/fleet.py:install_mask_client":
        "deprecated in repro itself; the ported mask_client= takes its "
        "place",
    "src/repro/core/torus.py:resolve_fitmask_engine":
        "no caller in repro outside its tests; EngineConfig resolves "
        "engines in the port",
    "src/repro/kernels/fitmask/ops.py:JaxEngine":
        "the JAX engine; the port's counterparts are TorchEngine and "
        "CudaEngine",
    "src/repro/kernels/fitmask/ops.py:PallasEngine":
        "the Pallas engine; the port's counterparts are TorchEngine and "
        "CudaEngine",
    "src/repro/kernels/fitmask/ops.py:BUCKET_CACHE_SIZE":
        "a jit cache size of the JAX engines",
    "src/repro/kernels/fitmask/ops.py:WINDOW_CACHE_SIZE":
        "a jit cache size of the JAX engines",
    "src/repro/kernels/*/kernel.py:*(interpret)":
        "Pallas interpret mode; the port's wrappers run the plain version "
        "for tensors on the CPU",
    "src/repro/kernels/flash_attention/*.py:flash_attention(block_q)":
        "TPU tiling of the Pallas kernel; the CUDA kernel picks its tiles",
    "src/repro/kernels/flash_attention/*.py:flash_attention(block_k)":
        "TPU tiling of the Pallas kernel; the CUDA kernel picks its tiles",
    "src/repro/kernels/*/kernel.py:NEG_INF":
        "a mask constant inside the Pallas kernels",
    "src/repro/kernels/*/ops.py:*(force_ref)":
        "works around repro's choice of backend; the port's choice "
        "follows the tensors' device alone",
    "src/repro/kernels/*/ops.py:*(force_kernel)":
        "works around repro's choice of backend; the port's choice "
        "follows the tensors' device alone",
    "src/repro/sim/fleet.py:QueryBroker(pad_b)":
        "shape padding against XLA recompiles; the port's engines set "
        "pads_shapes=False",
    "src/repro/sim/fleet.py:BrokerStats.k_needed":
        "shape-padding statistics (XLA recompiles)",
    "src/repro/sim/fleet.py:BrokerStats.k_slots":
        "shape-padding statistics (XLA recompiles)",
    "src/repro/sim/fleet.py:BrokerStats.padded_grids":
        "shape-padding statistics (XLA recompiles)",
    "src/repro/sim/fleet.py:BrokerStats.record_call(n_padded)":
        "shape-padding statistics (XLA recompiles)",
    "src/repro/eval/runner.py:EvalRunner(fleet_*)":
        "repro's own legacy aliases of engine=",
    "src/repro/launch/perf.py:ICI_BW":
        "a TPU v5e term; the port's terms are the H100's",
    "benchmarks/roofline.py:HBM_BW":
        "a TPU v5e term; the port's terms are the H100's",
    "benchmarks/roofline.py:ICI_BW":
        "a TPU v5e term; the port's terms are the H100's",
    "benchmarks/roofline.py:PEAK_FLOPS":
        "a TPU v5e term; the port's terms are the H100's",
    "src/repro/models/blocks.py:ZERO":
        "a JAX constant",
    "benchmarks/failover_drill.py:run_failover(seed)":
        "repro's body never reads it",
    "src/repro/launch/dryrun.py:parse_collective_bytes":
        "parses XLA's HLO text; the port has no HLO, and collective_bytes "
        "totals the collectives its CostMode records",
}


# ---------------------------------------------------------- the reference
def _params(fn):
    a = fn.args
    names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    names += [a.vararg.arg] if a.vararg else []
    names += [a.kwarg.arg] if a.kwarg else []
    return [n for n in names if n not in ("self", "cls")]


def _body(nodes):
    """Top-level statements, through ``if``/``try`` blocks but not the
    ``if __name__ == "__main__":`` block."""
    for node in nodes:
        if isinstance(node, ast.If):
            test = node.test
            if isinstance(test, ast.Compare) and \
                    getattr(test.left, "id", "") == "__name__":
                continue
            yield from _body(node.body)
            yield from _body(node.orelse)
        elif isinstance(node, ast.Try):
            yield from _body(node.body)
        else:
            yield node


def _assigned(node):
    targets = node.targets if isinstance(node, ast.Assign) else [node.target]
    for t in targets:
        for e in (t.elts if isinstance(t, ast.Tuple) else [t]):
            if isinstance(e, ast.Name):
                yield e.id


def _public(name):
    return not name.startswith("_")


def reference_items(rel):
    """(qualname, params or None) of every public item of one module;
    a class's ``__init__`` parameters go under the class's name."""
    tree = ast.parse(open(os.path.join(ROOT, rel)).read())
    items = []
    for node in _body(tree.body):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if _public(node.name):
                items.append((node.name, _params(node)))
        elif isinstance(node, ast.ClassDef) and _public(node.name):
            items.append((node.name, None))
            for item in node.body:
                if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    if item.name == "__init__":
                        items.append((node.name, _params(item)))
                    elif _public(item.name):
                        items.append((f"{node.name}.{item.name}",
                                      _params(item)))
                elif isinstance(item, (ast.Assign, ast.AnnAssign)):
                    items += [(f"{node.name}.{n}", None)
                              for n in _assigned(item) if _public(n)]
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            items += [(n, None) for n in _assigned(node) if UPPER.match(n)]
        elif isinstance(node, ast.ImportFrom) and \
                os.path.basename(rel) == "__init__.py" and \
                node.module != "__future__":
            items += [(a.asname or a.name, None) for a in node.names
                      if _public(a.asname or a.name)]
    return items


def reference_modules():
    out = []
    for src in SOURCES:
        for dirpath, dirnames, filenames in os.walk(os.path.join(ROOT, src)):
            dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
            out += [os.path.relpath(os.path.join(dirpath, f), ROOT)
                    for f in sorted(filenames) if f.endswith(".py")
                    and (_public(f) or f == "__init__.py")]
    return out


def port_module_name(rel):
    """``src/repro/a/b.py`` -> ``repro_torch.a.b``; ``benchmarks/x.py``
    -> ``benchmarks_torch.x``; ``examples/x.py`` -> ``examples_torch.x``."""
    if rel.startswith("src/repro/"):
        dotted = "repro_torch." + rel[len("src/repro/"):-3]
    else:
        top, rest = rel.split("/", 1)
        dotted = f"{top}_torch.{rest[:-3]}"
    dotted = dotted.replace("/", ".")
    return dotted[:-len(".__init__")] if dotted.endswith(".__init__") \
        else dotted


# ---------------------------------------------------------- the port
def _signature_names(obj):
    try:
        sig = inspect.signature(obj)
    except (TypeError, ValueError):
        return None
    return {p for p in sig.parameters if p not in ("self", "cls")}


def _has_member(cls, name):
    if hasattr(cls, name):
        return True
    if dataclasses.is_dataclass(cls) and \
            name in {f.name for f in dataclasses.fields(cls)}:
        return True
    return name in getattr(cls, "_fields", ())


MISSING = object()


def _resolve(mod, qualname):
    """The port's object for ``qualname``, or MISSING."""
    head, _, member = qualname.partition(".")
    obj = getattr(mod, head, MISSING)
    if obj is MISSING or not member:
        return obj
    if not _has_member(obj, member):
        return MISSING
    return getattr(obj, member, obj)   # a field without a default: the class


def _renamed(key):
    for pattern, (new, _) in RENAMED.items():
        if fnmatch.fnmatchcase(key, pattern):
            return new
    return None


def _port_qualname(rel, qualname):
    """``qualname`` with its last part renamed as RENAMED says."""
    new = _renamed(f"{rel}:{qualname}")
    return qualname if new is None else \
        ".".join(qualname.split(".")[:-1] + [new])


def missing_names(rel):
    """Keys (``path:qualname`` or ``path:qualname(param)``) of the
    reference's items that the port lacks, with renames applied: the
    port must have the new name where a rename is listed."""
    try:
        mod = importlib.import_module(port_module_name(rel))
    except ImportError:
        return [rel]
    missing = []
    gone = set()                     # classes the port lacks
    for qualname, params in reference_items(rel):
        key = f"{rel}:{qualname}"
        if qualname.split(".")[0] in gone:
            continue
        obj = _resolve(mod, _port_qualname(rel, qualname))
        if obj is MISSING:
            missing.append(key)
            if "." not in qualname:
                gone.add(qualname)
            continue
        if params is None or not callable(obj):
            continue
        have = _signature_names(obj)
        if have is None:
            continue
        for p in params:
            pkey = f"{key}({p})"
            if (_renamed(pkey) or p) not in have:
                missing.append(pkey)
    return missing


def _listed(key):
    return any(fnmatch.fnmatchcase(key, p) for p in NOT_PORTED)


MODULES = reference_modules()


@pytest.fixture(scope="module")
def all_missing():
    return {rel: missing_names(rel) for rel in MODULES}


def test_every_reference_module_is_read():
    assert len(MODULES) > 90
    for src in SOURCES:
        assert any(m.startswith(src + "/") for m in MODULES), src
    assert "src/repro/sim/simulator.py" in MODULES


@pytest.mark.parametrize("rel", MODULES)
def test_public_names_have_a_counterpart(all_missing, rel):
    """Every public name and parameter of this reference module is in the
    port, renamed as RENAMED says, or listed in NOT_PORTED."""
    unlisted = [key for key in all_missing[rel] if not _listed(key)]
    assert not unlisted, unlisted


@pytest.mark.parametrize("pattern", sorted(NOT_PORTED))
def test_not_ported_entry_is_not_stale(all_missing, pattern):
    """Each NOT_PORTED entry names something the port still lacks."""
    assert NOT_PORTED[pattern].strip()
    assert any(fnmatch.fnmatchcase(key, pattern)
               for keys in all_missing.values() for key in keys), pattern


@pytest.mark.parametrize("pattern", sorted(RENAMED))
def test_renamed_entry_is_not_stale(pattern):
    """Each RENAMED entry matches a reference item whose old name the
    port lacks and whose new name it has."""
    new, reason = RENAMED[pattern]
    assert reason.strip()
    rel_pattern, _, item_pattern = pattern.partition(":")
    hits = 0
    for rel in fnmatch.filter(MODULES, rel_pattern):
        mod = importlib.import_module(port_module_name(rel))
        for qualname, params in reference_items(rel):
            if "(" in item_pattern:
                keys = [(p, f"{rel}:{qualname}({p})") for p in params or ()]
            else:
                keys = [(qualname.split(".")[-1], f"{rel}:{qualname}")]
            for old, key in keys:
                if not fnmatch.fnmatchcase(key, pattern):
                    continue
                hits += 1
                if "(" in item_pattern:
                    fn = _resolve(mod, _port_qualname(rel, qualname))
                    have = _signature_names(fn)
                    assert old not in have and new in have, key
                else:
                    assert _resolve(mod, qualname) is MISSING, key
                    assert _resolve(mod, _port_qualname(rel, qualname)) \
                        is not MISSING, key
    assert hits, pattern


def test_the_chaos_layer_has_repros_fail_stop_mode():
    """The last behaviours that lacked a counterpart: ``fault_mode`` at
    its reference position, ``Job.killed``, ``ChaosObserver.on_kill`` and
    ``run_scenario(keep_result=)``."""
    from repro_torch.sim import faults, job, scenarios, simulator

    params = list(inspect.signature(simulator.Simulator).parameters)
    assert params.index("fault_mode") == params.index("observer") + 1
    assert params.index("priority_preemption") == \
        params.index("fault_mode") + 1
    assert "killed" in {f.name for f in dataclasses.fields(job.Job)}
    assert callable(faults.ChaosObserver.on_kill)
    assert "keep_result" in inspect.signature(
        scenarios.run_scenario).parameters
    for rel in ("src/repro/sim/simulator.py", "src/repro/sim/job.py",
                "src/repro/sim/faults.py", "src/repro/sim/scenarios.py"):
        assert missing_names(rel) == [], rel
