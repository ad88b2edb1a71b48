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

A call binds in the port as in ``repro``: each positional parameter the
two share (after ``RENAMED``) has the same index in both, and a
reference dataclass's fields keep their order (a field the port makes
``kw_only`` is not positional); each shared parameter keeps the
reference's literal default, stays required where the reference
requires it and keeps a default where the reference has one. The
departures the port means stand in ``MOVED`` and ``DEFAULTS``, each
with its reason, and are held against staleness in the same way.
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


# Parameters the port binds otherwise on purpose: ``path:qualname(param)``
# (fnmatch patterns) -> reason. MOVED: a positional parameter at another
# index (``departures``); DEFAULTS: another default, or none.
_DEVICE = "the port's initialisers take the device to build on after the "\
    "generator"
MOVED = {
    "src/repro/models/attention.py:init_attention(*)": _DEVICE,
    "src/repro/models/blocks.py:init_layer(*)": _DEVICE,
    "src/repro/models/ffn.py:init_ffn(*)": _DEVICE,
    "src/repro/models/common.py:dense_init(*)": _DEVICE,
    "src/repro/models/common.py:embed_init(*)": _DEVICE,
    "src/repro/models/common.py:init_norm(*)":
        "the device to build on comes after cfg (init_norm takes no key)",
    "src/repro/kernels/ssd_scan/kernel.py:ssd_scan_kernel(*)":
        "ssd_scan (RENAMED) takes the ops-level order chunk, d_skip",
    "src/repro/sim/fleet.py:QueryBroker(*)":
        "pad_b is not ported (NOT_PORTED): max_inflight moves up one",
    "src/repro/sim/fleet.py:BrokerStats(*)":
        "k_needed, k_slots and padded_grids are not ported (NOT_PORTED): "
        "the fields after them move up",
    "src/repro/eval/runner.py:EvalRunner(*)":
        "the fleet_* aliases are not ported (NOT_PORTED): engine moves up",
    "benchmarks/failover_drill.py:run_*(*)":
        "the engine the daemons run on comes first (run_failover also "
        "drops the unread seed)",
    "benchmarks/fleet_bench.py:canary_section(*)":
        "the engine and device the drill fails over from come before "
        "flushes",
    "benchmarks/kernels_bench.py:main(*)":
        "argv comes first, as in every bench's main; emit follows",
    "benchmarks/fitmask_bench.py:run_sweep(*)":
        "singlepass_sweep (RENAMED) takes the kernel, device and timer "
        "first, then the (grid, B, K) cells as one list",
}
DEFAULTS = {
    "src/repro/launch/dryrun.py:build_dryrun(multi_pod)":
        "False, a single pod, as the port's trace_cost defaults it",
    "src/repro/models/model.py:init_model(key)":
        "generator=None is PyTorch's default generator for the device; a "
        "JAX key has no such default",
    "benchmarks/fleet_bench.py:engine_section(engine)":
        "'jax' is repro's engine; the port's caller names the engine it "
        "times, as it names the device",
    "benchmarks/report.py:*_table(*path)":
        "repro reads the committed BENCH_*.json; the port never reads or "
        "writes them, so the caller names its experiments/ file",
    "benchmarks/fitmask_bench.py:run_sweep(*)":
        "the cells default to SINGLEPASS_CELLS, and 50 timed calls on the "
        "card replace the 3 of repro's sweep",
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


def _listed(key, table=NOT_PORTED):
    return any(fnmatch.fnmatchcase(key, p) for p in table)



# ---------------------------------------------------------- positions
REQUIRED = object()      # a parameter with no default
EXPRESSION = object()    # a default of the reference that is no literal
POSITIONAL = (inspect.Parameter.POSITIONAL_ONLY,
              inspect.Parameter.POSITIONAL_OR_KEYWORD)


def _default(node):
    if node is None:
        return REQUIRED
    try:
        return ast.literal_eval(node)
    except (ValueError, TypeError, SyntaxError):
        return EXPRESSION


def _call_signature(fn):
    """(positional parameters, {parameter: default}) of a ``def``."""
    a = fn.args
    positional = [x.arg for x in a.posonlyargs + a.args]
    defaults = [None] * (len(positional) - len(a.defaults)) + a.defaults
    out = {name: _default(d) for name, d in zip(positional, defaults)}
    out.update((x.arg, _default(d))
               for x, d in zip(a.kwonlyargs, a.kw_defaults))
    drop = ("self", "cls")
    return ([n for n in positional if n not in drop],
            {n: d for n, d in out.items() if n not in drop})


def _is_dataclass(node):
    for d in node.decorator_list:
        d = d.func if isinstance(d, ast.Call) else d
        if getattr(d, "id", getattr(d, "attr", None)) == "dataclass":
            return True
    return False


def _dataclass_signature(node):
    """(fields in order, {field: default}) of a ``@dataclass`` class. The
    reference's dataclasses use no ``kw_only``, ``init=False``,
    ``ClassVar`` or base dataclass, so every annotated field is a
    positional parameter of ``__init__``."""
    fields, defaults = [], {}
    for item in node.body:
        if not (isinstance(item, ast.AnnAssign)
                and isinstance(item.target, ast.Name)):
            continue
        value = item.value
        if isinstance(value, ast.Call) and \
                getattr(value.func, "id", "") == "field":
            kw = {k.arg: k.value for k in value.keywords}
            default = _default(kw["default"]) if "default" in kw else \
                EXPRESSION if "default_factory" in kw else REQUIRED
        else:
            default = _default(value)
        fields.append(item.target.id)
        defaults[item.target.id] = default
    return fields, defaults


def reference_signatures(rel):
    """(qualname, positional parameters, {parameter: default}, dataclass
    fields or None) of every public callable of one module; a class's
    ``__init__`` (or its dataclass fields) goes under the class's name."""
    tree = ast.parse(open(os.path.join(ROOT, rel)).read())
    out = []
    for node in _body(tree.body):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if _public(node.name):
                out.append((node.name, *_call_signature(node), None))
        elif isinstance(node, ast.ClassDef) and _public(node.name):
            init = None
            for item in node.body:
                if not isinstance(item,
                                  (ast.FunctionDef, ast.AsyncFunctionDef)):
                    continue
                if item.name == "__init__":
                    init = item
                    out.append((node.name, *_call_signature(item), None))
                elif _public(item.name):
                    out.append((f"{node.name}.{item.name}",
                                *_call_signature(item), None))
            if init is None and _is_dataclass(node):
                fields, defaults = _dataclass_signature(node)
                out.append((node.name, fields, defaults, fields))
    return out


def _port_signature(obj):
    """(positional parameters, {parameter: default}) of the port's
    callable, or None; ``*args``/``**kwargs`` are neither."""
    try:
        sig = inspect.signature(obj)
    except (TypeError, ValueError):
        return None
    params = [p for p in sig.parameters.values()
              if p.name not in ("self", "cls") and p.kind not in
              (p.VAR_POSITIONAL, p.VAR_KEYWORD)]
    return ([p.name for p in params if p.kind in POSITIONAL],
            {p.name: REQUIRED if p.default is p.empty else p.default
             for p in params})


def _same_default(ref, port):
    if ref is REQUIRED or port is REQUIRED:
        return ref is port
    if ref is EXPRESSION:
        return True
    return type(ref) is type(port) and ref == port


def departures(rel):
    """Keys (``path:qualname(param)``) of the reference's parameters that
    the port has but binds otherwise: ``moved``, a positional parameter
    at another index (or keyword-only in the port) or a dataclass field
    in another order; ``defaults``, a parameter the reference requires
    that the port does not, or whose literal default the port changes,
    or whose default the port drops."""
    mod = importlib.import_module(port_module_name(rel))
    moved, defaults = [], []
    for qualname, positional, ref_defaults, fields in \
            reference_signatures(rel):
        key = f"{rel}:{qualname}"
        obj = _resolve(mod, _port_qualname(rel, qualname))
        port = None if obj is MISSING or not callable(obj) else \
            _port_signature(obj)
        if port is None:
            continue
        port_positional, port_defaults = port
        here = {p: _renamed(f"{key}({p})") or p for p in ref_defaults}
        for i, p in enumerate(positional):
            if here[p] in port_defaults and (
                    here[p] not in port_positional
                    or port_positional.index(here[p]) != i):
                moved.append(f"{key}({p})")
        if fields is not None and dataclasses.is_dataclass(obj):
            port_fields = [f.name for f in dataclasses.fields(obj)]
            order = [f for f in port_fields if f in fields]
            shared = [f for f in fields if f in port_fields]
            moved += [f"{key}({a})" for a, b in zip(shared, order)
                      if a != b and f"{key}({a})" not in moved]
        defaults += [f"{key}({p})" for p, ref in ref_defaults.items()
                     if here[p] in port_defaults
                     and not _same_default(ref, port_defaults[here[p]])]
    return {"moved": moved, "defaults": defaults}


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


@pytest.fixture(scope="module")
def all_departures():
    return {rel: departures(rel) for rel in MODULES}


@pytest.mark.parametrize("rel", MODULES)
def test_positional_parameters_keep_their_place(all_departures, rel):
    """A positional call binds as in repro: every positional parameter
    (and dataclass field) the port shares sits at the reference's index,
    unless MOVED lists it."""
    unlisted = [key for key in all_departures[rel]["moved"]
                if not _listed(key, MOVED)]
    assert not unlisted, unlisted


@pytest.mark.parametrize("rel", MODULES)
def test_defaults_are_the_references(all_departures, rel):
    """A shared parameter keeps the reference's literal default, stays
    required where repro requires it, and keeps a default where repro
    has one, unless DEFAULTS lists it."""
    unlisted = [key for key in all_departures[rel]["defaults"]
                if not _listed(key, DEFAULTS)]
    assert not unlisted, unlisted


@pytest.mark.parametrize("table,pattern",
                         [("moved", p) for p in sorted(MOVED)]
                         + [("defaults", p) for p in sorted(DEFAULTS)])
def test_binding_entry_is_not_stale(all_departures, table, pattern):
    """Each MOVED and DEFAULTS entry names a departure the port still
    makes."""
    reason = (MOVED if table == "moved" else DEFAULTS)[pattern]
    assert reason.strip()
    assert any(fnmatch.fnmatchcase(key, pattern)
               for found in all_departures.values()
               for key in found[table]), pattern


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
