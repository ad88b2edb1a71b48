"""Spans and counters at the layer boundaries of the placement path.

``span(name)`` times a block (``with obs.span("x") as s: ...``, after
which ``s.seconds`` is its duration) or a function (``@obs.span("x")``);
``count(name, n)`` adds to a counter. Both are always on; on the host
core of an H100 machine a span costs 1–2 µs and a count 0.2–0.4 µs. Each
thread keeps its own span stack and a tree of aggregates keyed by the
path of span names from the thread's root, and touches no lock. :func:`totals` merges the threads into

  ``paths``     ``"a/b/c"`` -> count, total seconds, self seconds of the
                span ``c`` entered under ``b`` under ``a``;
  ``spans``     name -> count, total seconds, self seconds and the names
                of its parents (``""``: entered at a thread's root);
  ``counters``  name -> value.

A span's *self* seconds are its duration less the durations of the spans
entered beneath it on the same thread. Garbage collection is the span
``host.gc``, pushed on the collecting thread's stack by a ``gc.callbacks``
hook, so the spans it interrupts exclude it from their self time.

Spans are stamped with :func:`time.perf_counter_ns`. With
:func:`keep_intervals` each closed span is also kept, up to a bound, as
``(name, parent name, thread id, t0_ns, t1_ns)`` for :func:`intervals`
(off by default). Nothing is written anywhere.
"""
from __future__ import annotations

import functools
import gc
import os
import threading
from collections import deque
from time import perf_counter_ns
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

GC_SPAN = "host.gc"


class _Node:
    """One path of span names on one thread, with its aggregates."""

    __slots__ = ("name", "parent", "children", "count", "total_ns",
                 "self_ns")

    def __init__(self, name: str, parent: Optional["_Node"]):
        self.name = name
        self.parent = parent
        self.children: Dict[str, "_Node"] = {}
        self.count = 0
        self.total_ns = 0
        self.self_ns = 0


class _Thread:
    """A thread's span stack, its tree of aggregates and its counters.
    A stack frame is ``[node, t0_ns, child_ns]``; the bottom one is the
    root's and never closes."""

    __slots__ = ("thread", "root", "stack", "counters")

    def __init__(self):
        self.thread = threading.current_thread()
        self.root = _Node("", None)
        self.stack: List[list] = [[self.root, 0, 0]]
        self.counters: Dict[str, int] = {}


_local = threading.local()
_lock = threading.Lock()              # the registry, never a span
_threads: List[_Thread] = []
# Aggregates of threads that have ended: path -> [count, total, self] ns.
_retired: Dict[str, List[int]] = {}
_retired_counters: Dict[str, int] = {}
_intervals: Optional[Deque[Tuple[str, str, int, int, int]]] = None


def _after_fork_in_child() -> None:
    # A forked worker keeps the parent's aggregates (``diff`` removes
    # them) but not a registry lock another thread may have held. Only
    # the forking thread lives on: the others' aggregates are retired
    # here, since a thread the fork caught starting or exiting can fail
    # ``is_alive()`` in the child.
    global _lock
    _lock = threading.Lock()
    me = threading.current_thread()
    for st in _threads:
        if st.thread is not me:
            _walk(st.root, "", _retired)
            _add_counters(_retired_counters, st.counters)
    _threads[:] = [st for st in _threads if st.thread is me]


os.register_at_fork(after_in_child=_after_fork_in_child)


def _state() -> _Thread:
    try:
        return _local.state
    except AttributeError:
        st = _local.state = _Thread()
        _local.stack = st.stack
        with _lock:
            _threads.append(st)
        return st


def _child(parent: _Node, name: str) -> _Node:
    node = parent.children.get(name)
    if node is None:
        node = parent.children[name] = _Node(name, parent)
    return node


def _enter(name: str) -> list:
    try:
        stack = _local.stack
    except AttributeError:
        stack = _state().stack
    parent = stack[-1][0]
    node = parent.children.get(name) or _child(parent, name)
    # The frame is made before the clock is read: a collection that its
    # allocation sets off then falls before this span, not inside it.
    frame = [node, 0, 0]
    stack.append(frame)
    frame[1] = perf_counter_ns()
    return frame


def _exit(frame: list) -> int:
    t1 = perf_counter_ns()
    stack = _local.stack
    if stack[-1] is frame:
        stack.pop()
    else:
        # Spans left open above it (a generator dropped mid-span) are
        # discarded with it; a frame no longer on the stack is ignored.
        for i in range(len(stack) - 1, 0, -1):
            if stack[i] is frame:
                del stack[i:]
                break
        else:
            return t1 - frame[1]
    node, t0, child = frame
    d = t1 - t0
    node.count += 1
    node.total_ns += d
    node.self_ns += d - child
    stack[-1][2] += d
    iv = _intervals
    if iv is not None:
        iv.append((node.name, node.parent.name, _local.state.thread.ident,
                   t0, t1))
    return d


class span:
    """A timed block or function. As a context manager it yields itself,
    and ``seconds`` holds the block's duration once it has closed. As a
    decorator each call of the function is one span."""

    __slots__ = ("name", "seconds", "_frame")

    def __init__(self, name: str):
        self.name = name
        self.seconds = 0.0
        self._frame: Optional[list] = None

    def __enter__(self) -> "span":
        self._frame = _enter(self.name)
        return self

    def __exit__(self, *exc) -> None:
        self.seconds = _exit(self._frame) * 1e-9

    def __call__(self, fn: Callable) -> Callable:
        name = self.name

        @functools.wraps(fn)
        def timed(*args, **kwargs):
            frame = _enter(name)
            try:
                return fn(*args, **kwargs)
            finally:
                _exit(frame)
        return timed


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` (this thread's share of it)."""
    c = _state().counters
    c[name] = c.get(name, 0) + n


# -- garbage collection -------------------------------------------------

def _gc_hook(phase: str, info: Dict[str, Any]) -> None:
    stack = _state().stack
    if phase == "start":
        stack.append([_child(stack[-1][0], GC_SPAN), perf_counter_ns(), 0])
    elif len(stack) > 1 and stack[-1][0].name == GC_SPAN:
        _exit(stack[-1])


if not any(getattr(cb, "__qualname__", "") == "_gc_hook"
           and getattr(cb, "__module__", "") == __name__
           for cb in gc.callbacks):
    gc.callbacks.append(_gc_hook)


# -- the timeline --------------------------------------------------------

def keep_intervals(limit: Optional[int]) -> None:
    """Keep each span closed from now on, the latest ``limit`` of them,
    for :func:`intervals`; ``0`` or ``None`` stops keeping them and
    drops those kept."""
    global _intervals
    _intervals = deque(maxlen=int(limit)) if limit else None


def intervals() -> List[Tuple[str, str, int, int, int]]:
    """The spans kept since :func:`keep_intervals`, oldest first, as
    ``(name, parent name, thread id, t0_ns, t1_ns)``."""
    iv = _intervals
    return list(iv) if iv is not None else []


# -- totals ---------------------------------------------------------------

def _walk(node: _Node, prefix: str, out: Dict[str, List[int]]) -> None:
    for name, child in list(node.children.items()):
        path = prefix + name
        agg = out.setdefault(path, [0, 0, 0])
        agg[0] += child.count
        agg[1] += child.total_ns
        agg[2] += child.self_ns
        _walk(child, path + "/", out)


def _add_counters(into: Dict[str, int], more: Dict[str, int]) -> None:
    for k, v in list(more.items()):
        into[k] = into.get(k, 0) + v


def totals() -> Dict[str, Any]:
    """Every thread's spans and counters so far, merged (see the module's
    docstring). Threads that have ended are folded into one record."""
    with _lock:
        live = []
        for st in _threads:
            if st.thread.is_alive():
                live.append(st)
            else:
                _walk(st.root, "", _retired)
                _add_counters(_retired_counters, st.counters)
        _threads[:] = live
        paths = {p: list(a) for p, a in _retired.items()}
        counters = dict(_retired_counters)
    for st in live:
        _walk(st.root, "", paths)
        _add_counters(counters, st.counters)
    return _summary({p: {"count": c, "total_s": t * 1e-9, "self_s": s * 1e-9}
                     for p, (c, t, s) in paths.items() if c}, counters)


def _summary(paths: Dict[str, Dict[str, float]],
             counters: Dict[str, int]) -> Dict[str, Any]:
    spans: Dict[str, Dict[str, Any]] = {}
    for path, a in paths.items():
        parent, _, name = path.rpartition("/")
        s = spans.setdefault(name, {"count": 0, "total_s": 0.0,
                                    "self_s": 0.0, "parents": []})
        s["count"] += a["count"]
        s["total_s"] += a["total_s"]
        s["self_s"] += a["self_s"]
        parent = parent.rpartition("/")[2]
        if parent not in s["parents"]:
            s["parents"].append(parent)
    for s in spans.values():
        s["parents"].sort()
    return {"paths": paths, "spans": spans, "counters": counters}


def diff(before: Dict[str, Any], after: Dict[str, Any]) -> Dict[str, Any]:
    """What happened between two :func:`totals`: paths and counters that
    moved, with ``spans`` recomputed from them."""
    b = before.get("paths", {})
    paths = {}
    for path, a in after.get("paths", {}).items():
        o = b.get(path, {"count": 0, "total_s": 0.0, "self_s": 0.0})
        if a["count"] != o["count"]:
            paths[path] = {k: a[k] - o[k]
                           for k in ("count", "total_s", "self_s")}
    bc = before.get("counters", {})
    counters = {k: v - bc.get(k, 0)
                for k, v in after.get("counters", {}).items()
                if v != bc.get(k, 0)}
    return _summary(paths, counters)


def merge(records: List[Dict[str, Any]]) -> Dict[str, Any]:
    """The sum of several :func:`totals` or :func:`diff` records (the
    fleets of one run, the workers of a pool)."""
    paths: Dict[str, Dict[str, float]] = {}
    counters: Dict[str, int] = {}
    for rec in records:
        for path, a in rec.get("paths", {}).items():
            o = paths.setdefault(path, {"count": 0, "total_s": 0.0,
                                        "self_s": 0.0})
            for k in o:
                o[k] += a[k]
        _add_counters(counters, rec.get("counters", {}))
    return _summary(paths, counters)


def under(rec: Dict[str, Any], name: str) -> Dict[str, float]:
    """Self seconds by span name of everything entered beneath a span
    ``name`` (the span itself included), from ``rec``'s paths."""
    out: Dict[str, float] = {}
    for path, a in rec.get("paths", {}).items():
        parts = path.split("/")
        if name in parts:
            leaf = parts[-1]
            out[leaf] = out.get(leaf, 0.0) + a["self_s"]
    return out
