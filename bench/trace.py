"""The traced run's instruments: ``torch.profiler`` over the window for
the device's operations, and a sampler of what the host's threads were
doing, which names the device's idle time.

The profiler records device activity only (``ProfilerActivity.CUDA``):
the window holds hundreds of thousands of host-side torch calls, and
recording each would cost more than the window itself. What the host
was doing comes from the sampler instead: every few milliseconds it
reads the innermost frame of the program (``repro_torch``) in each
thread that is not waiting.
"""
from __future__ import annotations

import bisect
import sys
import threading
import time
from collections import Counter, defaultdict
from typing import Any, Dict, List, Optional, Tuple

SAMPLE_S = 0.005
# Frames in these files mean a thread is blocked, not working.
_WAITING = ("threading.py", "selectors.py", "queue.py", "socket.py",
            "base_events.py", "subprocess.py")


def host_label(frame) -> Optional[str]:
    """``module:function`` of the innermost frame of the program, or
    ``waiting`` where the thread is blocked; ``None`` outside the
    program."""
    code = frame.f_code
    if code.co_filename.endswith(_WAITING) or code.co_name in ("wait",
                                                               "select"):
        return "waiting"
    f = frame
    while f is not None:
        path = f.f_code.co_filename
        if "repro_torch" in path:
            mod = path.split("repro_torch", 1)[1].strip("/\\")
            mod = mod[:-3] if mod.endswith(".py") else mod
            return f"{mod.replace('/', '.')}:{f.f_code.co_name}"
        f = f.f_back
    return None


class HostSampler:
    """Samples every thread but its own; keeps (time, labels)."""

    def __init__(self, period: float = SAMPLE_S):
        self.period = period
        self.samples: List[Tuple[float, List[str]]] = []
        self._t: List[float] = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._thread = threading.Thread(target=self._run, name="bench-sampler",
                                        daemon=True)
        self._thread.start()

    def _run(self) -> None:
        me = threading.get_ident()
        while not self._stop.wait(self.period):
            t = time.perf_counter()
            labels = []
            for ident, frame in sys._current_frames().items():
                if ident == me:
                    continue
                label = host_label(frame)
                if label is not None and label != "waiting":
                    labels.append(label)
            self.samples.append((t, labels))

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)

    def label_between(self, t0: float, t1: float) -> str:
        """What the host's threads did most in ``[t0, t1)``; for a gap
        shorter than the sampling period, what they did at the sample
        nearest to it."""
        i = bisect.bisect_left(self._times, t0)
        j = bisect.bisect_left(self._times, t1)
        counts: Counter = Counter()
        for _, labels in self.samples[i:j]:
            counts.update(labels)
        if not counts:
            near = [k for k in (i - 1, i) if 0 <= k < len(self.samples)]
            if near:
                mid = (t0 + t1) / 2
                k = min(near, key=lambda k: abs(self._times[k] - mid))
                counts.update(self.samples[k][1])
        if not counts:
            return "host: outside the program"
        return counts.most_common(1)[0][0]

    @property
    def _times(self) -> List[float]:
        if len(self._t) != len(self.samples):
            self._t = [t for t, _ in self.samples]
        return self._t


def union_busy(intervals: List[Tuple[float, float]]) -> Tuple[float, List]:
    """Length of the union of ``[start, end)`` intervals (seconds), and
    the gaps between them as (start, end)."""
    busy = 0.0
    gaps = []
    cur_s = cur_e = None
    for s, e in sorted(intervals):
        if cur_e is None:
            cur_s, cur_e = s, e
        elif s <= cur_e:
            cur_e = max(cur_e, e)
        else:
            busy += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy, gaps


class Tracer:
    """Profiles the device over the window and samples the host."""

    def __init__(self, on_card: bool = True):
        self.on_card = on_card
        self.sampler = HostSampler()
        self._prof = None
        self.t0 = self.t1 = 0.0
        self._clocks: Dict[str, int] = {}

    def start(self) -> None:
        if self.on_card:
            from torch.profiler import ProfilerActivity, profile
            self._prof = profile(activities=[ProfilerActivity.CUDA])
            self._prof.__enter__()
        self.sampler.start()
        self._clocks = {"time": time.time_ns(),
                        "monotonic": time.monotonic_ns(),
                        "perf": time.perf_counter_ns()}
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        if self.on_card:
            import torch
            torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.sampler.stop()
        if self._prof is not None:
            self._prof.__exit__(None, None, None)

    def _device_events(self) -> List[Tuple[str, float, float]]:
        """(name, start, end) of each device operation, in seconds on
        the ``perf_counter`` clock."""
        if self._prof is None:
            return []
        results = self._prof.profiler.kineto_results
        events = []
        start_ns = results.trace_start_ns()
        for ev in results.events():
            if ev.device_type().name != "CUDA":
                continue
            events.append((ev.name(), ev.start_ns(), ev.duration_ns()))
        # Map the profiler's clock onto perf_counter: the trace starts
        # at the clock reading taken when the profiler was entered.
        base = min(self._clocks.items(),
                   key=lambda kv: abs(kv[1] - start_ns))
        offset = (self._clocks["perf"] - base[1]) \
            if abs(base[1] - start_ns) < 10**10 \
            else self._clocks["perf"] - start_ns
        return [(name, (s + offset) / 1e9, (s + offset + d) / 1e9)
                for name, s, d in events]

    def summary(self) -> Dict[str, Any]:
        events = self._device_events()
        window = self.t1 - self.t0
        inside = [(n, max(s, self.t0), min(e, self.t1))
                  for n, s, e in events if e > self.t0 and s < self.t1]
        busy, gaps = union_busy([(s, e) for _, s, e in inside])
        by_name: Dict[str, float] = defaultdict(float)
        for n, s, e in inside:
            by_name[n] += e - s
        edges = sorted(inside, key=lambda x: x[1])
        if edges:
            gaps = [(self.t0, edges[0][1])] + gaps \
                + [(max(e for _, _, e in edges), self.t1)]
        else:
            gaps = [(self.t0, self.t1)]
        idle: Dict[str, float] = defaultdict(float)
        for g0, g1 in gaps:
            if g1 > g0:
                idle[self.sampler.label_between(g0, g1)] += g1 - g0
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        gaps_top = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
        return {"window_s": window, "busy_s": busy,
                "device_ops": [[n, s] for n, s in top],
                "idle_gaps": [[n, s] for n, s in gaps_top],
                "kernel_s": dict(by_name)}
