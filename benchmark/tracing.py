"""The benchmark's own taps and spans around the program's layers, and the
reduction of a ``torch.profiler`` trace to device time by span.

Spans are ``torch.profiler.record_function`` ranges named ``bench.<layer>``
that the benchmark opens around calls into the program (taps: attributes
replaced for the duration of a ``with`` block, never the program's source).
A kernel belongs to every span open on the launching thread when it was
launched: the trace's launch event (CUDA runtime or driver API) and the
kernel share a correlation id. Arithmetic copied from the port's
``utils/profiling.py`` (``device_busy``, ``top_device_ops``).
"""

from __future__ import annotations

import contextlib
import json
from collections import defaultdict

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATEGORIES = ("cuda_runtime", "cuda_driver")
SPAN_PREFIX = "bench."

_MISSING = object()


@contextlib.contextmanager
def patched(taps):
    """Within the block ``obj.attr`` is ``wrap(obj.attr)`` for each (obj,
    attr, wrap) of ``taps``; an instance attribute set over a class's method
    is removed after, a module's attribute put back."""
    saved = []
    try:
        for obj, attr, wrap in taps:
            saved.append((obj, attr, vars(obj).get(attr, _MISSING)))
            setattr(obj, attr, wrap(getattr(obj, attr)))
        yield
    finally:
        for obj, attr, old in reversed(saved):
            if old is _MISSING:
                delattr(obj, attr)
            else:
                setattr(obj, attr, old)


def span(name: str):
    """A wrap for :func:`patched` that runs each call inside the span
    ``bench.<name>``."""
    import torch

    def wrap(fn):
        def call(*args, **kwargs):
            with torch.profiler.record_function(SPAN_PREFIX + name):
                return fn(*args, **kwargs)
        return call
    return wrap


def _union(intervals):
    """Sorted, merged [(start, end)] of ``intervals``."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


class DeviceTrace:
    """A chrome trace written by ``torch.profiler``, reduced to what the
    per-layer metrics read. Times are in seconds."""

    def __init__(self, path: str):
        with open(path) as fh:
            events = [e for e in json.load(fh).get("traceEvents", []) if e.get("ph") == "X"]
        self.ops = [(e["ts"] * 1e-6, (e["ts"] + e.get("dur", 0)) * 1e-6, e["name"],
                     e.get("args", {}).get("correlation"))
                    for e in events if e.get("cat") in DEVICE_CATEGORIES]
        launches = {e["args"]["correlation"]: (e["ts"] * 1e-6, e.get("tid"))
                    for e in events if e.get("cat") in LAUNCH_CATEGORIES
                    and "correlation" in e.get("args", {})}
        spans = [(e["ts"] * 1e-6, (e["ts"] + e.get("dur", 0)) * 1e-6, e["name"], e.get("tid"))
                 for e in events if e.get("cat") == "user_annotation"
                 and e["name"].startswith(SPAN_PREFIX)]
        requests = [s for s in spans if s[2] == SPAN_PREFIX + "request"]
        if not requests:
            raise ValueError("the trace holds no bench.request span")
        self.main_tid = requests[0][3]
        self.request_s = [e - s for s, e, _, _ in sorted(requests)]
        self.start = min(s[0] for s in requests)
        self.end = max(s[1] for s in requests)
        self.spans = sorted((s for s in spans if s[3] == self.main_tid), key=lambda s: s[0])
        self.busy_intervals = [(max(s, self.start), min(e, self.end))
                               for s, e in _union((o[0], o[1]) for o in self.ops)
                               if e > self.start and s < self.end]
        # device seconds and kernel counts of every span name, by launch
        self.device_s = defaultdict(float)
        self.kernels = defaultdict(int)
        self.unattributed = 0
        timed = []
        for s, e, name, corr in self.ops:
            launch = launches.get(corr)
            if launch is None or launch[1] != self.main_tid:
                if self.start <= s <= self.end:
                    self.unattributed += 1
                continue
            timed.append((launch[0], e - s))
        timed.sort()
        for (t, dur), names in zip(timed, self._open_at([t for t, _ in timed])):
            for name in set(names):
                self.device_s[name[len(SPAN_PREFIX):]] += dur
                self.kernels[name[len(SPAN_PREFIX):]] += 1

    def _open_at(self, times):
        """For each of the sorted ``times``, the names of the spans open then
        on the main thread, outermost first."""
        bounds = sorted([(s, 0, i) for i, (s, e, _, _) in enumerate(self.spans)]
                        + [(e, 1, i) for i, (s, e, _, _) in enumerate(self.spans)])
        open_, j, out = {}, 0, []
        for t in times:
            while j < len(bounds) and bounds[j][0] <= t:
                _, kind, i = bounds[j]
                if kind == 0:
                    open_[i] = self.spans[i][2]
                else:
                    open_.pop(i, None)
                j += 1
            out.append([open_[i] for i in sorted(open_, key=lambda i: self.spans[i][0])])
        return out

    @property
    def window_s(self) -> float:
        return self.end - self.start

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals)

    def top_device_ops(self, n: int = 10) -> list:
        """[[name, seconds]] of the ``n`` device operations with the most
        time inside the traced requests, summed by name."""
        by_name = defaultdict(float)
        for s, e, name, _ in self.ops:
            if self.start <= s <= self.end:
                by_name[name] += e - s
        return [[k, v] for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> list:
        """[[span, seconds]]: the device's idle time inside the traced
        requests, summed by the innermost benchmark span open on the host in
        the middle of each gap (``host`` where none is), the ``n`` largest."""
        edges = [self.start] + [t for iv in self.busy_intervals for t in iv] + [self.end]
        gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
        mids = [(a + b) / 2 for a, b in gaps]
        order = sorted(range(len(gaps)), key=lambda i: mids[i])
        names = self._open_at([mids[i] for i in order])
        by_name = defaultdict(float)
        for i, open_ in zip(order, names):
            key = open_[-1][len(SPAN_PREFIX):] if open_ else "host"
            by_name[key] += gaps[i][1] - gaps[i][0]
        return [[k, v] for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:n]]
