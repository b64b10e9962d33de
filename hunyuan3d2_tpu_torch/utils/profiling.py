"""Profiling and tracing helpers (port of hunyuan3d2_tpu/utils/profiling.py).

The reference's ``synchronize_timer`` is utils/timer.py; this module adds
what the JAX package built on ``jax.profiler``, on ``torch.profiler``:

* ``trace(log_dir)``: a context manager around ``torch.profiler.profile``
  (CPU activity, and CUDA activity where a card is present) that writes a
  Chrome / perfetto trace (``*.pt.trace.json``) into ``log_dir`` when the
  scope ends;
* ``annotate(name)``: a named span in the trace
  (``torch.profiler.record_function``);
* ``device_memory_stats(device)``: the device memory in use, its peak and
  the device's size, under the JAX package's keys; ``{}`` for a device
  without such stats (the CPU), as in the JAX package;
* ``top_device_ops(path)`` and ``device_busy(path)``: the device operations
  of a trace file that took the most time, summed by name, and the device's
  busy time beside the traced span.
"""

from __future__ import annotations

import contextlib
import json
import os
import socket
import tempfile
import time
from typing import Optional

import torch


class Trace:
    """What :func:`trace` yields: ``log_dir``, ``profile`` (the
    ``torch.profiler.profile``, for ``key_averages()``) and, once the scope
    has ended, ``path``, the trace file written."""

    def __init__(self, log_dir: str, profile):
        self.log_dir = log_dir
        self.profile = profile
        self.path: Optional[str] = None


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """Trace the scope's host and device work into ``log_dir`` (default
    ``hy3d_trace`` under the temporary directory); yields a :class:`Trace`.
    The device queue is drained before the trace is written."""
    from torch.profiler import ProfilerActivity, profile

    log_dir = os.path.abspath(log_dir or os.path.join(tempfile.gettempdir(), "hy3d_trace"))
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        out = Trace(log_dir, prof)
        try:
            yield out
        finally:
            if torch.cuda.is_initialized():
                torch.cuda.synchronize()
    out.path = os.path.join(log_dir, f"{socket.gethostname()}.{os.getpid()}."
                                     f"{time.time_ns()}.pt.trace.json")
    prof.export_chrome_trace(out.path)


def annotate(name: str):
    """A named span in the trace (``with annotate("loss"): ...``)."""
    return torch.profiler.record_function(name)


def device_memory_stats(device=None) -> dict:
    """``bytes_in_use``, ``peak_bytes_in_use`` (since the last
    ``torch.cuda.reset_peak_memory_stats``) and ``bytes_limit`` (the card's
    memory) of a CUDA device (the current one when None); ``{}`` where the
    device keeps no such stats."""
    dev = torch.device(device) if device is not None else (
        torch.device("cuda", torch.cuda.current_device()) if torch.cuda.is_available()
        else torch.device("cpu"))
    if dev.type != "cuda":
        return {}
    stats = torch.cuda.memory_stats(dev)
    _, total = torch.cuda.mem_get_info(dev)
    return {
        "bytes_in_use": stats.get("allocated_bytes.all.current", 0),
        "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
        "bytes_limit": total,
    }


DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def top_device_ops(path: str, n: int = 10) -> list:
    """The ``n`` device operations (kernels, copies, memsets) of the trace
    file ``path`` with the most total time: ``[{"name", "ms", "calls"}]``,
    largest first."""
    with open(path) as fh:
        events = json.load(fh).get("traceEvents", [])
    by_name = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES:
            ms, calls = by_name.get(e["name"], (0.0, 0))
            by_name[e["name"]] = (ms + e.get("dur", 0) / 1e3, calls + 1)
    rows = [{"name": k, "ms": ms, "calls": c} for k, (ms, c) in by_name.items()]
    return sorted(rows, key=lambda r: -r["ms"])[:n]


def device_busy(path: str) -> dict:
    """The union of the device operations' intervals in the trace file
    ``path`` (``busy_ms``) and the span from the first traced event to the
    last (``span_ms``): their ratio is the device's busy share."""
    with open(path) as fh:
        events = [e for e in json.load(fh).get("traceEvents", []) if e.get("ph") == "X"]
    dev = sorted((e["ts"], e["ts"] + e.get("dur", 0)) for e in events
                 if e.get("cat") in DEVICE_CATEGORIES)
    busy, end = 0.0, None
    for s, t in dev:
        if end is None or s > end:
            busy += t - s
            end = t
        elif t > end:
            busy += t - end
            end = t
    span = (max(e["ts"] + e.get("dur", 0) for e in events) - min(e["ts"] for e in events)
            if events else 0.0)
    return {"busy_ms": busy / 1e3, "span_ms": span / 1e3}
