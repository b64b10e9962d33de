"""Stage timers and the request recorder of the pipelines.

Port of hunyuan3d2_tpu/utils/timer.py (reference hy3dgen/shapegen/utils.py
``synchronize_timer``). Device work is asynchronous under PyTorch too, so a
stage scope drains the CUDA queue with ``torch.cuda.synchronize()`` before
reading the clock whenever this process has initialised CUDA (the JAX
package used ``jax.effects_barrier``), and writes its seconds into
``LAST_TIMINGS[tag]`` at its exit.

The recorder keys the same scopes by request:

* :func:`request` wraps a public entry call. The outermost one opens a
  request, a new id and a :class:`Request` record; the last ``RING``
  records stay (:func:`requests`, :func:`last_request`). One opened inside
  another request is a child span of it.
* :class:`span` times work inside a stage with no host sync. On a CUDA
  ``device`` it records a pooled CUDA event at its enter and exit
  (markers), read only at the request's end, when the stages' drains have
  completed them: the span's device seconds.
* :func:`add` keeps a counter at its source in the open request
  (``Request.totals``); a device tensor's sum is read at the request's end.
* :func:`record_span` adds work that ran in another process as a stage
  span, with its own ``LAST_TIMINGS`` key.

Each span stores its name, request, parent and host start and end on
``time.perf_counter_ns()``; the open span is per thread (``contextvars``).
Outside a request a span records nothing, and a stage scope only writes
``LAST_TIMINGS``. While a ``torch.profiler`` records, every span also
enters ``torch.profiler.record_function("hy3d.<name>")``; ``CLOCK`` maps
the records' clock onto the wall clock of such a trace (:func:`wall_ns`).

At a request's end ``LAST_TIMINGS`` gets its flat view beside the stage
keys (:meth:`Request.flat`): ``"<span>"`` the host seconds summed over
the request's spans of that name (stage scopes keep their own key),
``"<span>/device_s"`` the device seconds between the markers,
``"<span>/n"`` the count of a child span, and the sums of :func:`add`.
Keys of the previous request's flat view that this one lacks are removed.
"""

import collections
import contextvars
import functools
import itertools
import os
import threading
import time

import torch

from hunyuan3d2_tpu_torch.utils.logger import get_logger

logger = get_logger("hunyuan3d2_tpu_torch.timer")

# Most recent timing per tag; callers surface it in their stats.
LAST_TIMINGS = {}

RING = 64
PROFILER_PREFIX = "hy3d."
# (perf_counter_ns, time_ns) read together: a record's time on the wall clock
CLOCK = (time.perf_counter_ns(), time.time_ns())

_current = contextvars.ContextVar("hy3d_span", default=None)
_ids = itertools.count(1)
_records = collections.deque(maxlen=RING)
_events = []                 # timing events free for reuse
_flat_lock = threading.Lock()
_flat_keys = set()           # LAST_TIMINGS keys of the last request's flat view


def wall_ns(perf_ns: int) -> int:
    """``time.perf_counter_ns()`` reading → ``time.time_ns()`` clock."""
    return CLOCK[1] + perf_ns - CLOCK[0]


class Span:
    """One timed interval of a request. ``device_s`` is set at the
    request's end for a span with markers; None otherwise."""

    __slots__ = ("name", "request", "parent", "stage", "start_ns", "end_ns", "device_s",
                 "_markers", "_range", "_token")

    def __init__(self, name: str, request: "Request", parent: "Span", stage: bool = False):
        self.name, self.request, self.parent, self.stage = name, request, parent, stage
        self.start_ns = self.end_ns = self.device_s = None
        self._markers = self._range = self._token = None

    @property
    def request_id(self) -> int:
        return self.request.id

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9

    def __repr__(self):
        return f"Span({self.name!r}, request {self.request.id}, {self.seconds:.6f} s)"


class Request:
    """What one entry call did: its spans in the order they opened (the
    root first), and the counters kept at their source."""

    def __init__(self, name: str):
        self.id = next(_ids)
        self.name = name
        self.spans = []
        self.totals = {}     # key → sum

    @property
    def root(self) -> Span:
        return self.spans[0]

    def self_s(self, span: Span) -> float:
        """``span``'s seconds less the time its children cover."""
        covered, end = 0, span.start_ns
        for s in sorted((s for s in self.spans if s.parent is span), key=lambda s: s.start_ns):
            a, b = max(s.start_ns, end), min(s.end_ns, span.end_ns)
            if b > a:
                covered += b - a
                end = b
        return span.seconds - covered * 1e-9

    def flat(self) -> dict:
        """The flat view that ``LAST_TIMINGS`` gets at the request's end."""
        out = {}
        for s in self.spans:
            if s.stage:
                continue
            out[s.name] = out.get(s.name, 0.0) + s.seconds
            if s.parent is not None:
                out[s.name + "/n"] = out.get(s.name + "/n", 0) + 1
            if s.device_s is not None:
                out[s.name + "/device_s"] = out.get(s.name + "/device_s", 0.0) + s.device_s
        out.update(self.totals)
        return out


def _profiling() -> bool:
    return torch.autograd._profiler_enabled()


def _event():
    try:
        return _events.pop()
    except IndexError:
        return torch.cuda.Event(enable_timing=True)


def _open(name: str, device=None, stage: bool = False, root: bool = False):
    """A new span under the open one (a new request for a ``root`` opened
    outside any), or None outside a request."""
    parent = _current.get()
    if parent is None:
        if not root:
            return None
        req = Request(name)
    else:
        req = parent.request
    s = Span(name, req, parent, stage)
    req.spans.append(s)
    s._token = _current.set(s)
    # the host interval holds the range and the markers
    s.start_ns = time.perf_counter_ns()
    if _profiling():
        s._range = torch.profiler.record_function(PROFILER_PREFIX + name)
        s._range.__enter__()
    if getattr(device, "type", None) == "cuda":
        # both markers on the stream current at the enter (one lookup)
        s._markers = (_event(), _event(), torch.cuda.current_stream())
        s._markers[0].record(s._markers[2])
    return s


def _close(s: Span):
    if s._markers is not None:
        s._markers[1].record(s._markers[2])
    if s._range is not None:
        s._range.__exit__(None, None, None)
        s._range = None
    s.end_ns = time.perf_counter_ns()
    _current.reset(s._token)
    if s.parent is None:
        _finish(s.request)


def _finish(req: Request):
    """Read the request's markers (completed by the stages' drains; one
    still pending is left unread) and its counters summed on the device,
    free its events, keep the record and write its flat view."""
    global _flat_keys
    for s in req.spans:
        if s._markers is None:
            continue
        a, b, _ = s._markers
        try:
            s.device_s = a.elapsed_time(b) * 1e-3
        except RuntimeError:     # not completed
            pass
        _events.extend((a, b))
        s._markers = None
    for k, v in req.totals.items():
        if isinstance(v, torch.Tensor):     # summed on the device (``add``)
            req.totals[k] = v.item()
    _records.append(req)
    flat = req.flat()
    with _flat_lock:
        for k in _flat_keys - flat.keys():
            LAST_TIMINGS.pop(k, None)
        LAST_TIMINGS.update(flat)
        _flat_keys = set(flat)


def request(name: str):
    """Decorator of a public entry call: the call is the span ``name``, a
    request's root when no request is open on this thread."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            s = _open(name, root=True)
            try:
                return fn(*args, **kwargs)
            finally:
                _close(s)
        return call
    return wrap


class span:
    """``with span("name", device=t.device):`` times work inside a request
    with no host sync; on a CUDA ``device`` with device markers."""

    __slots__ = ("name", "device", "_span")

    def __init__(self, name: str, device=None):
        self.name, self.device, self._span = name, device, None

    def __enter__(self):
        self._span = _open(self.name, self.device)
        return self

    def __exit__(self, *exc):
        if self._span is not None:
            _close(self._span)
        return False


def record_span(name: str, start_ns: int, end_ns: int):
    """Work that ran elsewhere (another process of this machine, on the
    same ``perf_counter_ns`` clock): a stage span under the open span, whose
    seconds go into ``LAST_TIMINGS[name]`` as a stage scope's do (so the
    next request's flat view keeps them)."""
    LAST_TIMINGS[name] = (end_ns - start_ns) * 1e-9
    parent = _current.get()
    if parent is None:
        return
    s = Span(name, parent.request, parent, stage=True)
    s.start_ns, s.end_ns = start_ns, end_ns
    parent.request.spans.append(s)


def add(key: str, n):
    """Add ``n`` to the open request's ``totals[key]`` (a flat view key).
    ``n`` may be a tensor on the device: the sum stays there, with no host
    sync, and is read at the request's end, after the stages' drains."""
    s = _current.get()
    if s is not None:
        totals = s.request.totals
        totals[key] = totals.get(key, 0) + n


def requests() -> list:
    """The last ``RING`` finished requests, oldest first."""
    return list(_records)


def last_request():
    """The most recently finished request, or None."""
    return _records[-1] if _records else None


def _device_sync():
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


class synchronize_timer:
    """``with synchronize_timer('stage'):`` or ``@synchronize_timer('stage')``
    records the elapsed wall clock (device queue drained at both ends) into
    ``LAST_TIMINGS[tag]``, and logs it when HY3DGEN_DEBUG=1. A decorator
    without a tag records under the function's qualified name. Inside a
    request the scope is a stage span of it."""

    def __init__(self, tag: str = ""):
        self.tag = tag
        self.elapsed = None

    def __enter__(self):
        _device_sync()
        self._span = _open(self.tag, stage=True)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        _device_sync()
        self.elapsed = time.perf_counter() - self._t0
        if self._span is not None:
            _close(self._span)
        LAST_TIMINGS[self.tag] = self.elapsed
        if os.environ.get("HY3DGEN_DEBUG", "0") == "1":
            logger.info("%s takes %.4f s", self.tag, self.elapsed)
        return False

    def __call__(self, fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with type(self)(self.tag or fn.__qualname__):
                return fn(*args, **kwargs)

        return wrapper


class timed_scope(synchronize_timer):
    """The pipelines' stage timer, which fills their per-stage stats
    (``LAST_TIMINGS``)."""
