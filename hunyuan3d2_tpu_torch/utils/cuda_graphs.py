"""How a port module runs as a CUDA graph (models/dit.py's forward,
models/paint_unet.py's 'r' pass). A call that passes :func:`graphable` and
the module's own conditions replays a :class:`Graph` of the eager body,
captured at the first call of its key (:meth:`GraphPool.capture`):

- once per key shape, the first-use work runs outside the graph: an eager
  pass on the caller's stream (kernel libraries' loads, cuDNN's plans), then
  a short pass on the device's capture stream (its cuBLAS workspace);
- the capture runs on that stream in ``thread_local`` mode (other threads'
  work stays theirs), into the module's pool, which an anchor graph holds
  across captures; it is cut into pieces wherever the body calls
  :func:`cut` (a body with no cut is one piece), and each cut call runs
  eagerly between the pieces at every replay;
- the warm-ups and the capture count nothing on the ops' launch counters;
  each replay adds the counted launches captured in its pieces.

A module keeps its policy: its key, the graphs it keeps, its thread rule and
its static inputs (allocated before the capture, outside the pool). Graphing
another module costs a key, a warm-up pass's inputs and calls to these
helpers."""

from __future__ import annotations

import sys
import threading
from typing import Any, NamedTuple

import torch

_CAPTURE_STREAMS = {}       # device → the side stream every capture on it uses
_CAPTURE = threading.local()    # .pieces: the capture this thread is making


def capture_stream(device: torch.device):
    """One side stream a device for the captures: cuBLAS keeps a workspace
    for each stream it runs on, so one stream holds one more."""
    stream = _CAPTURE_STREAMS.get(device)
    if stream is None:
        stream = _CAPTURE_STREAMS[device] = torch.cuda.Stream(device)
    return stream


def launch_counts() -> dict:
    """Each launch counter of the port's ops (an op function's
    ``launches``, e.g. ``flash_attention.launches``) → its count."""
    counts = {}
    for name, mod in list(sys.modules.items()):
        if name.startswith("hunyuan3d2_tpu_torch.ops.") and mod is not None:
            for fn in vars(mod).values():
                if callable(fn) and type(getattr(fn, "launches", None)) is int:
                    counts[fn] = fn.launches
    return counts


def anchored_pool(device: torch.device):
    """(a new graph memory pool, its anchor): a graph of one small kernel
    captured into the pool on the device's capture stream. PyTorch releases
    a pool once no graph holds it, and refuses captures into it after; the
    anchor holds it, and the memory it caches, for the captures to come."""
    pool = torch.cuda.graph_pool_handle()
    anchor = torch.cuda.CUDAGraph()
    stream = capture_stream(device)
    stream.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(stream):
        anchor.capture_begin(pool=pool, capture_error_mode="thread_local")
        try:
            torch.zeros(1, device=device)
        finally:
            anchor.capture_end()
    return pool, anchor


def graphable(module, *inputs) -> bool:
    """The common gate of a graphed call: every input a tensor on the card,
    grad mode off, no capture running on the current stream, and the module
    not sharded (``parallel_mesh``)."""
    return (all(isinstance(x, torch.Tensor) and x.is_cuda for x in inputs)
            and not torch.is_grad_enabled()
            and not torch.cuda.is_current_stream_capturing()
            and getattr(module, "parallel_mesh", None) is None)


def capturing() -> bool:
    """Whether this thread is capturing a body (where :func:`cut` may end a
    piece)."""
    return getattr(_CAPTURE, "pieces", None) is not None


def cut(fn, *args, like: torch.Tensor) -> torch.Tensor:
    """Inside this thread's capture: end the open piece here and open the
    next. At each replay ``fn(*args)`` runs eagerly between the two, its
    result copied into the static output returned here (contiguous, shaped
    as ``like``), which the next piece reads."""
    return _CAPTURE.pieces.cut(fn, args, like)


class _Pieces:
    """One capture, cut at the body's :func:`cut` calls: graphs captured
    one after another on this thread into one memory pool."""

    def __init__(self, pool):
        self.pool, self.pieces, self.graph = pool, [], None
        self._begin()

    def _begin(self):
        graph = torch.cuda.CUDAGraph()
        graph.capture_begin(pool=self.pool, capture_error_mode="thread_local")
        self.graph = graph

    def _end(self):
        graph, self.graph = self.graph, None
        graph.capture_end()
        return graph

    def cut(self, fn, args, like):
        graph = self._end()
        self._begin()
        out = torch.empty_like(like, memory_format=torch.contiguous_format)
        self.pieces.append((graph, (fn, args, out)))
        return out

    def end(self):
        if self.graph is not None:          # a cut that failed leaves none open
            self.pieces.append((self._end(), None))


class Graph(NamedTuple):
    pieces: tuple           # (CUDA graph, the cut call after it: fn, args, static out; None last)
    args: tuple             # the static arguments it was captured on
    output: Any             # the static output
    launches: tuple         # (op, n): the counted launches captured in the pieces

    def replay(self):
        """Replay the pieces, each cut call between them, and count the
        captured launches; returns the static output."""
        for graph, call in self.pieces:
            graph.replay()
            if call is not None:
                fn, args, out = call
                out.copy_(fn(*args))
        for fn, n in self.launches:
            fn.launches += n
        return self.output


class GraphPool:
    """A module's graph memory pool, held by its anchor, and the key shapes
    whose first-use work is done."""

    def __init__(self):
        self.pool = None        # (pool, anchor), made by the first capture
        self.warmed = set()

    def drop(self):
        """Let the pool go (the module's tensors may move); the next capture
        makes a new one."""
        self.pool = None

    def capture(self, body, args: tuple, short: tuple, shapes) -> Graph:
        """Capture ``body(*args)`` on the static ``args`` (the first a
        tensor on the device), after the first-use passes if ``shapes`` is
        new: ``body(*args)`` on the caller's stream, then ``body(*short)``
        on the capture stream."""
        device = args[0].device
        if self.pool is None:
            self.pool = anchored_pool(device)
        first = shapes not in self.warmed
        before = launch_counts()
        if first:
            body(*args)
        caller, stream = torch.cuda.current_stream(device), capture_stream(device)
        stream.wait_stream(caller)
        with torch.cuda.stream(stream):
            if first:
                body(*short)
                self.warmed.add(shapes)
            warm = launch_counts()
            pieces = _Pieces(self.pool[0])
            _CAPTURE.pieces = pieces
            try:
                output = body(*args)
            finally:
                _CAPTURE.pieces = None
                pieces.end()
        caller.wait_stream(stream)
        after = launch_counts()
        for fn, n in after.items():         # the warm-ups and the capture count nothing
            fn.launches -= n - before.get(fn, 0)
        launches = tuple((fn, n - warm.get(fn, 0)) for fn, n in after.items()
                         if n != warm.get(fn, 0))
        return Graph(tuple(pieces.pieces), args, output, launches)
