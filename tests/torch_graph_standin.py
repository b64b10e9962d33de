"""A CPU stand-in for ``torch.cuda``'s graph, stream, pool and capture-state
calls, shared by the tests of utils/cuda_graphs.py and of the modules that
graph through it (models/dit.py, models/paint_unet.py); imports no JAX.

Inputs are tensors of :class:`OnCard`, which claims to lie on the card. The
stand-in graph records the operators its capture runs (a dispatch mode, on
the capturing thread only) and its replay runs them again on the tensors
they read, writing into the tensors they wrote, as the captured kernels
would; an allocation launches nothing and is not replayed. A Python-level
launch counter inside a captured body therefore counts only while it is
captured, as on the card."""

import contextlib
import threading
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from hunyuan3d2_tpu_torch.utils import cuda_graphs


class OnCard(torch.Tensor):
    """A CPU tensor that claims to lie on the card (results of torch
    operations on it are OnCard too)."""

    @property
    def is_cuda(self):
        return True


class _Record(TorchDispatchMode):
    def __init__(self, ops):
        super().__init__()
        self.ops = ops

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not func.name().startswith(("aten::empty", "aten::new_empty")):
            self.ops.append((func, args, kwargs, out))
        return out


class Card:
    """Stand-ins for ``torch.cuda``'s graph calls, with what they saw."""

    def __init__(self):
        self.graphs = []          # a weak reference to every graph made, in order
        self.captures = []        # (stream, capture_error_mode, pool) of each capture
        self.pools = []           # every graph pool handle made
        self.capturing = None     # the thread that captures
        self.replayed = 0         # the replays of every graph
        self.stream = self.Stream()
        self.current = self.stream
        card = self

        class Graph:
            def __init__(self):
                self.ops, self.replays = [], 0
                card.graphs.append(weakref.ref(self))

            def capture_begin(self, pool=None, capture_error_mode="global"):
                # one capture at a time on the one capture stream
                assert card.capturing is None
                card.captures.append((card.current, capture_error_mode, pool))
                card.capturing = threading.get_ident()
                self._mode = _Record(self.ops)
                self._mode.__enter__()

            def capture_end(self):
                assert card.capturing == threading.get_ident()
                self._mode.__exit__(None, None, None)
                card.capturing = None

            def replay(self):
                assert not card.here_capturing()
                self.replays += 1
                card.replayed += 1
                for func, args, kwargs, out in self.ops:
                    new = func(*args, **kwargs)
                    for o, n in zip(tree_leaves(out), tree_leaves(new)):
                        # a view or an in-place op wrote where it did at capture
                        if (isinstance(o, torch.Tensor) and o.untyped_storage().data_ptr()
                                != n.untyped_storage().data_ptr()):
                            o.copy_(n)

        self.Graph = Graph

    def graph_pool_handle(self):
        self.pools.append((0, len(self.pools) + 1))
        return self.pools[-1]

    @contextlib.contextmanager
    def use_stream(self, stream):
        saved, self.current = self.current, stream
        try:
            yield
        finally:
            self.current = saved

    class Stream:
        def __init__(self, device=None):
            self.device = device

        def wait_stream(self, other):
            pass

    def here_capturing(self):
        """Whether this thread captures (what is_current_stream_capturing
        answers on its stream)."""
        return self.capturing == threading.get_ident()

    @property
    def live_graphs(self):
        return [g for g in (r() for r in self.graphs) if g is not None]

    @property
    def piece_captures(self):
        """The captures less each pool's first, its anchor's."""
        return len(self.captures) - len(self.pools)


def install(monkeypatch) -> Card:
    """Put a new :class:`Card`'s stand-ins in place of ``torch.cuda``'s, with
    no capture stream made yet."""
    c = Card()
    monkeypatch.setattr(torch.cuda, "CUDAGraph", c.Graph)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", c.graph_pool_handle)
    monkeypatch.setattr(torch.cuda, "Stream", Card.Stream)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: c.current)
    monkeypatch.setattr(torch.cuda, "stream", c.use_stream)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", c.here_capturing)
    monkeypatch.setattr(cuda_graphs, "_CAPTURE_STREAMS", {})
    return c
