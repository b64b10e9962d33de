"""Scoped wall-clock timers for the pipelines' stages.

Port of hunyuan3d2_tpu/utils/timer.py (reference hy3dgen/shapegen/utils.py
``synchronize_timer``). Device work is asynchronous under PyTorch too, so a
scope drains the CUDA queue with ``torch.cuda.synchronize()`` before reading
the clock whenever this process has initialised CUDA (the JAX package used
``jax.effects_barrier``).
"""

import functools
import os
import time

import torch

from hunyuan3d2_tpu_torch.utils.logger import get_logger

logger = get_logger("hunyuan3d2_tpu_torch.timer")

# Most recent timing per tag; callers surface it in their stats.
LAST_TIMINGS = {}


def _device_sync():
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


class synchronize_timer:
    """``with synchronize_timer('stage'):`` or ``@synchronize_timer('stage')``
    records the elapsed wall clock (device queue drained at both ends) into
    ``LAST_TIMINGS[tag]``, and logs it when HY3DGEN_DEBUG=1. A decorator
    without a tag records under the function's qualified name."""

    def __init__(self, tag: str = ""):
        self.tag = tag
        self.elapsed = None

    def __enter__(self):
        _device_sync()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        _device_sync()
        self.elapsed = time.perf_counter() - self._t0
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
