"""One worker process for host work that overlaps the device: the textured
path's UV unwrap runs in it while the paint stack denoises.

The paint denoise is an eager loop whose launching thread holds the GIL for
its whole length, so host work on a thread beside it would slow both; a
process of its own shares neither. The worker starts on the first
``submit`` with the ``spawn`` method (the parent holds a CUDA context, which
``fork`` would copy into a child that cannot use it) and stops at exit.
``spawn`` re-imports the parent's ``__main__`` module, so a script that
textures keeps its work under ``if __name__ == "__main__":``. The worker
caps its OpenMP, BLAS and torch threads at ``THREADS`` and leaves the other
cores to the launching thread.

A failure raises: an exception in the worker comes back from the future's
``result()``, and a worker that fails to start or dies makes it raise
``BrokenProcessPool``; the next ``submit`` starts a fresh worker. A worker
whose parent dies without stopping it exits too. This module imports neither
torch nor numpy, so the worker loads only what the submitted function needs.
"""

from __future__ import annotations

import atexit
import multiprocessing
import os
import sys
import threading
import time
from concurrent.futures import Future, ProcessPoolExecutor
from concurrent.futures.process import BrokenProcessPool

# the worker's thread cap (OpenMP, BLAS, torch intra-op). The unwrap is
# mostly single-threaded numpy; on an 8-CPU H100 host caps of 1, 2, 4 and 6
# gave the same unwrap time and wait within their spread
# (PERF.md §6), so it keeps few cores
THREADS = 2
_THREAD_VARS = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")

_lock = threading.Lock()
_pool: ProcessPoolExecutor | None = None


def _init(threads: int):
    # read by the OpenMP and BLAS runtimes that load after this (numpy and
    # the native library load with the first task)
    for var in _THREAD_VARS:
        os.environ[var] = str(threads)
    torch = sys.modules.get("torch")   # loaded by the parent's __main__, if at all
    if torch is not None:
        torch.set_num_threads(threads)
    # a parent that dies without shutting the pool down (a crash, a kill)
    # would leave the worker blocked on its queue for ever
    threading.Thread(target=_exit_with, args=(multiprocessing.parent_process(),),
                     daemon=True).start()


def _exit_with(parent):
    parent.join()
    os._exit(0)


def _timed(fn, args):
    t0 = time.perf_counter_ns()
    value = fn(*args)
    t1 = time.perf_counter_ns()
    return value, (t1 - t0) * 1e-9, os.getpid(), (t0, t1)


def _start() -> ProcessPoolExecutor:
    return ProcessPoolExecutor(1, mp_context=multiprocessing.get_context("spawn"),
                               initializer=_init, initargs=(THREADS,))


def submit(fn, *args) -> Future:
    """Run ``fn(*args)`` in the worker (``fn`` a module-level function, the
    arguments picklable). The future's result is ``(value, seconds, pid,
    (start_ns, end_ns))``: the worker's own wall time of the call, its
    process id, and the call's start and end on the worker's
    ``time.perf_counter_ns`` clock (CLOCK_MONOTONIC on Linux, which the
    processes of one machine share)."""
    global _pool
    with _lock:
        if _pool is None:
            _pool = _start()
        try:
            return _pool.submit(_timed, fn, args)
        except BrokenProcessPool:
            # the worker died under an earlier task: this one gets a new worker
            _pool.shutdown(wait=False)
            _pool = _start()
            return _pool.submit(_timed, fn, args)


def shutdown():
    """Stop the worker (a later ``submit`` starts another)."""
    global _pool
    with _lock:
        pool, _pool = _pool, None
    if pool is not None:
        pool.shutdown(wait=True, cancel_futures=True)


atexit.register(shutdown)
