"""Loop ``closed``: one client, which sends the next request when the last
one returns (the API server's and the gradio app's users: the server runs
one request at a time through the pipeline).

The window starts after the warm-up and runs requests while less than
``seconds`` have passed; it ends when the last of them returns, so its
wall time holds all the work and all the time of the requests counted.
"""

from __future__ import annotations

import sys
import time
import traceback


def window(run, system, request, seconds: float, sample, sync, log) -> int:
    """Run the window: ``request(i)`` is the window's i-th request, ``sample``
    the harness's draw of the requests the check keeps, ``sync`` drains the
    device. Fills ``run.latencies``, ``run.timings`` and ``run.window_s``;
    returns the number of failed requests."""
    failed = 0
    start = time.perf_counter()
    i = 0
    while time.perf_counter() - start < seconds:
        req = request(i)
        kept = {}
        grab = sample.capture(system, i, kept)
        t1 = time.perf_counter()
        try:
            with grab:
                kept["output"] = system(req)
            sync()
        except Exception:  # a failed request is counted, and the run goes on
            failed += 1
            log(traceback.format_exc(), file=sys.stderr)
        else:
            sample.keep(i, req, kept)
        run.latencies.append(time.perf_counter() - t1)
        run.timings.append(system.timings())
        i += 1
    run.window_s = time.perf_counter() - start
    return failed
