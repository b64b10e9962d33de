"""device_idle_share: 1 − the device's busy time a traced request (the
union of its kernels, copies and sets over the traced requests, divided by
their number) over the window's time a request (``request_s``), in %.

The traced requests run slower on the host than the window's (the
profiler records every operator, and the benchmark's spans are open), while
the device's work is the same; so the busy time comes from the trace and
the time it is set against from the untraced window."""


def read(run):
    if (run.trace is None or not run.trace.request_s or run.trace.busy_s <= 0.0
            or not run.latencies):
        return None
    busy = run.trace.busy_s / len(run.trace.request_s)
    return 100.0 * (1.0 - busy / (run.window_s / len(run.latencies)))
