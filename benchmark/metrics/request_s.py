"""request_s: the window's wall time over the requests completed in it, in
seconds (host clock; a stall counts)."""


def read(run):
    return run.window_s / len(run.latencies) if run.latencies else None
