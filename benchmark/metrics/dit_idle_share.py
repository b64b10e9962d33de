"""dit_idle_share: 1 − the device's busy time a DiT forward (the device
time of the kernels launched inside the ``bench.dit`` spans of the traced
requests, over their forwards) over the device's stretch a DiT step in the
window (the program's "DiT Step" markers: device seconds from the step's
first enqueued work to its last, summed over the window's requests, over
their count), in %. Built like ``device_idle_share``: the busy time from
the trace, the time it is set against from the untraced window.

The step's kernels outside the forward (the bf16 cast of the latents and
the Euler update, a handful of elementwise launches) count as idle here."""


def read(run):
    forwards = (run.traced_counts or {}).get("dit")
    if run.trace is None or not forwards:
        return None
    busy = run.trace.device_s.get("dit", 0.0) / len(forwards)
    timed = [t for t in run.timings if "DiT Step/device_s" in t]
    steps = sum(t.get("DiT Step/n", 0) for t in timed)
    device_s = sum(t["DiT Step/device_s"] for t in timed)
    if busy <= 0.0 or not steps or device_s <= 0.0:
        return None
    return 100.0 * (1.0 - busy / (device_s / steps))
