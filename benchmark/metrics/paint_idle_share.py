"""paint_idle_share: 1 − the device's busy time a 2.5D UNet 'r' pass (the
device time of the kernels launched inside the ``bench.paint_unet`` spans
of the traced requests, over their passes) over the device's stretch a
paint step in the window (the program's "Paint Step" markers: device
seconds from the step's first enqueued work to its last, summed over the
window's requests, over their count), in %. Built like ``dit_idle_share``:
the busy time from the trace, the time it is set against from the
untraced window. The step's kernels outside the UNet (the LCM update and
the noise draw) count as idle here."""


def read(run):
    passes = (run.traced_counts or {}).get("unet_r")
    if run.trace is None or not passes:
        return None
    busy = run.trace.device_s.get("paint_unet", 0.0) / len(passes)
    timed = [t for t in run.timings if "Paint Step/device_s" in t]
    steps = sum(t.get("Paint Step/n", 0) for t in timed)
    device_s = sum(t["Paint Step/device_s"] for t in timed)
    if busy <= 0.0 or not steps or device_s <= 0.0:
        return None
    return 100.0 * (1.0 - busy / (device_s / steps))
