"""attention_roofline: the traced requests' attention calls at
ops/attention.py's entry (4·B·H·Lq·Lk·D operations, dense; q, k, v and o
moved once; the peak of their dtype) as bound time, over the device time of
the kernels launched inside those calls, in %."""

from benchmark import flops


def read(run):
    if run.trace is None or not run.traced_counts.get("attention"):
        return None
    device_s = run.trace.device_s.get("attention", 0.0)
    if device_s <= 0.0:
        return None
    bound = sum(flops.bound_s(flops.attention_flops(b, h, lq, lk, d),
                              flops.attention_bytes(b, h, lq, lk, d, flops.BYTES_BY_DTYPE[dt]),
                              flops.PEAK_BY_DTYPE[dt])
                for b, h, lq, lk, d, dt in run.traced_counts["attention"])
    return 100.0 * bound / device_s
