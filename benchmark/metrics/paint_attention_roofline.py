"""paint_attention_roofline: kernel 1's share of its roofline in the
traced requests' paint stack, in %: the dense attention calls of the 2.5D
UNet and its dual copy that the flash kernel takes (``ops/attention.py``'s
gate: self, reference, cross and the 24,576-token multiview attention at
64² latents), 4·B·H·Lq·Lk·D operations at the peak of their dtype, q, k, v
and o moved once, as bound time, over the device time of the kernels
launched inside those calls (``bench.attention``)."""

from benchmark import flops


def read(run):
    calls = (run.traced_counts or {}).get("attention")
    if run.trace is None or not calls:
        return None
    device_s = run.trace.device_s.get("attention", 0.0)
    if device_s <= 0.0:
        return None
    bound = sum(flops.bound_s(flops.attention_flops(b, h, lq, lk, d),
                              flops.attention_bytes(b, h, lq, lk, d, flops.BYTES_BY_DTYPE[dt]),
                              flops.PEAK_BY_DTYPE[dt])
                for b, h, lq, lk, d, dt in calls)
    return 100.0 * bound / device_s
