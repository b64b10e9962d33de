"""masked_attention_roofline: kernel 2's share of its roofline in the
traced requests, in %. The work is what the voxel masks allow: the
program counts, a request, each mask grid's allowed (query, key) pairs and
all its pairs times the calls that use it ("Multiview Diffusion/
mva_pairs_live/<L>" and ".../mva_pairs_masked_total/<L>", L the grid's
multiview token count, pipelines/hunyuanpaint.py). A grid's calls that the
masked flash kernel takes (``ops/attention.py``'s gate, as the benchmark's
tap saw them: heads H, head size D, dtype) are bound by the larger of 4·H·D
operations an allowed pair at the peak of their dtype and their bytes (q, k,
v and o moved once, the bool mask read once) at the memory's rate. The
time is the device time of the kernels launched inside those calls
(``bench.masked_attention``). None where the program keeps no such
counters."""

from benchmark import flops

LIVE = "Multiview Diffusion/mva_pairs_live/"
TOTAL = "Multiview Diffusion/mva_pairs_masked_total/"


def read(run):
    counts = run.traced_counts or {}
    calls, timings = counts.get("masked_attention"), counts.get("timings")
    if run.trace is None or not calls or not timings:
        return None
    device_s = run.trace.device_s.get("masked_attention", 0.0)
    shapes = {lq: (b, h, d, dt) for b, h, lq, lk, d, dt in calls}
    bound = 0.0
    for t in timings:
        for lq, (b, h, d, dt) in shapes.items():
            live, total = t.get(LIVE + str(lq)), t.get(TOTAL + str(lq))
            if not live or not total:
                return None
            n = total / (b * lq * lq)                                # the grid's calls
            nbytes = n * (flops.attention_bytes(b, h, lq, lq, d, flops.BYTES_BY_DTYPE[dt])
                          + b * lq * lq)
            bound += flops.bound_s(4.0 * h * d * live, nbytes, flops.PEAK_BY_DTYPE[dt])
    return 100.0 * bound / device_s if device_s > 0.0 else None
