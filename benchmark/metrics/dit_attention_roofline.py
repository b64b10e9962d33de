"""dit_attention_roofline: kernel 1's share of its roofline in the traced
requests' DiT forwards, in %. The work is counted from the forwards' shapes
at the DiT's entry (``bench.dit``): each of the depth + depth_single_blocks
blocks attends over its [cond | latent] tokens, 4·B·H·L²·D operations at
the bf16 peak, q, k, v and o moved once. The time is the device time of
the bf16 kernel-1 kernels (by name) that ran inside the Diffusion Sampling
stage: the program's stage scope drains the device at both ends, so the
stage's kernels run between the start of its ``bench.diffusion_sampling``
span and the start of the next benchmark span after it, and only the DiT
attends there. Read by kernel name and stage, not by the launching call,
so a forward replayed from a CUDA graph (whose kernels never pass the
Python ``attention`` entry that ``attention_roofline`` reads) still counts."""

from benchmark import flops, tracing

KERNEL = "flash_bf16_kernel"
STAGE = tracing.SPAN_PREFIX + "diffusion_sampling"


def read(run):
    forwards = (run.traced_counts or {}).get("dit")
    if run.trace is None or not forwards:
        return None
    spans = run.trace.spans
    stages = []
    for i, (start, end, name, _) in enumerate(spans):
        if name == STAGE:
            after = [s for s, _, _, _ in spans[i + 1:] if s >= end]
            stages.append((start, min(after, default=run.trace.end)))
    device_s = sum(e - s for s, e, name, _ in run.trace.ops
                   if KERNEL in name and any(a <= s < b for a, b in stages))
    if device_s <= 0.0:
        return None
    cfg = run.config["dit"]
    heads = cfg["num_heads"]
    d = cfg["hidden_size"] // heads
    blocks = cfg["depth"] + cfg["depth_single_blocks"]
    bound = sum(blocks * flops.bound_s(flops.attention_flops(b, heads, lat + cond, lat + cond, d),
                                       flops.attention_bytes(b, heads, lat + cond, lat + cond, d,
                                                             flops.BYTES_BY_DTYPE["bfloat16"]),
                                       flops.PEAK_BF16)
                for b, lat, cond in forwards)
    return 100.0 * bound / device_s
