"""mfu_request: every frozen analytic FLOP of the window's requests (DINOv2,
DiT, VAE trunk and K/V, the geo decoder queries that the volume decodes
need) over the window's wall time, as a share of the bf16 peak, in %."""

from benchmark import flops


def read(run):
    counts = run.counts
    if not counts or not counts.get("dit"):
        return None
    cfg = run.config
    work = (flops.dino_encode_flops(cfg["dino"], sum(counts["dino"]))
            + sum(flops.dit_forward_flops(cfg["dit"], lat, cond, b)
                  for b, lat, cond in counts["dit"])
            + sum(flops.vae_trunk_flops(cfg["vae"], b) for b in counts["vae_trunk"])
            + sum(q for q, _ in counts["volume_decode"]) * flops.geo_query_flops(cfg["vae"]))
    return 100.0 * work / run.window_s / flops.PEAK_BF16
