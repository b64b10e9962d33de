"""mfu_volume_decode: the window's geo decoder queries that the volume
decodes need (coarse points and chosen blocks' points, counted at the
decoder's block selection; the padding of a pass's last chunk is left out)
times the frozen FLOPs a query, over the program's "Volume Decoding"
seconds (which also hold the VAE trunk and the surface extraction), as a
share of the bf16 peak, in %."""

from benchmark import flops

SCOPE = "Volume Decoding"


def read(run):
    counts = run.counts
    if not counts or not counts.get("volume_decode"):
        return None
    work = sum(q for q, _ in counts["volume_decode"]) * flops.geo_query_flops(run.config["vae"])
    return 100.0 * work / sum(t[SCOPE] for t in run.timings) / flops.PEAK_BF16
