"""mfu_cond_dit: the window's DINOv2 encodes and DiT forwards (frozen
analytic FLOPs from the shapes at each call's entry) over the program's
"Encode Cond" + "Diffusion Sampling" seconds, as a share of the bf16 peak,
in %."""

from benchmark import flops

SCOPES = ("Encode Cond", "Diffusion Sampling")


def read(run):
    counts = run.counts
    if not counts or not counts.get("dit") or not counts.get("dino"):
        return None
    work = (flops.dino_encode_flops(run.config["dino"], sum(counts["dino"]))
            + sum(flops.dit_forward_flops(run.config["dit"], lat, cond, b)
                  for b, lat, cond in counts["dit"]))
    seconds = sum(t[s] for t in run.timings for s in SCOPES)
    return 100.0 * work / seconds / flops.PEAK_BF16
