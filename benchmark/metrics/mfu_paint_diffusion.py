"""mfu_paint_diffusion: the window's multiview diffusion work (frozen
analytic FLOPs, ``benchmark/paint_flops.py``, from the shapes at each
call's entry: the 2.5D UNet's 'r' pass a step, the dual copy's 'w' pass
that fills the reference cache, the VAE encodes and decodes) over the
program's "Multiview Diffusion (device)" seconds, as a share of the bf16
peak, in %."""

from benchmark import flops, paint_flops

SCOPE = "Multiview Diffusion (device)"


def read(run):
    counts = run.counts
    if not counts or not counts.get("unet_r"):
        return None
    seconds = sum(t[SCOPE] for t in run.timings if SCOPE in t)
    if seconds <= 0.0:
        return None
    return 100.0 * paint_flops.diffusion_flops(run.config, counts) / seconds / flops.PEAK_BF16
