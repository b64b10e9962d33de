"""paint_diffusion_s: the program's "Multiview Diffusion (device)" stage
of the textured call (the paint stack's VAE encode, the reference pass,
the LCM loop and the VAE decode), mean seconds a request over the window
(its own timed scope: host clock, device drained at both ends)."""

SCOPE = "Multiview Diffusion (device)"


def read(run):
    seconds = [t[SCOPE] for t in run.timings if SCOPE in t]
    return sum(seconds) / len(seconds) if seconds else None
