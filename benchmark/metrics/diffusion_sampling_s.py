"""diffusion_sampling_s: the program's "Diffusion Sampling" stage, mean seconds a request over the
window (its own timed scope: host clock, device drained at both ends)."""

SCOPE = "Diffusion Sampling"


def read(run):
    seconds = [t[SCOPE] for t in run.timings if SCOPE in t]
    return sum(seconds) / len(seconds) if seconds else None
