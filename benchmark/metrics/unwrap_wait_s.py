"""unwrap_wait_s: the seconds the textured call waits for the UV unwrap
after its denoise, mean a request over the window: the program's
"UV Unwrap (wait)" scope (the unwrap runs in the host worker process from
the call's start; this is its tail past the multiview diffusion)."""

SCOPE = "UV Unwrap (wait)"


def read(run):
    seconds = [t[SCOPE] for t in run.timings if SCOPE in t]
    return sum(seconds) / len(seconds) if seconds else None
