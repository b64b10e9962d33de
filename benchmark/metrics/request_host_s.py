"""request_host_s: the seconds of a request outside its three device
stages, mean over the window: the program's "Image to Mesh" span (the
entry call, its root) less its "Encode Cond", "Diffusion Sampling" and
"Volume Decoding" scopes. What is left is Preprocess, the latents' set-up,
Export and the glue between the stages, while the device idles (the stages
drain the device at both ends)."""

ROOT = "Image to Mesh"
STAGES = ("Encode Cond", "Diffusion Sampling", "Volume Decoding")


def read(run):
    host = [t[ROOT] - sum(t[s] for s in STAGES) for t in run.timings
            if ROOT in t and all(s in t for s in STAGES)]
    return sum(host) / len(host) if host else None
