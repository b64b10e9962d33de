"""dit_step_host_s: the host's seconds a DiT step over the window, read from
the program's own "DiT Step" spans (pipelines/shapegen.py's sample loop, no
host sync inside): their summed seconds over their count, summed over the
window's requests. In a launch-bound loop this is the host's time to
enqueue one step."""

SPAN = "DiT Step"


def read(run):
    steps = sum(t.get(SPAN + "/n", 0) for t in run.timings)
    if not steps:
        return None
    return sum(t.get(SPAN, 0.0) for t in run.timings) / steps
