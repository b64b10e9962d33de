"""paint_step_host_s: the host's seconds a paint denoise step over the
window, read from the program's own "Paint Step" spans
(pipelines/hunyuanpaint.py's LCM loop, no host sync inside): their summed
seconds over their count, summed over the window's requests. In a
launch-bound loop this is the host's time to enqueue one step."""

SPAN = "Paint Step"


def read(run):
    steps = sum(t.get(SPAN + "/n", 0) for t in run.timings)
    if not steps:
        return None
    return sum(t.get(SPAN, 0.0) for t in run.timings) / steps
