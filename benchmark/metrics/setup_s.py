"""setup_s: process start to the first timed request, in seconds: imports,
kernel builds (none after a checkout's first run), weights, inputs and the
warm-up calls."""


def read(run):
    return run.setup_s
