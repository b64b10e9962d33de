"""encode_cond_s: the program's "Encode Cond" stage, mean seconds a request over the
window (its own timed scope: host clock, device drained at both ends)."""

SCOPE = "Encode Cond"


def read(run):
    seconds = [t[SCOPE] for t in run.timings if SCOPE in t]
    return sum(seconds) / len(seconds) if seconds else None
