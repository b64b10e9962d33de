"""decode_query_yield: the share of the geo decoder's queries that the
volume decodes need, over the window, in %: 100 × the program's
"Volume Decoding/queries_needed" (counted at the block selection in
volume/decoders.py: the coarse points and the chosen blocks' points) over
its "Volume Decoding/queries_sent" (counted at each decode call: the
needed ones plus the padding of each pass's last chunk)."""

NEEDED = "Volume Decoding/queries_needed"
SENT = "Volume Decoding/queries_sent"


def read(run):
    sent = sum(t.get(SENT, 0) for t in run.timings)
    if not sent:
        return None
    return 100.0 * sum(t.get(NEEDED, 0) for t in run.timings) / sent
