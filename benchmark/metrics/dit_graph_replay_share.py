"""dit_graph_replay_share: the share of the window's DiT forwards that
replayed the forward's captured CUDA graph, in %: 100 × the program's
"DiT/graph_replays" (counted at each replay in models/dit.py) over its
"DiT Step/n" (pipelines/shapegen.py's sample loop runs one forward a
step), summed over the window's requests. None where
no request counted a replay (a program without the graph, or a run on the
CPU)."""

REPLAYS = "DiT/graph_replays"
STEPS = "DiT Step/n"


def read(run):
    steps = sum(t.get(STEPS, 0) for t in run.timings)
    if not steps or not any(REPLAYS in t for t in run.timings):
        return None
    return 100.0 * sum(t.get(REPLAYS, 0) for t in run.timings) / steps
