"""paint_graph_replay_share: the share of the window's paint denoise steps
whose 2.5D UNet 'r' pass replayed the loop's step graph, in %: 100 × the
program's "Paint/graph_replays" (counted at each replay in
models/paint_unet.py) over its "Paint Step/n" (pipelines/hunyuanpaint.py's
loops run one 'r' pass a step), summed over the window's requests. None
where no request counted a replay (a program without the step graphs, or a
run on the CPU)."""

REPLAYS = "Paint/graph_replays"
STEPS = "Paint Step/n"


def read(run):
    steps = sum(t.get(STEPS, 0) for t in run.timings)
    if not steps or not any(REPLAYS in t for t in run.timings):
        return None
    return 100.0 * sum(t.get(REPLAYS, 0) for t in run.timings) / steps
