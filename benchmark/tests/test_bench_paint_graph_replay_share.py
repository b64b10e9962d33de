"""The reader of the paint loop's step-graph replays
(``paint_graph_replay_share``, from the program's "Paint/graph_replays"
counter over its "Paint Step/n"): 100 where every step's 'r' pass
replayed, less where some ran the eager body, None with no steps or with
no replay counted (a parent program without the counter; a CPU run
replays nothing)."""

from types import SimpleNamespace

import pytest
from paint_tiny import paint_tiny_spec

from benchmark import harness

REPLAYS = "Paint/graph_replays"


def read(timings):
    return harness.load_file("metrics", "paint_graph_replay_share").read(
        SimpleNamespace(timings=timings))


def _request(steps, replays=None):
    t = {"Mesh to Texture": 1.8, "Multiview Diffusion (device)": 1.2, "Paint Step": 0.02 * steps,
         "Paint Step/n": steps}
    if replays is not None:
        t[REPLAYS] = replays
        t["Paint/graph_captures"] = 1
    return t


@pytest.mark.parametrize("timings, want", [
    ([_request(10, 10)] * 4, 100.0),
    # a request whose steps ran the eager body beside three that replayed
    ([_request(10, 10), _request(10), _request(10, 10), _request(10, 10)], 75.0),
    ([_request(10, 5), _request(10, 10)], 75.0),
])
def test_the_share_of_steps_that_replayed(timings, want):
    assert read(timings) == pytest.approx(want)


@pytest.mark.parametrize("timings", [
    [],                                            # no request
    [{"Mesh to Texture": 1.8}] * 3,                # no step
    [_request(10)] * 3,                            # no replay counted: the parent, a CPU run
])
def test_none_without_steps_or_replays(timings):
    assert read(timings) is None


def test_a_traced_tiny_cpu_run_leaves_it_out():
    import time

    result = harness.run_cell(paint_tiny_spec(), 2 ** 31 + 47, 0.5, True, "cpu",
                              time.perf_counter(), log=lambda *a, **k: None)
    assert result["correct"], result["checks"]
    assert "paint_graph_replay_share" not in result["metrics"]
    assert result["metrics"]["paint_step_host_s"]["value"] > 0
