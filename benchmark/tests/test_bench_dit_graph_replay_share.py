"""The reader of the DiT forward's graph replays (``dit_graph_replay_share``,
from the program's "DiT/graph_replays" counter over its
"DiT Step/n"): 100 where every step's forward replayed, less where some
ran the eager body, None with no steps or with no replay counted (the
parent program has no counter; a CPU run replays nothing)."""

from types import SimpleNamespace

import pytest

from benchmark import harness

REPLAYS = "DiT/graph_replays"


def read(timings):
    return harness.load_file("metrics", "dit_graph_replay_share").read(
        SimpleNamespace(timings=timings))


def _request(steps, replays=None):
    t = {"Image to Mesh": 0.8, "Diffusion Sampling": 0.3, "DiT Step": 0.01 * steps,
         "DiT Step/n": steps}
    if replays is not None:
        t[REPLAYS] = replays
    return t


@pytest.mark.parametrize("timings, want", [
    ([_request(5, 5)] * 4, 100.0),
    # the first request captured: its forwards replayed too
    ([_request(5, 5), _request(5, 5), _request(5, 5)], 100.0),
    # a request with no replay (its forwards ran eagerly) beside three that replayed
    ([_request(5, 5), _request(5), _request(5, 5), _request(5, 5)], 75.0),
    ([_request(4, 2), _request(4, 4)], 75.0),
])
def test_the_share_of_steps_that_replayed(timings, want):
    assert read(timings) == pytest.approx(want)


@pytest.mark.parametrize("timings", [
    [],                                            # no request
    [{"Image to Mesh": 0.8}] * 3,                  # no step
    [_request(5)] * 3,                             # no replay counted: the parent, a CPU run
])
def test_none_without_steps_or_replays(timings):
    assert read(timings) is None


def test_a_traced_tiny_cpu_run_leaves_it_out(tiny):
    import time

    result = harness.run_cell(tiny, 2 ** 31 + 43, 0.5, True, "cpu", time.perf_counter(),
                              log=lambda *a, **k: None)
    assert result["correct"], result["checks"]
    assert "dit_graph_replay_share" not in result["metrics"]
    assert result["metrics"]["dit_step_host_s"]["value"] > 0
