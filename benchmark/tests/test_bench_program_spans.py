"""The readers of the program's own spans and counters (the port's request
recorder, read through ``System.timings()`` after each window request):
each gives its defined value on a hand-built run and None where its keys
are absent (a CPU run has no device markers, the parent program no spans);
a TINY traced run on the CPU reports the host-side ones, and the program's
query counts equal the benchmark's own taps on the same requests."""

import time
from types import SimpleNamespace

import pytest

from benchmark import harness

NEW = ("dit_step_host_s", "dit_idle_share", "request_host_s", "decode_query_yield")


def read(name, run):
    return harness.load_file("metrics", name).read(run)


def _request(root, enc, dit, vol, steps, step_s, device_s=None, sent=0, needed=0):
    t = {"Image to Mesh": root, "Encode Cond": enc, "Diffusion Sampling": dit,
         "Volume Decoding": vol, "DiT Step": steps * step_s, "DiT Step/n": steps,
         "Volume Decoding/queries_sent": sent, "Volume Decoding/queries_needed": needed}
    if device_s is not None:
        t["DiT Step/device_s"] = steps * device_s
    return t


def _trace(dit_device_s):
    return SimpleNamespace(device_s={"dit": dit_device_s})


def test_readers_on_a_hand_built_run():
    run = SimpleNamespace(
        timings=[_request(0.80, 0.07, 0.30, 0.40, 5, 0.060, 0.064, 1000, 950),
                 _request(0.90, 0.06, 0.35, 0.42, 5, 0.070, 0.056, 3000, 2850)],
        trace=_trace(3 * 5 * 0.045), traced_counts={"dit": [(1, 3072, 1370)] * 15})
    assert read("dit_step_host_s", run) == pytest.approx(0.065)
    # busy 0.045 s a forward against 0.060 s of device stretch a step
    assert read("dit_idle_share", run) == pytest.approx(25.0)
    assert read("request_host_s", run) == pytest.approx((0.03 + 0.07) / 2)
    assert read("decode_query_yield", run) == pytest.approx(95.0)


@pytest.mark.parametrize("name", NEW)
def test_readers_give_none_without_their_keys(name):
    # the parent program writes only its stage keys
    stages = {"Preprocess": 0.01, "Encode Cond": 0.07, "Diffusion Sampling": 0.3,
              "Volume Decoding": 0.4}
    parent = SimpleNamespace(timings=[dict(stages)] * 3, trace=_trace(0.6),
                             traced_counts={"dit": [(1, 3072, 1370)] * 15})
    assert read(name, parent) is None
    empty = SimpleNamespace(timings=[], trace=None, traced_counts=None)
    assert read(name, empty) is None


def test_dit_idle_share_needs_the_markers():
    # a CPU run: the spans have no device time
    run = SimpleNamespace(timings=[_request(0.8, 0.07, 0.3, 0.4, 5, 0.06)] * 2,
                          trace=_trace(0.5), traced_counts={"dit": [(1, 3072, 1370)] * 5})
    assert read("dit_idle_share", run) is None
    assert read("dit_step_host_s", run) == pytest.approx(0.06)


def test_a_traced_tiny_run_reports_them_and_counts_as_the_taps(tiny, monkeypatch):
    runs = []
    window = harness.window

    def keep(run, *args, **kwargs):
        runs.append(run)
        return window(run, *args, **kwargs)

    monkeypatch.setattr(harness, "window", keep)
    result = harness.run_cell(tiny, 2 ** 31 + 41, 0.5, True, "cpu", time.perf_counter(),
                              log=lambda *a, **k: None)
    assert result["correct"], result["checks"]
    metrics = result["metrics"]
    for name in ("dit_step_host_s", "request_host_s", "decode_query_yield"):
        assert metrics[name]["value"] > 0, name
    assert "dit_idle_share" not in metrics          # no markers on the CPU
    assert 0 < metrics["decode_query_yield"]["value"] <= 100
    (run,) = runs
    assert run.latencies and len(run.timings) == len(run.latencies)
    needed = [t["Volume Decoding/queries_needed"] for t in run.timings]
    sent = sum(t["Volume Decoding/queries_sent"] for t in run.timings)
    assert needed == [q for q, _ in run.counts["volume_decode"]]
    assert sent == sum(run.counts["geo_decode"])
    steps = tiny["traffic"]["call"]["num_inference_steps"]
    assert [t["DiT Step/n"] for t in run.timings] == [steps] * len(run.timings)
    assert sum(t["Geo Decode/n"] for t in run.timings) == len(run.counts["geo_decode"])
