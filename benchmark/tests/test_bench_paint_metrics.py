"""The paint cells' per-layer readers on synthetic runs: each reads its
number from the program's timings, the window's and traced requests' work
counts and the trace's device time by span as its docstring says, and
reads nothing (None) where the run holds nothing for it: the program's
counters absent (a parent without them), no trace, no markers."""

import os
import types

import pytest
from conftest import ROOT

from benchmark import flops, harness, paint_flops

def _read(name, run):
    return harness.load_file("metrics", name).read(run)


def _run(timings=(), counts=None, traced=None, device_s=None):
    run = harness.Run(harness.load_json(os.path.join(ROOT, "benchmark", "configs",
                                                     "paint_turbo.json")), {})
    run.timings = list(timings)
    run.counts = counts
    run.traced_counts = traced
    run.trace = None if device_s is None else types.SimpleNamespace(device_s=dict(device_s))
    return run


def test_stage_means():
    t = [{"Multiview Diffusion (device)": 1.0, "UV Unwrap (wait)": 0.5,
          "Bake Geometry (device)": 0.1, "Texture Baking (device)": 0.2, "Texture Inpaint": 0.3},
         {"Multiview Diffusion (device)": 2.0, "UV Unwrap (wait)": 0.0,
          "Bake Geometry (device)": 0.2, "Texture Baking (device)": 0.2, "Texture Inpaint": 0.5}]
    run = _run(t)
    assert _read("paint_diffusion_s", run) == pytest.approx(1.5)
    assert _read("unwrap_wait_s", run) == pytest.approx(0.25)
    assert _read("bake_inpaint_s", run) == pytest.approx(0.75)
    for name in ("paint_diffusion_s", "unwrap_wait_s", "bake_inpaint_s", "paint_step_host_s"):
        assert _read(name, _run()) is None
    assert _read("bake_inpaint_s", _run([{"Texture Inpaint": 0.3}])) is None


def test_step_host_seconds_and_idle_share():
    t = [{"Paint Step": 0.5, "Paint Step/n": 10, "Paint Step/device_s": 1.0},
         {"Paint Step": 0.7, "Paint Step/n": 10, "Paint Step/device_s": 1.2}]
    assert _read("paint_step_host_s", _run(t)) == pytest.approx(0.06)
    run = _run(t, traced={"unet_r": [(1, 6, 64, 64)] * 20}, device_s={"paint_unet": 1.65})
    # busy 0.0825 s a pass against a 0.11 s stretch a step
    assert _read("paint_idle_share", run) == pytest.approx(25.0)
    assert _read("paint_idle_share", _run(t)) is None                       # no trace
    no_markers = [{"Paint Step": 0.5, "Paint Step/n": 10}]
    assert _read("paint_idle_share", _run(no_markers, traced={"unet_r": [(1, 6, 64, 64)]},
                                          device_s={"paint_unet": 1.0})) is None


def test_mfu_of_the_diffusion_stage():
    counts = {"unet_r": [(1, 6, 64, 64)] * 10, "unet_w": [(1, 1, 64, 64)],
              "vae_encode": [(1, 512, 512), (6, 512, 512), (6, 512, 512)],
              "vae_decode": [(1, 64, 64)] * 6}
    t = [{"Multiview Diffusion (device)": 1.25}, {"Multiview Diffusion (device)": 1.25}]
    run = _run(t, counts={k: v * 2 for k, v in counts.items()})
    work = 2 * paint_flops.diffusion_flops(run.config, counts)
    assert _read("mfu_paint_diffusion", run) == pytest.approx(100 * work / 2.5 / flops.PEAK_BF16)
    assert _read("mfu_paint_diffusion", _run(t)) is None
    assert _read("mfu_paint_diffusion", _run(t, counts={"unet_r": []})) is None


def test_paint_attention_roofline():
    calls = [(6, 5, 4096, 4096, 64, "bfloat16"), (1, 5, 24576, 24576, 64, "bfloat16"),
             (6, 5, 4096, 77, 64, "bfloat16")]
    bound = sum(flops.bound_s(flops.attention_flops(b, h, lq, lk, d),
                              flops.attention_bytes(b, h, lq, lk, d, 2), flops.PEAK_BF16)
                for b, h, lq, lk, d, _ in calls)
    run = _run(traced={"attention": calls}, device_s={"attention": 4 * bound})
    assert _read("paint_attention_roofline", run) == pytest.approx(25.0)
    assert _read("paint_attention_roofline", _run(traced={"attention": calls})) is None
    assert _read("paint_attention_roofline", _run(traced={"attention": []},
                                                  device_s={"attention": 1.0})) is None


def test_masked_attention_roofline_reads_the_programs_pair_counters():
    live, calls = 2_000_000, 5 * 10           # a request: 5 calls a forward, 10 forwards
    b, h, lq, d = 1, 10, 6144, 64
    timings = [{f"Multiview Diffusion/mva_pairs_live/{lq}": live * calls,
                f"Multiview Diffusion/mva_pairs_masked_total/{lq}": lq * lq * calls}] * 2
    traced = {"masked_attention": [(b, h, lq, lq, d, "bfloat16")] * 2 * calls,
              "timings": timings}
    per_call = max(4.0 * h * d * live / flops.PEAK_BF16,
                   (flops.attention_bytes(b, h, lq, lq, d, 2) + lq * lq) / flops.HBM_BYTES_PER_S)
    run = _run(traced=traced, device_s={"masked_attention": 2 * calls * per_call * 10})
    assert _read("masked_attention_roofline", run) == pytest.approx(10.0)
    # the bytes bind at this density: q, k, v, o and the mask, once a call
    assert per_call == (flops.attention_bytes(b, h, lq, lq, d, 2) + lq * lq) / flops.HBM_BYTES_PER_S
    parent = {"masked_attention": traced["masked_attention"], "timings": [{}, {}]}
    assert _read("masked_attention_roofline", _run(traced=parent,
                                                   device_s={"masked_attention": 1.0})) is None
    assert _read("masked_attention_roofline", _run(traced=traced)) is None
    assert _read("masked_attention_roofline",
                 _run(traced={"masked_attention": [], "timings": timings},
                      device_s={"masked_attention": 1.0})) is None
