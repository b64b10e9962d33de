"""The reader of kernel 1's roofline in the DiT (``dit_attention_roofline``):
the bf16 kernel-1 kernels that ran inside the Diffusion Sampling stage,
whether each was launched on its own inside ``bench.dit`` (the eager
forward) or by one graph launch that no ``bench.attention`` span sees (a
replayed forward), against the forwards' attention work; the stage's other
kernels, and kernel 1 before or after the stage, left out."""

import json
from types import SimpleNamespace

import pytest

from benchmark import flops, harness, tracing

CFG = {"num_heads": 16, "hidden_size": 1024, "depth": 1, "depth_single_blocks": 1}
FLASH = "void (anonymous namespace)::flash::flash_bf16_kernel<64, 128, 128, 3, false, false>"


def _x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "pid": 1,
            "args": args}


def _trace(tmp_path, graph):
    """One request: DINOv2's kernel 1 (0-100 µs), the stage (100-600 µs:
    one forward, two kernel-1 calls of 40 µs and a GEMM), the decode's
    kernel 1 (700 µs on), each kernel running after its launch."""
    events = [
        _x("user_annotation", "bench.request", 0, 1000),
        _x("user_annotation", "bench.dino", 10, 80),
        _x("user_annotation", "bench.attention", 20, 20),
        _x("user_annotation", "bench.diffusion_sampling", 100, 400),
        _x("user_annotation", "bench.dit", 110, 100 if graph else 300),
        _x("user_annotation", "bench.volume_decoding", 650, 300),
        _x("cuda_runtime", "cudaLaunchKernel", 25, 2, correlation=1),
        _x("kernel", FLASH, 30, 50, tid=7, correlation=1),
        _x("cuda_runtime", "cudaLaunchKernel", 660, 2, correlation=9),
        _x("kernel", FLASH, 700, 60, tid=7, correlation=9),
    ]
    if graph:
        # one graph launch; its kernels run on past the stage span's end,
        # while the stage's scope drains the device
        events += [_x("cuda_runtime", "cudaGraphLaunch", 150, 5, correlation=5)]
        kernels = [(FLASH, 200), ("gemm", 300), (FLASH, 510)]
        events += [_x("kernel", n, ts, 40, tid=7, correlation=5) for n, ts in kernels]
    else:
        for c, (n, ts) in enumerate([(FLASH, 200), ("gemm", 300), (FLASH, 400)], start=2):
            events += [_x("cuda_runtime", "cudaLaunchKernel", ts - 50, 2, correlation=c),
                       _x("kernel", n, ts, 40, tid=7, correlation=c)]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return tracing.DeviceTrace(str(path))


@pytest.mark.parametrize("graph", [False, True])
def test_kernel_1_of_the_stage_against_the_forwards_work(tmp_path, graph):
    run = SimpleNamespace(trace=_trace(tmp_path, graph), traced_counts={"dit": [(1, 3072, 1370)]},
                          config={"dit": CFG})
    L = 3072 + 1370
    bound = 2 * flops.bound_s(flops.attention_flops(1, 16, L, L, 64),
                              flops.attention_bytes(1, 16, L, L, 64, 2), flops.PEAK_BF16)
    got = harness.load_file("metrics", "dit_attention_roofline").read(run)
    assert got == pytest.approx(100.0 * bound / 80e-6)


def test_none_without_forwards_or_trace(tmp_path):
    read = harness.load_file("metrics", "dit_attention_roofline").read
    assert read(SimpleNamespace(trace=None, traced_counts=None, config={"dit": CFG})) is None
    run = SimpleNamespace(trace=_trace(tmp_path, True), traced_counts={"dit": []},
                          config={"dit": CFG})
    assert read(run) is None
