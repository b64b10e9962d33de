"""Shared pieces of the benchmark's CPU tests: the repository root on the
import path, and a TINY cut of a cell that the harness runs on the CPU."""

import copy
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


@pytest.fixture(autouse=True)
def _few_threads():
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def traffic_file(name: str) -> dict:
    """The traffic file ``benchmark/traffic/<name>.json``."""
    from benchmark import harness

    return harness.load_json(os.path.join(ROOT, "benchmark", "traffic", name + ".json"))


def tiny_spec(workload: str = "v20fast.oct380") -> dict:
    """``harness.cell_spec`` of ``workload``, cut to a size the CPU runs in
    seconds: the widths and depths of the port's TINY presets, octree 32,
    two steps, a pool of three requests."""
    from benchmark import harness

    spec = harness.cell_spec(harness.load_json(os.path.join(ROOT, "BENCHMARK.json")), workload)
    spec = copy.deepcopy(spec)
    cfg, traffic = spec["config"], spec["traffic"]
    cfg["dino"].update(num_layers=2, image_size=112, swiglu_hidden=256)
    cfg["dit"].update(hidden_size=128, num_heads=4, depth=2, depth_single_blocks=2)
    cfg["vae"].update(num_latents=64, width=128, heads=4, num_decoder_layers=2)
    traffic["call"].update(octree_resolution=32, num_inference_steps=2)
    traffic["pool"] = 3
    traffic["check"].update(requests=2, points_per_call=64)
    traffic["trace"]["requests"] = 1
    return spec


@pytest.fixture
def tiny():
    return tiny_spec()
