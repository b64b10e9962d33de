"""BENCHMARK.json against its format rules, and discovery by name:
every cell, configuration, traffic mix, generator, loop and metric is found
as a file; a cell and a metric, and a configuration with its own
generator and loop, are added as files alone; the check draws from the
whole window."""

import contextlib
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest
from conftest import ROOT, traffic_file

from benchmark import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def bench():
    return harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))


def test_benchmark_json_keeps_its_format():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert b["command"] == ["python3", "benchmark/run.py"] and b["paths"] == ["benchmark"]
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    assert len(json.dumps(b)) < 64 * 1024
    configs = {c["name"]: c for c in b["configs"]}
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert c["file"].startswith("benchmark/") and os.path.isfile(os.path.join(ROOT, c["file"]))
        assert any(w["config"] == c["name"] for w in b["workloads"])
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    pairs = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and NAME.match(w["name"])
        assert w["config"] in configs and w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names))
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e and m["source"] in SOURCES
        assert not m["name"].endswith("roofline") or m["unit"] == "%"
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                                                     "higher")
        assert set(m.get("workloads", [])) <= {w["name"] for w in b["workloads"]}
    for w in b["workloads"]:
        reported = [m for m in b["end_to_end"] if w["name"] in m.get("workloads", [w["name"]])]
        assert any(m["name"] == "setup_s" for m in reported) and len(reported) >= 2
        assert any(w["name"] in m.get("workloads", [w["name"]]) for m in b["per_layer"])


def test_every_name_is_found_as_a_file():
    b = bench()
    for w in b["workloads"]:
        spec = harness.cell_spec(b, w["name"])
        assert spec["traffic"] == traffic_file(w["traffic"])
        assert spec["config"]["name"] == w["config"]
        system = harness.load_file("systems", spec["config"]["system"])
        reference = harness.load_file("reference", w["config"])
        gen = harness.load_file("generators", spec["traffic"]["generator"])
        loop = harness.load_file("loops", spec["traffic"]["loop"])
        assert hasattr(system, "System") and callable(reference.run)
        assert callable(gen.pool) and callable(gen.request) and callable(loop.window)
        assert set(reference.LIMITS) >= {"mesh_faults"}
    for m in b["end_to_end"] + b["per_layer"]:
        assert callable(harness.load_file("metrics", m["name"]).read)


def _copy(tmp_path, monkeypatch):
    """A copy of the benchmark that the harness reads instead of this one."""
    copy = tmp_path / "benchmark"
    shutil.copytree(os.path.join(ROOT, "benchmark"), copy,
                    ignore=shutil.ignore_patterns("__pycache__"))
    monkeypatch.setattr(harness, "HERE", str(copy))
    monkeypatch.setattr(harness, "ROOT", str(tmp_path))
    return copy


def test_a_cell_and_a_metric_are_added_as_files_alone(tmp_path, monkeypatch, tiny):
    """A copy of the benchmark gains a traffic mix and a metric reader as
    files, and BENCHMARK.json an entry for each; the harness, unedited,
    runs the new cell and reports the new metric."""
    copy = _copy(tmp_path, monkeypatch)
    traffic = dict(tiny["traffic"], call=dict(tiny["traffic"]["call"], octree_resolution=24))
    (copy / "traffic" / "oct24.json").write_text(json.dumps(traffic))
    (copy / "metrics" / "requests_done.py").write_text(
        "def read(run):\n    return float(len(run.latencies))\n")
    b = bench()
    b["workloads"].append({"name": "v20fast.oct24", "config": "v20fast", "traffic": "oct24",
                           "chips": 1, "why": "a cell added as files"})
    b["end_to_end"].append({"name": "requests_done", "unit": "requests", "better": "higher",
                            "bound": 0.05, "source": "host_clock"})
    spec = harness.cell_spec(b, "v20fast.oct24")
    spec["config"] = tiny["config"]
    assert spec["traffic"]["call"]["octree_resolution"] == 24
    result = harness.run_cell(spec, 2 ** 31 + 11, 0.5, False, "cpu", time.perf_counter(),
                              log=lambda *a, **k: None)
    assert result["correct"], result["checks"]
    assert result["metrics"]["requests_done"]["value"] == result["attempted"] >= 1


# A configuration of another shape than v20fast's, as a later PR would add
# it: its system, plain reference, input generator and loop are new files.
TOY_SYSTEM = """
import contextlib, time
import torch

class System:
    def __init__(self, config, seed, device):
        gen = torch.Generator(device=device).manual_seed(seed)
        n = config["width"]
        self.weights = {"w": torch.randn(n, n, generator=gen, device=device) / n ** 0.5}
        self.times = {}

    @staticmethod
    def prepare(request):
        return {**request, "x": torch.as_tensor(request["vector"])}

    def __call__(self, request):
        t = time.perf_counter()
        y = torch.tanh(self.weights["w"] @ request["x"]) * (1 + request["shift"])
        self.times = {"Apply": time.perf_counter() - t}
        return y

    def timings(self):
        return dict(self.times)

    def instrument(self, counts, spans):
        return contextlib.nullcontext()

    @contextlib.contextmanager
    def capture(self, out, seed, check):
        yield out

    def close(self):
        pass
"""
TOY_REFERENCE = """
import numpy as np

LIMITS = {"y_err": 1e-5}

def run(config, W, request, kept, precision="fp64"):
    w = W["w"].double().numpy()
    return {"y": np.tanh(w @ np.asarray(request["vector"], np.float64)) * (1 + request["shift"])}

def compare(out, ref, request):
    y = out["output"].double().numpy()
    return {"y_err": float(np.abs(y - ref["y"]).max() / np.abs(ref["y"]).max())}
"""
TOY_GENERATOR = """
import numpy as np

def pool(traffic, seed, stream=0, count=None):
    rng = np.random.default_rng([seed, stream])
    return [{"vector": rng.standard_normal(traffic["width"]).astype(np.float32)}
            for _ in range(traffic["pool"] if count is None else count)]

def request(traffic, pool, seed, stream, i):
    shift = float(np.random.default_rng([seed, stream, i]).random())
    return {**pool[i % len(pool)], "shift": shift}
"""
# an open loop: arrivals at a fixed rate, latency from the arrival
TOY_LOOP = """
import time

def window(run, system, request, seconds, sample, sync, log):
    rate = run.traffic["rate"]
    start = time.perf_counter()
    i = 0
    while i / rate < seconds:
        arrival = start + i / rate
        while time.perf_counter() < arrival:
            pass
        req, kept = request(i), {}
        with sample.capture(system, i, kept):
            kept["output"] = system(req)
        sync()
        sample.keep(i, req, kept)
        run.latencies.append(time.perf_counter() - arrival)
        run.timings.append(system.timings())
        i += 1
    run.window_s = time.perf_counter() - start
    return 0
"""


def test_a_configuration_with_its_own_generator_and_loop_is_added_as_files_alone(
        tmp_path, monkeypatch):
    """A configuration whose requests are not images (a system, its plain
    reference, an input generator and an open loop, each a new file) runs
    through the unedited harness; the reference reads what the system kept
    without the harness naming any of it, and a wrong answer is caught."""
    copy = _copy(tmp_path, monkeypatch)
    for kind, name, text in (("systems", "toy", TOY_SYSTEM), ("reference", "toy", TOY_REFERENCE),
                             ("generators", "vectors", TOY_GENERATOR),
                             ("loops", "open_rate", TOY_LOOP)):
        (copy / kind / (name + ".py")).write_text(text)
    (copy / "configs" / "toy.json").write_text(json.dumps({"name": "toy", "system": "toy",
                                                           "width": 32}))
    (copy / "traffic" / "rate200.json").write_text(json.dumps(
        {"generator": "vectors", "loop": "open_rate", "rate": 200, "width": 32, "pool": 4,
         "check": {"requests": 3}, "trace": {"requests": 1}}))
    b = bench()
    b["configs"].append({"name": "toy", "source": "https://example.org", "reduced": [],
                         "file": "benchmark/configs/toy.json", "why": "a configuration as files"})
    b["workloads"].append({"name": "toy.rate200", "config": "toy", "traffic": "rate200",
                           "chips": 1, "why": "an open loop as files"})
    spec = harness.cell_spec(b, "toy.rate200")
    result = harness.run_cell(spec, 2 ** 31 + 5, 0.2, False, "cpu", time.perf_counter(),
                              log=lambda *a, **k: None)
    assert result["correct"], result["checks"]
    assert result["attempted"] == 40 and result["metrics"]["request_s"]["value"] > 0
    (copy / "systems" / "toy.py").write_text(TOY_SYSTEM.replace("(1 + request", "(1.01 + request"))
    result = harness.run_cell(spec, 2 ** 31 + 5, 0.2, False, "cpu", time.perf_counter(),
                              log=lambda *a, **k: None)
    assert result["correct"] is False and result["checks"]["y_err"]["value"] > 1e-3


@pytest.mark.parametrize("window", [2, 3, 10, 200])
def test_the_check_draws_from_the_whole_window(window):
    """The requests the check recomputes are a uniform draw from the whole
    window (reservoir sampling), the same for the same seed, and only the
    drawn requests pay for the capture."""

    class System:
        captured = 0

        @contextlib.contextmanager
        def capture(self, out, seed, check):
            System.captured += 1
            yield out

    def kept(seed):
        sample = harness.Sample(3, seed, {})
        for i in range(window):
            out = {}
            with sample.capture(System(), i, out):
                pass
            sample.keep(i, {"i": i}, out)
        return [i for i, _, _ in sample.kept]

    assert kept(2 ** 31 + 1) == kept(2 ** 31 + 1)
    assert len(kept(5)) == min(3, window) and len(set(kept(5))) == len(kept(5))
    draws = [i for seed in range(300) for i in kept(seed)]
    if window == 200:
        # each third of the window holds about a third of the draws
        thirds = np.bincount(np.asarray(draws) * 3 // window, minlength=3) / len(draws)
        assert np.all(np.abs(thirds - 1 / 3) < 0.06), thirds
        assert System.captured < 301 * 3 * (1 + np.log(window / 3))


def test_run_exits_nonzero_without_a_card():
    """No CUDA device: the command fails and prints no result."""
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "v20fast.oct380",
                           "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                          capture_output=True, text=True, timeout=300,
                          env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "CUDA device" in proc.stderr

