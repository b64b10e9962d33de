"""One run of one cell: set-up, the measured window, the traced requests
(``--trace 1``), the check against the plain reference, and the result line.

The cell (``BENCHMARK.json`` ``workloads``) names a configuration and a
traffic mix. The configuration names its system (``systems/<system>.py``)
and has its reference (``reference/<config>.py``); the traffic mix
(``traffic/<name>.json``) names its generator (``generators/<name>.py``)
and its loop (``loops/<name>.py``); each metric is read by
``metrics/<metric>.py``. Nothing here knows a configuration, a traffic mix,
a generator, a loop or a metric by name.

A traffic file holds ``generator`` and ``loop``, the generator's own
parameters, ``check`` (``requests``: how many of the window's requests the
reference recomputes, drawn from the whole window; the rest is the
system's: what its ``capture`` keeps) and ``trace`` (``requests``: how many
the ``--trace 1`` run traces).
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import importlib.util
import json
import os
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "hunyuan3d2_tpu")


def forbidden_modules(names) -> list:
    """The module names among ``names`` whose top-level name (the part
    before the first dot), compared whole, is JAX's or the JAX package's."""
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))


def load_file(kind: str, name: str):
    """The module ``<kind>/<name>.py`` of the benchmark, loaded by path."""
    path = os.path.join(HERE, kind, name + ".py")
    spec = importlib.util.spec_from_file_location(f"benchmark_{kind}_{name}".replace(".", "_"),
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def cell_spec(bench: dict, workload: str) -> dict:
    """What one cell runs: its entry, configuration (name and dict),
    traffic, and the metrics it reports with ``--trace 0`` and ``1``."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json: {sorted(cells)}")
    cell = cells[workload]
    config = {c["name"]: c for c in bench["configs"]}[cell["config"]]

    def reported(metrics):
        return [m for m in metrics if workload in m.get("workloads", [workload])]

    return {"cell": cell, "config_name": config["name"],
            "config": load_json(os.path.join(ROOT, config["file"])),
            "traffic": load_json(os.path.join(HERE, "traffic", cell["traffic"] + ".json")),
            "metrics": {0: reported(bench["end_to_end"]), 1: reported(bench["per_layer"])}}


class Run:
    """What the metric readers read (``metrics/<name>.py`` ``read(run)``)."""

    def __init__(self, config: dict, traffic: dict):
        self.config = config
        self.traffic = traffic
        self.setup_s = None          # process start to the first timed request
        self.window_s = None         # the window's wall time
        self.latencies = []          # each window request's seconds
        self.timings = []            # each window request's program stage times
        self.counts = None           # the window's work by layer (--trace 1)
        self.window_peak_bytes = None
        self.trace = None            # tracing.DeviceTrace of the traced requests
        self.traced_counts = None    # the traced requests' work by layer


class Sample:
    """The requests that the check recomputes: ``k`` drawn from the seed,
    uniformly from the whole window, whose length is not known before it
    closes (reservoir sampling). Whether request i is kept is drawn before
    it runs, so that only the kept requests pay for the capture; a kept
    request that a later one replaces is dropped, so at most ``k + 1`` are
    held at a time."""

    def __init__(self, k: int, seed: int, check: dict):
        self.k, self.seed, self.check = k, seed, check
        self.rng = np.random.default_rng([seed, 2])
        self.slots = {}
        self.slot = None

    def capture(self, system, i: int, out: dict):
        """The system's capture into ``out`` if request ``i`` is drawn."""
        self.slot = i if i < self.k else int(self.rng.integers(0, i + 1))
        if self.slot >= self.k:
            self.slot = None
            return contextlib.nullcontext()
        return system.capture(out, self.seed * 1000 + i, self.check)

    def keep(self, i: int, request: dict, out: dict):
        if self.slot is not None:
            self.slots[self.slot] = (i, request, out)

    @property
    def kept(self) -> list:
        """[(window index, request, what the capture kept)] by index."""
        return sorted(self.slots.values(), key=lambda t: t[0])


def run_cell(spec: dict, seed: int, seconds: float, trace: bool, device: str, t0: float,
             log=print) -> dict:
    """Run the cell of ``spec`` once on ``device``; returns the result dict
    (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
    ``breakdown`` with ``trace``, ``checks``)."""
    import torch

    config, traffic = spec["config"], spec["traffic"]
    os.environ.update(config.get("env", {}))
    reference = load_file("reference", spec["config_name"])
    gen = load_file("generators", traffic["generator"])
    cuda = torch.device(device).type == "cuda"
    run = Run(config, traffic)
    system, pool = set_up(spec, gen, seed, device, t0, log)
    setup_peak = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    run.setup_s = time.perf_counter() - t0

    sample = Sample(traffic["check"]["requests"], seed, traffic["check"])
    failed = window(run, system, lambda i: gen.request(traffic, pool, seed, 0, i), seconds,
                    sample, trace, cuda, log)
    run.window_peak_bytes = torch.cuda.max_memory_allocated() if cuda else 0
    result = {"correct": None, "attempted": len(run.latencies), "failed": failed}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name() if cuda else "cpu",
           "count": spec["cell"]["chips"],
           "memory_peak_bytes": max(setup_peak, run.window_peak_bytes)}
    if trace:
        run.traced_counts, run.trace = traced_requests(
            system, lambda j: gen.request(traffic, pool, seed, 2, j),
            traffic["trace"]["requests"], cuda)
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
        result["breakdown"] = {"device_ops": run.trace.top_device_ops(),
                               "idle_gaps": run.trace.idle_gaps()}
        log(f"trace: device seconds by span {dict(run.trace.device_s)}, kernels by span "
            f"{dict(run.trace.kernels)}, {run.trace.unattributed} device operations with no "
            f"launch on the main thread; traced requests "
            f"{' '.join(f'{x:.4f}' for x in run.trace.request_s)} s against the window's "
            f"{run.window_s / max(len(run.latencies), 1):.4f} s a request", file=sys.stderr)
    metrics = {}
    for m in spec["metrics"][int(trace)]:
        value = load_file("metrics", m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result["metrics"] = metrics
    result["device"] = dev

    # the check, once the program's state is freed
    system.close()
    del pool
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    numbers = {}
    checked = sample.kept
    log(f"check: window requests {[i for i, _, _ in checked]} of {len(run.latencies)}",
        file=sys.stderr)
    for _, req, kept in checked:
        ref = reference.run(config, system.weights, req, kept)
        for k, v in reference.compare(kept, ref, req).items():
            numbers[k] = max(numbers.get(k, v), v)
    limits = reference.LIMITS
    if not checked:
        log("no request the check drew completed in the window", file=sys.stderr)
    result["correct"] = bool(checked) and failed == 0 and all(
        numbers[k] <= limits[k] for k in limits)
    result["checks"] = {k: {"value": numbers.get(k), "limit": limits[k]} for k in limits}
    return result


def set_up(spec: dict, gen, seed: int, device: str, t0: float, log):
    """The system with its weights, the pool of inputs (as the system
    prepares them), and one cold and one warm call of the cell's shapes (on
    requests of their own); logs the set-up's parts."""
    import torch

    traffic = spec["traffic"]
    cuda = torch.device(device).type == "cuda"
    marks = [("imports", time.perf_counter())]
    system = load_file("systems", spec["config"]["system"]).System(spec["config"], seed, device)
    if cuda:
        torch.cuda.synchronize()
    marks.append(("weights", time.perf_counter()))
    pool = [system.prepare(r) for r in gen.pool(traffic, seed)]
    warm = [system.prepare(r) for r in gen.pool(traffic, seed, stream=1, count=2)]
    marks.append(("inputs", time.perf_counter()))
    for j, name in enumerate(("cold call", "warm call")):
        system(gen.request(traffic, warm, seed, 1, j))
        if cuda:
            torch.cuda.synchronize()
        marks.append((name, time.perf_counter()))
    log("setup: " + ", ".join(f"{name} {b - a:.3f} s" for (_, a), (name, b) in
                              zip([("start", t0)] + marks, marks)), file=sys.stderr)
    return system, pool


def window(run: Run, system, request, seconds: float, sample: Sample, trace: bool, cuda: bool,
           log) -> int:
    """The measured window, run by the traffic's loop (``loops/<loop>.py``)
    with the layers' work counts on (no spans) where ``trace``; returns the
    failed requests."""
    import torch

    loop = load_file("loops", run.traffic["loop"])
    run.counts = {} if trace else None
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    with system.instrument(run.counts, spans=False) if trace else contextlib.nullcontext():
        failed = loop.window(run, system, request, seconds, sample, sync, log)
    lat = np.asarray(run.latencies)
    if lat.size:
        log(f"window: {lat.size} requests in {run.window_s:.4f} s; latency min "
            f"{lat.min():.4f} median {np.median(lat):.4f} max {lat.max():.4f} s; first three "
            f"{' '.join(f'{x:.4f}' for x in lat[:3])}", file=sys.stderr)
    return failed


def traced_requests(system, request, n: int, cuda: bool):
    """Trace ``n`` requests, ``request(1)`` to ``request(n)``, after
    ``request(0)`` warms the profiler, with the layers' spans and counts on;
    returns (the traced requests' counts, the reduced trace). The trace file
    is written under the temporary directory and deleted once read."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function, schedule

    from benchmark import tracing

    path = os.path.join(tempfile.gettempdir(), f"bench_trace_{os.getpid()}.json")
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    counts = {}
    try:
        with system.instrument(counts, spans=True), profile(
                activities=activities, schedule=schedule(wait=0, warmup=1, active=n),
                on_trace_ready=lambda p: p.export_chrome_trace(path)) as prof:
            for j in range(n + 1):
                if j == 1:
                    for v in counts.values():
                        v.clear()
                req = request(j)
                with record_function(tracing.SPAN_PREFIX + "request"):
                    system(req)
                    if cuda:
                        torch.cuda.synchronize()
                prof.step()
        return counts, tracing.DeviceTrace(path)
    finally:
        with contextlib.suppress(FileNotFoundError):
            os.remove(path)


def _set_cache_dirs():
    """Every build and kernel cache at a fixed path inside the checkout."""
    cache = os.path.join(ROOT, "build", "benchmark_cache")
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(cache, "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(cache, "torch_extensions"))
    os.environ.setdefault("CUDA_CACHE_PATH", os.path.join(cache, "cuda"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_TF"] = "0"


def main(argv, t0: float) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _set_cache_dirs()
    spec = cell_spec(load_json(os.path.join(ROOT, "BENCHMARK.json")), args.workload)

    import torch

    chips = spec["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    result = run_cell(spec, args.seed, args.seconds, bool(args.trace), "cuda", t0)
    loaded = forbidden_modules(list(sys.modules))
    if loaded:
        print(f"the process loaded {loaded}: the benchmark runs the port alone", file=sys.stderr)
        return 3
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
