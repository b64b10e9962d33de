"""python3 benchmark/control.py --workload <cell> --seeds <n> [<n> ...] [--requests k]

The readings that a cell's limits are set from (not run by the benchmark's
own runs): for each seed, the program's compared numbers on the first
``k`` requests of that seed's window (weights and inputs as a run of that
seed makes them, at the cell's sizes), and the control's: the reference in
the program's place, computed one precision below the configuration's
(``reference.run(..., precision="fp8")``), on the same requests and points.
One JSON line a seed, then one summary line: the largest program reading
and the smallest control reading of each number.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys


def readings(spec: dict, seed: int, requests: int, device: str) -> dict:
    """{"program": {number: max over requests}, "control": {...}} of one seed."""
    import torch

    from benchmark import harness

    config, traffic = spec["config"], spec["traffic"]
    os.environ.update(config.get("env", {}))
    system = harness.load_file("systems", config["system"]).System(config, seed, device)
    reference = harness.load_file("reference", spec["config_name"])
    gen = harness.load_file("generators", traffic["generator"])
    pool = [system.prepare(r) for r in gen.pool(traffic, seed, count=requests)]
    kept = []
    for i in range(requests):
        req = gen.request(traffic, pool, seed, 0, i)
        out = {}
        with system.capture(out, seed * 1000 + i, traffic["check"]):
            out["output"] = system(req)
        kept.append((req, out))
    system.close()
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    result = {"program": {}, "control": {}}
    for req, out in kept:
        ref = reference.run(config, system.weights, req, out)
        ctl = reference.run(config, system.weights, req, out, precision="fp8")
        for side, got in (("program", out), ("control", ctl)):
            for k, v in reference.compare(got, ref, req).items():
                result[side][k] = max(result[side].get(k, v), v)
    return result


def main(argv) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--requests", type=int, default=1)
    args = p.parse_args(argv)

    from benchmark import harness

    harness._set_cache_dirs()
    spec = harness.cell_spec(harness.load_json(os.path.join(harness.ROOT, "BENCHMARK.json")),
                             args.workload)
    summary = {"program_max": {}, "control_min": {}}
    for seed in args.seeds:
        r = readings(spec, seed, args.requests, "cuda")
        print(json.dumps({"seed": seed, **r}), flush=True)
        for k, v in r["program"].items():
            summary["program_max"][k] = max(summary["program_max"].get(k, v), v)
        for k, v in r["control"].items():
            summary["control_min"][k] = min(summary["control_min"].get(k, v), v)
    print(json.dumps({"seeds": len(args.seeds), **summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.exit(main(sys.argv[1:]))
