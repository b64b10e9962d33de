"""No module the benchmark runs is JAX's or the JAX package's, compared by
whole top-level names (the port's name begins with the JAX package's), and
the reference imports nothing of the port."""

import ast
import os
import subprocess
import sys

import pytest

from benchmark import harness

from conftest import ROOT

BENCH = os.path.join(ROOT, "benchmark")


def imported_tops(path):
    tree = ast.parse(open(path).read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def sources(sub=""):
    for d, _, files in os.walk(os.path.join(BENCH, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_whole_top_level_names():
    assert harness.forbidden_modules(["hunyuan3d2_tpu_torch", "hunyuan3d2_tpu_torch.ops",
                                      "jaxtyping", "flax_like", "numpy"]) == []
    assert harness.forbidden_modules(["hunyuan3d2_tpu.models", "jax.numpy", "jaxlib",
                                      "flax.linen"]) == ["flax", "hunyuan3d2_tpu", "jax",
                                                         "jaxlib"]


@pytest.mark.parametrize("path", sorted(sources()), ids=lambda p: os.path.relpath(p, BENCH))
def test_no_source_imports_jax(path):
    assert not harness.forbidden_modules(imported_tops(path)), path


@pytest.mark.parametrize("path", sorted(sources("reference")),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_the_reference_imports_nothing_of_the_program(path):
    assert imported_tops(path) <= {"__future__", "math", "numpy", "torch", "PIL"}, path


def test_a_run_loads_no_jax():
    """What a run imports (the harness, every system, reference and metric
    reader, and the port they drive) leaves no JAX module loaded."""
    code = (
        "import sys, os; sys.path.insert(0, sys.argv[1])\n"
        "from benchmark import harness, control\n"
        "b = harness.load_json(os.path.join(sys.argv[1], 'BENCHMARK.json'))\n"
        "for w in b['workloads']:\n"
        "    s = harness.cell_spec(b, w['name'])\n"
        "    harness.load_file('systems', s['config']['system'])\n"
        "    harness.load_file('reference', s['config_name'])\n"
        "for m in b['end_to_end'] + b['per_layer']:\n"
        "    harness.load_file('metrics', m['name'])\n"
        "import hunyuan3d2_tpu_torch.pipelines.shapegen\n"
        "print(harness.forbidden_modules(list(sys.modules)))\n")
    proc = subprocess.run([sys.executable, "-c", code, ROOT], capture_output=True, text=True,
                          timeout=300, env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "[]"
