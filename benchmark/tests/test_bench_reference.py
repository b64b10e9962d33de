"""The plain reference against the port at TINY size on the CPU: a run of
the harness is correct with room under every limit, and the control (the
reference one precision below, fp8, in the program's place) fails one of
them."""

import time

import pytest

from benchmark import control, harness

SEEDS = [2 ** 31 + 101, 3_000_000_007]


@pytest.mark.parametrize("seed", SEEDS)
def test_the_port_matches_the_reference(tiny, seed):
    result = harness.run_cell(tiny, seed, 0.5, False, "cpu", time.perf_counter(),
                              log=lambda *a, **k: None)
    assert result["correct"], result["checks"]
    checks = result["checks"]
    for name in ("cond_err", "latents_err", "logits_err"):
        assert checks[name]["value"] < checks[name]["limit"] / 2, (name, checks[name])
    assert result["attempted"] >= 1 and result["failed"] == 0


@pytest.mark.parametrize("seed", SEEDS)
def test_the_control_fails(tiny, seed):
    limits = harness.load_file("reference", tiny["config_name"]).LIMITS
    r = control.readings(tiny, seed, 1, "cpu")
    assert all(r["program"][k] <= limits[k] for k in r["program"]), r
    assert any(r["control"][k] > limits[k] for k in r["control"]), r
