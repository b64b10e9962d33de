"""The reduction of a profiler trace: device time is given to the spans
open on the launching thread at each launch (by correlation id), the busy
share is the union of device intervals within the traced requests, and an
idle gap is named by the innermost span open on the host."""

import json

import pytest

from benchmark import tracing


def _x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "pid": 1,
            "args": args}


@pytest.fixture
def trace(tmp_path):
    events = [
        _x("user_annotation", "bench.request", 0, 1000),
        _x("user_annotation", "bench.dit", 10, 500),
        _x("user_annotation", "bench.attention", 100, 50),
        _x("user_annotation", "bench.geo_decode", 600, 300),
        _x("user_annotation", "other", 0, 1000),
        # launches: two in attention (inside dit), one in dit, one in decode
        _x("cuda_runtime", "cudaLaunchKernel", 110, 5, correlation=1),
        _x("cuda_driver", "cuLaunchKernelEx", 120, 5, correlation=2),
        _x("cuda_runtime", "cudaLaunchKernel", 300, 5, correlation=3),
        _x("cuda_runtime", "cudaLaunchKernel", 610, 5, correlation=4),
        _x("kernel", "flash", 130, 40, tid=7, correlation=1),
        _x("kernel", "flash", 170, 20, tid=7, correlation=2),
        _x("kernel", "gemm", 310, 100, tid=7, correlation=3),
        _x("kernel", "geo", 620, 200, tid=7, correlation=4),
        _x("gpu_memcpy", "copy", 900, 50, tid=7, correlation=99),
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return tracing.DeviceTrace(str(path))


def test_device_time_by_span(trace):
    assert trace.device_s["attention"] == pytest.approx(60e-6)
    assert trace.device_s["dit"] == pytest.approx(160e-6)
    assert trace.device_s["geo_decode"] == pytest.approx(200e-6)
    assert trace.device_s["request"] == pytest.approx(360e-6)
    assert trace.kernels["attention"] == 2 and trace.kernels["request"] == 4
    assert trace.unattributed == 1          # the copy has no launch event
    assert "other" not in trace.device_s


def test_busy_and_idle(trace):
    assert trace.window_s == pytest.approx(1000e-6)
    assert trace.busy_s == pytest.approx((60 + 100 + 200 + 50) * 1e-6)
    gaps = dict(trace.idle_gaps())
    # gaps 0-130 and 190-310 fall in dit, 410-620 and 950-1000 in the
    # request alone, 820-900 in the decode
    assert gaps == {"dit": pytest.approx(250e-6), "request": pytest.approx(260e-6),
                    "geo_decode": pytest.approx(80e-6)}
    assert sum(gaps.values()) == pytest.approx(trace.window_s - trace.busy_s)
    assert trace.top_device_ops(2) == [["geo", pytest.approx(200e-6)],
                                       ["gemm", pytest.approx(100e-6)]]


def test_patched_restores():
    class Obj:
        def f(self):
            return 1

    o = Obj()
    import types

    mod = types.SimpleNamespace(g=lambda: 2)
    with tracing.patched([(o, "f", lambda fn: lambda: fn() + 10),
                          (mod, "g", lambda fn: lambda: fn() + 20)]):
        assert o.f() == 11 and mod.g() == 22
    assert o.f() == 1 and mod.g() == 2 and "f" not in vars(o)
