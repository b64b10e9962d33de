"""The port's observability helpers (utils/profiling.py, utils/counters.py,
utils/debug.py) and the voxel hierarchy (geometry/voxel_hierarchy.py)
against the JAX package's, on the CPU. The CUDA side of
``device_memory_stats`` is a card test (tests/test_torch_cuda.py)."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hunyuan3d2_tpu.geometry import voxel_hierarchy as jvox
from hunyuan3d2_tpu.utils import counters as jcounters
from hunyuan3d2_tpu.utils import debug as jdebug
from hunyuan3d2_tpu_torch.geometry import voxel_hierarchy as tvox
from hunyuan3d2_tpu_torch.utils import counters, debug, profiling


def test_trace_writes_a_trace_with_the_annotated_span(tmp_path):
    with profiling.trace(str(tmp_path / "tr")) as t:
        with profiling.annotate("hy3d_loss_span"):
            (torch.randn(64, 64) @ torch.randn(64, 64)).sum()
    assert t.path and os.path.dirname(t.path) == str(tmp_path / "tr")
    with open(t.path) as fh:
        events = json.load(fh)["traceEvents"]
    spans = [e for e in events if e.get("name") == "hy3d_loss_span"]
    assert spans and spans[0].get("cat") == "user_annotation" and spans[0]["dur"] > 0
    assert any(e.get("name") == "aten::mm" for e in events)
    assert t.profile.key_averages() is not None
    # the CPU has no device operations: an empty top list, no busy time
    assert profiling.top_device_ops(t.path) == []
    busy = profiling.device_busy(t.path)
    assert busy["busy_ms"] == 0 and busy["span_ms"] > 0


def test_top_device_ops_and_busy_time_from_a_trace(tmp_path):
    """Device events as a CUDA trace writes them: summed by name, largest
    first; overlapping intervals counted once."""
    path = tmp_path / "t.json"
    ev = [{"ph": "X", "cat": "kernel", "name": "a", "ts": 0, "dur": 100},
          {"ph": "X", "cat": "kernel", "name": "b", "ts": 50, "dur": 100},
          {"ph": "X", "cat": "gpu_memset", "name": "m", "ts": 300, "dur": 10},
          {"ph": "X", "cat": "kernel", "name": "a", "ts": 400, "dur": 200},
          {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0, "dur": 1000}]
    path.write_text(json.dumps({"traceEvents": ev}))
    top = profiling.top_device_ops(str(path), n=2)
    assert [(r["name"], r["calls"]) for r in top] == [("a", 2), ("b", 1)]
    assert [r["ms"] for r in top] == [pytest.approx(0.3), pytest.approx(0.1)]
    busy = profiling.device_busy(str(path))
    assert busy == {"busy_ms": pytest.approx(0.36), "span_ms": pytest.approx(1.0)}


def test_device_memory_stats_is_empty_without_device_stats():
    assert profiling.device_memory_stats("cpu") == {}
    if not torch.cuda.is_available():
        assert profiling.device_memory_stats() == {}


def test_running_stats_match():
    values = [3.0, -1.5, 2.25, 10.0, 0.0]
    a, b = counters.RunningStats(), jcounters.RunningStats()
    assert a.as_dict() == b.as_dict() and repr(a) == repr(b)
    for x in values:
        a.append(x)
        b.append(np.float32(x))
        assert a.as_dict() == b.as_dict() and repr(a) == repr(b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tensor_stats_and_output_var_match(dtype, capsys, monkeypatch):
    arr = np.random.RandomState(0).randn(3, 5, 7).astype(np.float32)
    if dtype == "bfloat16":
        ref_x = jnp.asarray(arr, jnp.bfloat16)
        x = torch.from_numpy(arr).bfloat16()
    else:
        ref_x = arr
        x = torch.from_numpy(arr)
    assert debug.tensor_stats(x) == jdebug.tensor_stats(ref_x)
    assert debug.tensor_stats(x.requires_grad_(dtype == "float32")) == jdebug.tensor_stats(ref_x)
    assert debug.tensor_stats(np.zeros(0)) == jdebug.tensor_stats(np.zeros(0))
    monkeypatch.delenv("HY3DGEN_DEBUG", raising=False)
    assert debug.output_var("t", x) is None and capsys.readouterr().out == ""
    monkeypatch.setenv("HY3DGEN_DEBUG", "1")
    assert debug.output_var("t", x) == jdebug.output_var("t", ref_x)
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 2 and lines[0] == lines[1] and lines[0].startswith("tensor [t] size:")
    monkeypatch.delenv("HY3DGEN_DEBUG")
    assert debug.output_var("t", x, force=True) == jdebug.output_var("t", ref_x, force=True)


def _levels_equal(a, b):
    assert len(a) == len(b)
    for la, lb in zip(a, b):
        assert la.resolution == lb.resolution
        for f in ("keys", "positions", "normals", "features", "parent", "neighbors"):
            x, y = getattr(la, f), getattr(lb, f)
            assert (x is None) == (y is None), f
            if x is not None:
                assert x.dtype == y.dtype, f
                np.testing.assert_array_equal(x, y, err_msg=f)


def test_voxel_hierarchy_matches_on_random_points():
    rs = np.random.RandomState(1)
    v = rs.randn(5000, 3)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    pos = (v * 0.4 + 0.5).astype(np.float32)
    feat = rs.rand(5000, 4).astype(np.float32)
    for kw in (dict(normals=v.astype(np.float32), resolution=64, num_levels=3),
               dict(normals=v.astype(np.float32), features=feat, resolution=32, num_levels=6),
               dict(resolution=4, num_levels=1)):
        _levels_equal(tvox.build_hierarchy(pos, **kw), jvox.build_hierarchy(pos, **kw))
    _levels_equal(tvox.build_hierarchy_with_feat(pos, v, feat, 16, 2),
                  jvox.build_hierarchy_with_feat(pos, v, feat, 16, 2))
    keys = tvox.pos2key(pos, 64)
    np.testing.assert_array_equal(keys, jvox.pos2key(pos, 64))
    np.testing.assert_array_equal(tvox.key2pos(keys, 64), jvox.key2pos(keys, 64))


def test_voxel_hierarchy_levels_parents_and_neighbours():
    """tests/test_voxel_hierarchy.py's checks on the port."""
    rs = np.random.RandomState(0)
    pos = rs.rand(100, 3).astype(np.float32)
    assert np.abs(tvox.key2pos(tvox.pos2key(pos, 64), 64) - pos).max() <= 1.0 / 64
    v = np.random.RandomState(1).randn(5000, 3)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    levels = tvox.build_hierarchy((v * 0.4 + 0.5).astype(np.float32),
                                  normals=v.astype(np.float32), resolution=64, num_levels=3)
    assert [lv.resolution for lv in levels] == [64, 32, 16]
    assert len(levels[0].keys) > len(levels[1].keys) > len(levels[2].keys)
    for lo, hi in zip(levels[:-1], levels[1:]):
        assert (lo.parent >= 0).all()
        np.testing.assert_array_equal(hi.keys[lo.parent], tvox.pos2key(lo.positions,
                                                                       hi.resolution))
    np.testing.assert_allclose(np.linalg.norm(levels[0].normals, axis=1), 1.0, atol=1e-5)
    nb = tvox.build_hierarchy(np.array([[0.1, 0.1, 0.1], [0.1, 0.1, 0.35], [0.9, 0.9, 0.9]],
                                       np.float32), resolution=4, num_levels=1)[0].neighbors
    assert nb[0, 4] == 1 and nb[1, 5] == 0 and (nb[2] == -1).all()
