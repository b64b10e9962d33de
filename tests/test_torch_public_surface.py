"""The port's public surface against the JAX package's: the
package's top-level names, ``synchronize_timer``, constructors and
``**kwargs`` of the entry points, ``compile()``, ``prepare_image(image,
mask)`` and ``from_pretrained(..., dtype=...)``."""

import inspect
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import hunyuan3d2_tpu
import hunyuan3d2_tpu_torch
from hunyuan3d2_tpu.geometry.render import MeshRender as JRender
from hunyuan3d2_tpu.pipelines.hunyuanpaint import HunyuanPaintPipeline as JInner
from hunyuan3d2_tpu.pipelines.shapegen import Hunyuan3DDiTFlowMatchingPipeline as JPipe
from hunyuan3d2_tpu.pipelines.texgen import Hunyuan3DPaintPipeline as JPaint
from hunyuan3d2_tpu_torch.geometry.render import MeshRender
from hunyuan3d2_tpu_torch.io import checkpoints
from hunyuan3d2_tpu_torch.pipelines.hunyuanpaint import HunyuanPaintPipeline
from hunyuan3d2_tpu_torch.pipelines.shapegen import Hunyuan3DDiTFlowMatchingPipeline as TPipe
from hunyuan3d2_tpu_torch.pipelines.texgen import Hunyuan3DPaintPipeline
from hunyuan3d2_tpu_torch.utils import timer
from tests.test_torch_loading import SUB, _config, _image, _published_sd, _write

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOP_LEVEL = ("get_logger", "synchronize_timer", "Hunyuan3DDiTFlowMatchingPipeline",
             "Hunyuan3DDiTPipeline", "Hunyuan3DPaintPipeline", "ShapeVAE", "Mesh")


@pytest.mark.parametrize("name", TOP_LEVEL)
def test_top_level_names_resolve(name):
    ref = getattr(hunyuan3d2_tpu, name)
    got = getattr(hunyuan3d2_tpu_torch, name)
    assert got.__name__ == ref.__name__
    assert got.__module__.startswith("hunyuan3d2_tpu_torch.")
    with pytest.raises(AttributeError):
        hunyuan3d2_tpu_torch.NoSuchName


def test_top_level_import_stays_cheap():
    """``import hunyuan3d2_tpu_torch`` loads no pipeline or model until one
    is asked for by name."""
    probe = ("import sys, hunyuan3d2_tpu_torch as h; "
             "print(sorted(m for m in sys.modules if m.startswith('hunyuan3d2_tpu_torch.')"
             " and m.split('.')[1] in ('pipelines', 'models', 'geometry'))); "
             "h.ShapeVAE; print('hunyuan3d2_tpu_torch.models.shapevae' in sys.modules)")
    env = {**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1"}
    res = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.split("\n")[:2] == ["[]", "True"], res.stdout


def test_synchronize_timer_records_as_a_scope_and_a_decorator(monkeypatch, caplog):
    with hunyuan3d2_tpu_torch.synchronize_timer("stage a") as t:
        sum(range(1000))
    assert t.elapsed > 0 and timer.LAST_TIMINGS["stage a"] == t.elapsed

    @timer.synchronize_timer()
    def untagged():
        return 7

    @timer.synchronize_timer("tagged")
    def tagged():
        return 8

    assert untagged() == 7 and tagged() == 8
    assert untagged.__qualname__ in timer.LAST_TIMINGS and "tagged" in timer.LAST_TIMINGS
    assert issubclass(timer.timed_scope, timer.synchronize_timer)
    # logged only under HY3DGEN_DEBUG=1, as in the JAX package
    logs = []
    monkeypatch.setattr(timer.logger, "info", lambda *a: logs.append(a))
    with timer.synchronize_timer("quiet"):
        pass
    monkeypatch.setenv("HY3DGEN_DEBUG", "1")
    with timer.timed_scope("loud"):
        pass
    assert [a[1] for a in logs] == ["loud"]


def _params(fn):
    return [(n, p.default, p.kind) for n, p in inspect.signature(fn).parameters.items()]


def _kinds(fn):
    return {p.kind for p in inspect.signature(fn).parameters.values()}


# (port, JAX): every JAX parameter keeps its name, place and default; the
# port may add keywords after them (``device``, a paint call's injected noise)
PAIRS = {
    "MeshRender.__init__": (MeshRender.__init__, JRender.__init__),
    "Hunyuan3DDiTPipeline.prepare_image": (TPipe.prepare_image, JPipe.prepare_image),
    "Hunyuan3DDiTPipeline.compile": (TPipe.compile, JPipe.compile),
    "Hunyuan3DDiTPipeline.from_pretrained": (TPipe.from_pretrained, JPipe.from_pretrained),
    "Hunyuan3DDiTPipeline.from_single_file": (TPipe.from_single_file, JPipe.from_single_file),
    "Hunyuan3DPaintPipeline.__call__": (Hunyuan3DPaintPipeline.__call__, JPaint.__call__),
}


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_signatures_keep_the_jax_parameters(name):
    port, ref = PAIRS[name]
    var = (inspect.Parameter.VAR_KEYWORD, inspect.Parameter.VAR_POSITIONAL)
    p = [x for x in _params(port) if x[2] not in var and x[0] != "device"]
    j = [x for x in _params(ref) if x[2] not in var]
    assert p[:len(j)] == j, (p, j)
    assert _kinds(ref) & set(var) <= _kinds(port)


# constructors and calls that take **kwargs in the JAX package take them in
# the port (extra keywords are accepted, not refused)
KWARGS = {
    "Hunyuan3DDiTPipeline.__init__": (TPipe.__init__, JPipe.__init__),
    "Hunyuan3DDiTPipeline.__call__": (TPipe.__call__, JPipe.__call__),
    "MeshRender.__init__": (MeshRender.__init__, JRender.__init__),
    "HunyuanPaintPipeline.__call__": (HunyuanPaintPipeline.__call__, JInner.__call__),
    "Hunyuan3DDiTPipeline.from_pretrained": (TPipe.from_pretrained, JPipe.from_pretrained),
}


@pytest.mark.parametrize("name", sorted(KWARGS))
def test_kwargs_are_accepted_where_jax_accepts_them(name):
    port, ref = KWARGS[name]
    assert inspect.Parameter.VAR_KEYWORD in _kinds(ref)
    assert inspect.Parameter.VAR_KEYWORD in _kinds(port)


def test_extra_keywords_reach_the_objects():
    r = MeshRender(default_resolution=32, texture_size=32, bake_mode="linear",
                   raster_mode="cpu", shader_type="face")
    assert (r.bake_mode, r.raster_mode) == ("linear", "cpu")
    pipe = TPipe.init_random(size="tiny", dino="tiny", device="cpu")
    again = type(pipe)(pipe.vae, pipe.model, pipe.scheduler, pipe.conditioner, device="cpu",
                       note="kept")
    assert again.kwargs == {"note": "kept"}
    assert pipe.compile() is pipe
    img = _image()
    a = pipe.prepare_image(img)["image"]
    b = pipe.prepare_image(img, mask=np.ones((64, 64), np.uint8))["image"]
    np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def jax_tiny():
    return JPipe.init_random(jax.random.PRNGKey(0), size="tiny", dino="tiny")


@pytest.mark.parametrize("dtype,want", [(None, torch.bfloat16), ("bf16", torch.bfloat16),
                                        (torch.float32, torch.float32),
                                        (np.float32, torch.float32), ("fp32", torch.float32)])
def test_from_pretrained_honours_dtype(tmp_path, jax_tiny, dtype, want):
    sd = _published_sd(jax_tiny)
    _write(str(tmp_path), sd, _config(jax_tiny), "safetensors")
    kw = {} if dtype is None else {"dtype": dtype}
    tp = TPipe.from_pretrained(str(tmp_path), subfolder=SUB, device="cpu", **kw)
    assert "dtype" not in tp.kwargs
    for module in (tp.model, tp.vae, tp.conditioner):
        lin = [m.weight for m in module.modules() if type(m).__name__ == "Linear"]
        assert lin and all(w.dtype == want for w in lin)
    if want == torch.float32:
        # fp32 holds the checkpoint's fp16 values unrounded, every parameter
        w = tp.model.state_dict()
        assert all(t.dtype == torch.float32 for t in w.values())
        for k, t in w.items():
            assert torch.equal(t, torch.from_numpy(sd["model." + k].astype(np.float32))), k
        lat = tp(_image(), num_inference_steps=1, octree_resolution=16, output_type="latents")
        assert torch.isfinite(lat).all()


@pytest.mark.parametrize("dtype", [torch.float16, "fp16", np.int8, "int8", 3])
def test_from_pretrained_refuses_other_dtypes(tmp_path, jax_tiny, dtype):
    _write(str(tmp_path), _published_sd(jax_tiny), _config(jax_tiny), "safetensors")
    with pytest.raises(ValueError, match="is not supported"):
        TPipe.from_pretrained(str(tmp_path), subfolder=SUB, device="cpu", dtype=dtype)
    with pytest.raises(ValueError, match="is not supported"):
        checkpoints.resolve_dtype(dtype)
