"""The textured path's overlap (hunyuan3d2_tpu_torch/pipelines/texgen.py):
the UV unwrap runs in the host worker process (utils/host_worker.py) while
the device computes the cond maps and the multiview diffusion, as the JAX
package's schedule unwraps while its chip denoises
(hunyuan3d2_tpu/pipelines/texgen.py). On the CPU at tiny sizes: the worker's
unwrap equals the in-process one bit for bit, the unwrap is submitted before
the denoise starts and waited for after it ends (no clock involved), a
failure in the worker raises out of the call with no in-process unwrap
after it, and the overlapped call equals the stages run by hand in the
serial order bit for bit. tests/test_torch_texgen.py's end-to-end parity
with the JAX package runs through the same overlapped call."""

import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
from concurrent.futures.process import BrokenProcessPool

from hunyuan3d2_tpu_torch.geometry import uv as tuv
from hunyuan3d2_tpu_torch.geometry.uv import mesh_uv_wrap, mesh_uv_wrap_arrays
from hunyuan3d2_tpu_torch.pipelines import multiview as tmv
from hunyuan3d2_tpu_torch.pipelines import texgen
from hunyuan3d2_tpu_torch.tools.texgen_overlap_ab import serial_texture
from hunyuan3d2_tpu_torch.utils import host_worker
from hunyuan3d2_tpu_torch.utils.timer import LAST_TIMINGS
from tests import torch_overlap_cases as cases
from tests.test_torch_texgen import _sphere


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# a parent that starts the worker, prints its pid and dies without stopping it
_KILLED_PARENT = r"""
import os, signal, sys
sys.path.insert(0, sys.argv[1])
from hunyuan3d2_tpu_torch.utils import host_worker
print(host_worker.submit(os.getpid).result()[0], flush=True)
os.kill(os.getpid(), signal.SIGKILL)
"""


def _alive(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/stat") as fh:
            return fh.read().rsplit(")", 1)[1].split()[0] != "Z"
    except FileNotFoundError:
        return False


@pytest.fixture(autouse=True)
def _one_thread():
    # the suite's other workers share the host's cores
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def sphere():
    return _sphere()


def _image():
    from PIL import Image

    img = np.zeros((64, 64, 4), np.uint8)
    img[12:52, 20:44, :3] = [200, 30, 30]
    img[20:40, 24:40, :3] = [30, 160, 220]
    img[12:52, 20:44, 3] = 255
    return Image.fromarray(img)


@pytest.fixture(scope="module")
def pipe():
    return texgen.Hunyuan3DPaintPipeline.init_random(
        size="tiny", view_size=32, render_size=64, texture_size=64, num_inference_steps=2,
        device="cpu").set_turbo()


def test_worker_unwrap_equals_in_process_unwrap():
    """(a) The worker entry, run in the worker, gives the in-process
    ``mesh_uv_wrap``'s vertices, faces and UVs bit for bit on a sphere of a
    few thousand faces."""
    mesh = _sphere(res=34)
    assert 3000 <= len(mesh.faces) <= 6000, len(mesh.faces)
    (v, f, uv), seconds, pid = host_worker.submit(mesh_uv_wrap_arrays, mesh.vertices,
                                                  mesh.faces).result()
    ref = mesh_uv_wrap(mesh)
    assert pid != os.getpid() and seconds > 0
    for got, want in ((v, ref.vertices), (f, ref.faces), (uv, ref.uv)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_worker_caps_its_threads_and_loads_no_torch_or_jax():
    caps, loaded = host_worker.submit(cases.worker_state).result()[0]
    assert caps == dict.fromkeys(caps, str(host_worker.THREADS))
    assert loaded == []


def test_unwrap_is_submitted_before_the_denoise_and_waited_for_after(pipe, sphere,
                                                                     monkeypatch):
    """(b) The schedule, by the order of events: the unwrap's submission,
    the multiview net's call (the denoise) from start to end, then the wait
    for the unwrap."""
    events = []
    submit, call = host_worker.submit, tmv.Multiview_Diffusion_Net.__call__

    class Waited:
        def __init__(self, future):
            self.future = future

        def result(self):
            events.append("wait")
            return self.future.result()

    def spy_submit(fn, *args):
        events.append(f"submit {fn.__name__}")
        return Waited(submit(fn, *args))

    def spy_call(self, *args, **kwargs):
        events.append("denoise start")
        out = call(self, *args, **kwargs)
        events.append("denoise end")
        return out

    monkeypatch.setattr(host_worker, "submit", spy_submit)
    monkeypatch.setattr(tmv.Multiview_Diffusion_Net, "__call__", spy_call)
    LAST_TIMINGS.clear()
    out = pipe(sphere, _image())
    assert events == ["submit mesh_uv_wrap_arrays", "denoise start", "denoise end", "wait"]
    assert pipe.unwrap_pid not in (None, os.getpid())
    assert LAST_TIMINGS["UV Unwrap (overlaps denoise)"] > 0
    assert "UV Unwrap (wait)" in LAST_TIMINGS and "UV Unwrap" not in LAST_TIMINGS
    assert out.uv is not None and out.texture.shape == (64, 64, 3)


@pytest.mark.parametrize("failure, error", [(cases.unwrap_out_of_range, IndexError),
                                            (cases.unwrap_dies, BrokenProcessPool)],
                         ids=["raises", "dies"])
def test_worker_failure_raises_with_no_in_process_unwrap(pipe, sphere, monkeypatch, failure,
                                                         error):
    """(c) An unwrap that raises in the worker (its mesh has a face index out
    of range there: the pipeline's own stages see the valid mesh, so the
    error can only come from the worker), or a worker that dies, raises out
    of the textured call, and nothing unwraps in this process after it. The
    next call starts a fresh worker."""
    def in_process(*args, **kwargs):
        raise AssertionError("the textured call unwrapped in-process")

    with monkeypatch.context() as m:
        m.setattr(texgen, "mesh_uv_wrap_arrays", failure)
        m.setattr(tuv, "unwrap", in_process)
        with pytest.raises(error):
            pipe(sphere, _image())
    out = pipe(sphere, _image())
    assert out.uv is not None and pipe.unwrap_pid != os.getpid()


def test_worker_exits_when_its_parent_dies():
    """A parent killed without stopping its worker (no atexit runs) leaves
    no worker behind."""
    res = subprocess.run([sys.executable, "-c", _KILLED_PARENT, ROOT], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == -signal.SIGKILL, res.stderr[-2000:]
    pid = int(res.stdout.split()[0])
    deadline = time.monotonic() + 30
    while _alive(pid) and time.monotonic() < deadline:
        time.sleep(0.1)
    assert not _alive(pid)


@pytest.mark.parametrize("turbo", [True, False], ids=["turbo", "standard"])
def test_overlapped_call_equals_the_serial_stages(pipe, sphere, turbo):
    """The overlapped call against the public stages run by hand in the
    serial order (cond maps → multiview net → mesh_uv_wrap in this process →
    upload → bake → inpaint) on the same draws: texture, UVs, faces and
    vertices bit for bit."""
    pipe.set_turbo(turbo)
    gen = torch.Generator().manual_seed(17)
    init = torch.randn(1, 6, 16, 16, 4, generator=gen)
    noises = [torch.randn(1, 6, 16, 16, 4, generator=gen) for _ in range(2)]
    try:
        out = pipe(sphere, _image(), init_latents=init, step_noises=noises)
        ref = serial_texture(pipe, sphere, _image(), init_latents=init, step_noises=noises)
    finally:
        pipe.set_turbo(True)
    for name in ("texture", "uv", "faces", "vertices"):
        np.testing.assert_array_equal(getattr(out, name), getattr(ref, name), err_msg=name)
    assert float(out.texture.std()) > 0
