"""The port's apps on the CPU: the HTTP API server in-process, the gradio
worker and UI (through a recording gradio shim), the minimal demo, the
background remover, and the public signatures held to the JAX package's.

Random weights at the tiny sizes (``HY3D_RANDOM_SIZE=tiny``); the textured
route runs a small paint-turbo stack (32² views, 2 steps).
"""

import argparse
import base64
import importlib.util
import inspect
import io
import json
import os
import sys
import threading
import types
import urllib.error
import urllib.request

import numpy as np
import pytest
from PIL import Image

from hunyuan3d2_tpu_torch.geometry.mesh import Mesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread a test: the suite runs several workers on the
    host's cores, and torch's many small CPU calls slow down many times over
    when every worker spins up a thread per core."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _small_paint():
    from hunyuan3d2_tpu_torch import Hunyuan3DPaintPipeline

    return Hunyuan3DPaintPipeline.init_random(size="tiny", view_size=32, render_size=64,
                                              texture_size=64, num_inference_steps=2,
                                              device="cpu").set_turbo()


def _png_b64(size=64):
    img = np.zeros((size, size, 4), np.uint8)
    img[16:48, 16:48] = [200, 60, 60, 255]
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


# ---------------------------------------------------------------------------
# the API server
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def server():
    from hunyuan3d2_tpu_torch.apps import api_server

    saved = os.environ.get("HY3D_RANDOM_SIZE")
    os.environ["HY3D_RANDOM_SIZE"] = "tiny"
    try:
        worker = api_server.ModelWorker(random_weights=True, device="cpu")
    finally:
        if saved is None:
            os.environ.pop("HY3D_RANDOM_SIZE")
        else:
            os.environ["HY3D_RANDOM_SIZE"] = saved
    worker.pipeline_tex = _small_paint()
    srv = api_server.serve(worker, "127.0.0.1", 0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()
    srv.server_close()
    thread.join(timeout=10)
    assert not thread.is_alive()


def _request(url, payload=None, timeout=300):
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _payload(**kw):
    return {"image": _png_b64(), "octree_resolution": 32, "num_inference_steps": 2, "seed": 7,
            **kw}


def _read_glb(data: bytes, tmp_path, name="out.glb") -> Mesh:
    assert data[:4] == b"glTF"
    path = tmp_path / name
    path.write_bytes(data)
    return Mesh.load(str(path))


def test_generate_returns_a_glb(server, tmp_path):
    code, body = _request(server + "/healthz")
    assert code == 200 and json.loads(body)["status"] == "ok"
    code, body = _request(server + "/generate", _payload())
    assert code == 200
    mesh = _read_glb(body, tmp_path)
    assert len(mesh.faces) > 0 and mesh.faces.max() < len(mesh.vertices)


def test_generate_from_text_returns_a_glb(server, tmp_path):
    """A text request: the tiny random-weight t2i pipeline, built at the
    first such request, makes the image; the shape stack its mesh."""
    from hunyuan3d2_tpu_torch.utils.timer import LAST_TIMINGS

    code, body = _request(server + "/generate", {"text": "a chair", "octree_resolution": 32,
                                                 "num_inference_steps": 2, "seed": 3})
    assert code == 200
    mesh = _read_glb(body, tmp_path)
    assert len(mesh.faces) > 0 and mesh.faces.max() < len(mesh.vertices)
    assert "T2I Denoising" in LAST_TIMINGS


def test_generate_textured_runs_postprocess_and_paint(server, tmp_path):
    from hunyuan3d2_tpu_torch.utils.timer import LAST_TIMINGS

    code, body = _request(server + "/generate", _payload(texture=True, face_count=2000))
    assert code == 200
    mesh = _read_glb(body, tmp_path)
    assert mesh.uv is not None and mesh.texture is not None and mesh.texture.shape == (64, 64, 3)
    assert len(mesh.faces) <= 2000
    for stage in ("FloaterRemover", "DegenerateFaceRemover", "FaceReducer",
                  "Multiview Diffusion (device)", "UV Unwrap (overlaps denoise)",
                  "UV Unwrap (wait)"):
        assert stage in LAST_TIMINGS


def test_send_then_status(server, tmp_path):
    import time

    code, body = _request(server + "/send", _payload(type="obj"))
    assert code == 200
    uid = json.loads(body)["uid"]
    for _ in range(600):
        code, body = _request(server + f"/status/{uid}")
        st = json.loads(body)
        if st["status"] != "processing":
            break
        time.sleep(0.2)
    assert code == 200 and st["status"] == "completed", st
    (tmp_path / "m.obj").write_bytes(base64.b64decode(st["model_base64"]))
    assert len(Mesh.load(str(tmp_path / "m.obj")).faces) > 0
    code, body = _request(server + "/status/no-such-job")
    assert code == 404


@pytest.mark.parametrize("fails", [False, True])
def test_status_right_after_send_finds_the_job(monkeypatch, tmp_path, fails):
    """/send enters the job before it answers: a /status poll that comes
    before the job's thread has run a line answers "processing", not 404;
    once the job has run, "completed" with the file, or "error" with the
    reason."""
    from hunyuan3d2_tpu_torch.apps import api_server

    held = []

    class HeldThread(threading.Thread):   # started only when the test says so
        def start(self):
            held.append(self)

    class StubWorker:
        worker_id = "stub"

        def generate(self, uid, params):
            if fails:
                raise ValueError("no surface")
            path = tmp_path / f"{uid}.glb"
            path.write_bytes(b"glTF")
            return str(path)

    monkeypatch.setattr(api_server, "threading", types.SimpleNamespace(Thread=HeldThread))
    srv = api_server.serve(StubWorker(), "127.0.0.1", 0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        code, body = _request(url + "/send", {"image": ""})
        uid = json.loads(body)["uid"]
        code, body = _request(url + f"/status/{uid}")
        assert code == 200 and json.loads(body) == {"status": "processing"}
        (job,) = held
        threading.Thread.start(job)
        job.join(timeout=10)
        code, body = _request(url + f"/status/{uid}")
        st = json.loads(body)
        if fails:
            assert code == 200 and st == {"status": "error", "message": "no surface"}
        else:
            assert code == 200 and st["status"] == "completed"
            assert base64.b64decode(st["model_base64"]) == b"glTF"
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=10)


@pytest.mark.parametrize("route,payload,code,message", [
    ("/nowhere", None, 404, "unknown route"),
    ("/nowhere", {}, 404, "unknown route"),
    ("/generate", {"text": "a chair", "type": "fbx"}, 400, "type must be one of"),
    ("/generate", {}, 400, "No input image"),
    ("/generate", {"image": "bm90IGFuIGltYWdl"}, 400, "not a base64-encoded image"),
    ("/generate", {"image": "", "type": "../x"}, 400, "type must be one of"),
])
def test_bad_requests(server, route, payload, code, message):
    got, body = _request(server + route, payload)
    assert got == code and message in json.loads(body).get("error", ""), body


# ---------------------------------------------------------------------------
# the gradio worker and UI
# ---------------------------------------------------------------------------
class _Component:
    def __init__(self, *args, **kwargs):
        self.args = args
        self.kwargs = kwargs
        self.clicks = []
        _REC.append(self)

    def click(self, fn, inputs, outputs):
        self.clicks.append((fn, list(inputs), list(outputs)))


class _Ctx(_Component):
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_REC = []


def _gradio_shim():
    """The gradio surface build_ui touches, recording every component."""
    gr = types.ModuleType("gradio")
    for name in ("Blocks", "Row", "Column", "Tabs", "Tab", "Accordion"):
        setattr(gr, name, type(name, (_Ctx,), {"kind": name}))
    for name in ("Image", "Textbox", "Slider", "Number", "Dropdown", "Checkbox", "Button",
                 "Model3D", "File", "Markdown", "HTML"):
        setattr(gr, name, type(name, (_Component,), {"kind": name}))
    return gr


def _args(**kw):
    base = dict(model_path="", subfolder="", texgen_model_path="", enable_t23d=False,
                disable_tex=False, enable_flashvdm=True, mc_algo="mc",
                low_vram_mode=False, random_weights=True, device="cpu")
    base.update(kw)
    return argparse.Namespace(**base)


def _img(color=(200, 90, 90)):
    arr = np.zeros((128, 128, 4), np.uint8)
    arr[32:96, 32:96] = list(color) + [255]
    return Image.fromarray(arr)


@pytest.fixture(scope="module")
def gradio_worker():
    from hunyuan3d2_tpu_torch.apps.gradio_app import GradioWorker

    saved = os.environ.get("HY3D_RANDOM_SIZE")
    os.environ["HY3D_RANDOM_SIZE"] = "tiny"
    try:
        worker = GradioWorker(_args())
    finally:
        if saved is None:
            os.environ.pop("HY3D_RANDOM_SIZE")
        else:
            os.environ["HY3D_RANDOM_SIZE"] = saved
    worker.tex_pipe = _small_paint()
    return worker


def test_gradio_worker_shape_multiview_texture_and_export(gradio_worker):
    from hunyuan3d2_tpu_torch.apps.gradio_app import EXPORT_TYPES

    w = gradio_worker
    mesh, ref = w.gen_shape(image=_img(), steps=2, octree_resolution=32)
    assert "shape_gen_total" in mesh.metadata["stats"] and "Diffusion Sampling" in \
        mesh.metadata["stats"]
    for ftype in EXPORT_TYPES:
        path = w.export(mesh, file_type=ftype, reduce_faces=500)
        assert os.path.exists(path) and path.endswith(ftype)
        if ftype in ("glb", "obj", "ply"):
            assert 0 < len(Mesh.load(path).faces) <= 500
        os.unlink(path)
    with pytest.raises(ValueError):
        w.export(mesh, file_type="fbx")
    with pytest.raises(RuntimeError, match="text-to-image"):
        w.gen_shape(prompt="a chair", steps=2, octree_resolution=32)
    views = {"front": _img((200, 60, 60)), "left": _img((60, 200, 60)), "back": None}
    mv, ref = w.gen_shape(mv_images=views, steps=2, octree_resolution=32)
    assert len(mv.faces) > 0 and ref.size == views["front"].size
    w.shape_pipe.image_processor = None     # the next single-view call restores its own
    textured = w.generation_all(image=_img(), steps=2, octree_resolution=32)
    assert textured.texture is not None and "texture_total" in textured.metadata["stats"]
    path = w.export(textured, "glb")
    html = w.html_viewer(path)
    assert os.path.basename(path) in open(html).read()
    os.unlink(path)
    os.unlink(html)


def test_gradio_worker_refuses_text_to_3d(monkeypatch):
    """Only without --enable_t23d (the fixture's worker refuses, see above);
    with it, random weights give the tiny random-weight t2i pipeline, and a
    prompt becomes an image and then a mesh."""
    from hunyuan3d2_tpu_torch.apps.gradio_app import GradioWorker
    from hunyuan3d2_tpu_torch.pipelines.t2i import HunyuanDiTTorchPipeline

    monkeypatch.setenv("HY3D_RANDOM_SIZE", "tiny")
    w = GradioWorker(_args(enable_t23d=True, disable_tex=True))
    assert isinstance(w.t2i.backend.pipe, HunyuanDiTTorchPipeline)
    image = w.text_to_image("a chair", seed=1)
    assert image.size == (64, 64) and image.mode == "RGB"
    mesh, ref = w.gen_shape(prompt="a chair", steps=2, octree_resolution=32)
    assert len(mesh.faces) > 0 and ref.size == (64, 64)


def test_build_ui_drives_the_worker(gradio_worker, monkeypatch):
    from hunyuan3d2_tpu_torch.apps import gradio_app

    _REC.clear()
    monkeypatch.setitem(sys.modules, "gradio", _gradio_shim())
    gradio_app.build_ui(gradio_worker)
    kinds = [c.kind for c in _REC]
    assert kinds.count("Tab") == 3 and kinds.count("Image") == 5
    assert kinds.count("Button") == 2 and kinds.count("Slider") == 4
    buttons = [c for c in _REC if c.kind == "Button"]
    for b in buttons:
        fn, ins, outs = b.clicks[0]
        assert len(b.clicks) == 1 and len(ins) == 13 and len(outs) == 3
    text_box = next(c for c in _REC if c.kind == "Textbox")
    assert text_box.kwargs["interactive"] is False
    shape_fn = buttons[0].clicks[0][0]
    path, viewer, stats = shape_fn(_img(), "", None, None, None, None, 2, 5.0, 3, 32,
                                   "glb", True, 1000)
    assert path.endswith(".glb") and viewer.endswith(".html") and "| stage | seconds |" in stats
    assert 0 < len(Mesh.load(path).faces) <= 1000
    for p in (path, viewer):
        os.unlink(p)


def test_gradio_main_low_vram_mode_offloads_the_shape_stack(monkeypatch):
    """--low_vram_mode keeps the shape stack's weights on the host between
    calls; main builds the UI and launches it."""
    from hunyuan3d2_tpu_torch.apps import gradio_app

    made, launched = [], []

    class RecordingWorker(gradio_app.GradioWorker):
        def __init__(self, args):
            super().__init__(args)
            made.append(self)

    gr = _gradio_shim()
    gr.Blocks.launch = lambda self, **kw: launched.append(kw)
    _REC.clear()
    monkeypatch.setitem(sys.modules, "gradio", gr)
    monkeypatch.setattr(gradio_app, "GradioWorker", RecordingWorker)
    monkeypatch.setenv("HY3D_RANDOM_SIZE", "tiny")
    gradio_app.main(["--random-weights", "--device", "cpu", "--disable_tex", "--low_vram_mode",
                     "--port", "0"])
    (worker,) = made
    assert worker.shape_pipe._auto_offload and worker.tex_pipe is None
    assert launched == [dict(server_name="0.0.0.0", server_port=0)]
    shape_fn = next(c for c in _REC if c.kind == "Button").clicks[0][0]
    path, viewer, _ = shape_fn(_img(), "", None, None, None, None, 2, 5.0, 3, 32, "glb",
                               False, 1000)
    assert len(Mesh.load(path).faces) > 0
    for p in (path, viewer):
        os.unlink(p)


@pytest.mark.parametrize("flag", ["--compile", "--cache-path=/x"])
def test_gradio_main_refuses_flags_it_would_ignore(flag, capsys):
    from hunyuan3d2_tpu_torch.apps import gradio_app

    with pytest.raises(SystemExit) as e:
        gradio_app.main(["--random-weights", flag])
    assert e.value.code == 2 and "unrecognized arguments" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# the minimal demo, the background remover, the signatures
# ---------------------------------------------------------------------------
def test_minimal_demo_random_weights_writes_a_glb(tmp_path, monkeypatch, capsys):
    from hunyuan3d2_tpu_torch.apps import minimal_demo

    monkeypatch.setenv("HY3D_RANDOM_SIZE", "tiny")
    out = tmp_path / "demo.glb"
    minimal_demo.main(["--random-weights", "--device", "cpu", "--octree", "48", "--steps", "2",
                       "--output", str(out)])
    assert "wrote" in capsys.readouterr().out
    mesh = Mesh.load(str(out))
    assert len(mesh.faces) > 0 and mesh.faces.max() < len(mesh.vertices)


def test_background_remover_matches_the_jax_copy():
    from hunyuan3d2_tpu.utils.rembg import BackgroundRemover as JRemover
    from hunyuan3d2_tpu_torch.utils.rembg import BackgroundRemover

    cut = _img()
    out = BackgroundRemover()(cut)
    assert out.mode == "RGBA" and np.array_equal(np.asarray(out), np.asarray(cut))
    rs = np.random.RandomState(0)
    photo = np.full((96, 96, 3), 235, np.uint8)
    photo[24:72, 30:66] = rs.randint(20, 120, (48, 36, 3))
    photo = Image.fromarray(photo)
    a, b = np.asarray(BackgroundRemover()(photo)), np.asarray(JRemover()(photo))
    assert a.shape == (96, 96, 4)
    np.testing.assert_array_equal(a, b)
    assert a[48, 48, 3] == 255 and a[2, 2, 3] == 0


def _jax_app(name):
    spec = importlib.util.spec_from_file_location(f"jax_app_{name}",
                                                  os.path.join(ROOT, "apps", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _names(fn):
    return [n for n, p in inspect.signature(fn).parameters.items()
            if p.kind not in (p.VAR_POSITIONAL, p.VAR_KEYWORD)]


def _pairs():
    from hunyuan3d2_tpu.geometry import postprocess as jpost
    from hunyuan3d2_tpu.pipelines.shapegen import Hunyuan3DDiTFlowMatchingPipeline as JShape
    from hunyuan3d2_tpu.pipelines.texgen import Hunyuan3DPaintPipeline as JPaint
    from hunyuan3d2_tpu.pipelines.texgen import Hunyuan3DTexGenConfig as JConfig
    from hunyuan3d2_tpu_torch import Hunyuan3DDiTFlowMatchingPipeline as TShape
    from hunyuan3d2_tpu_torch import Hunyuan3DPaintPipeline as TPaint
    from hunyuan3d2_tpu_torch.apps import api_server, gradio_app
    from hunyuan3d2_tpu_torch.geometry import postprocess as tpost
    from hunyuan3d2_tpu_torch.pipelines.texgen import Hunyuan3DTexGenConfig as TConfig

    japi, jgr = _jax_app("api_server"), _jax_app("gradio_app")
    pairs = {
        "shape.from_pretrained": (TShape.from_pretrained, JShape.from_pretrained),
        "shape.from_single_file": (TShape.from_single_file, JShape.from_single_file),
        "shape.offload_to_host": (TShape.offload_to_host, JShape.offload_to_host),
        "shape.restore_to_device": (TShape.restore_to_device, JShape.restore_to_device),
        "shape.enable_model_cpu_offload": (TShape.enable_model_cpu_offload,
                                           JShape.enable_model_cpu_offload),
        "paint.from_pretrained": (TPaint.from_pretrained, JPaint.from_pretrained),
        "TexGenConfig": (TConfig.__init__, JConfig.__init__),
        "ModelWorker": (api_server.ModelWorker.__init__, japi.ModelWorker.__init__),
        "ModelWorker.generate": (api_server.ModelWorker.generate, japi.ModelWorker.generate),
        "GradioWorker.gen_shape": (gradio_app.GradioWorker.gen_shape,
                                   jgr.GradioWorker.gen_shape),
        "GradioWorker.export": (gradio_app.GradioWorker.export, jgr.GradioWorker.export),
        "mesh_normalize": (tpost.mesh_normalize, jpost.mesh_normalize),
    }
    for cls in ("FloaterRemover", "DegenerateFaceRemover", "FaceReducer", "MeshSimplifier"):
        for meth in ("__init__", "__call__"):
            pairs[f"{cls}.{meth}"] = (getattr(getattr(tpost, cls), meth),
                                      getattr(getattr(jpost, cls), meth))
    return pairs


def test_signatures_keep_the_jax_parameter_names():
    """Each JAX parameter keeps its name and place; the port may add
    keywords after them (``device``)."""
    for name, (port, ref) in _pairs().items():
        p, j = _names(port), _names(ref)
        assert p[:len(j)] == j, (name, p, j)
