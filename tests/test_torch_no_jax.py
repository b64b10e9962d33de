"""The port stands alone: importing hunyuan3d2_tpu_torch and running it
pulls in neither jax nor the JAX package (whose __init__ imports jax)."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import os
import sys
import numpy as np
import torch
from PIL import Image

import hunyuan3d2_tpu_torch
from hunyuan3d2_tpu_torch.ops import attention, conv, flash_attention, geo_decoder, rasterize
from hunyuan3d2_tpu_torch.io import convert
from hunyuan3d2_tpu_torch.geometry import camera, render, render_device, uv
from hunyuan3d2_tpu_torch.models import paint_unet, sd_vae
from hunyuan3d2_tpu_torch.pipelines import hunyuanpaint, multiview, paint_schedulers, texgen
from hunyuan3d2_tpu_torch.pipelines.shapegen import Hunyuan3DDiTFlowMatchingPipeline
from hunyuan3d2_tpu_torch.utils import cuda_build, host_worker
from hunyuan3d2_tpu_torch.tools import serial_texture
from hunyuan3d2_tpu_torch import native
from hunyuan3d2_tpu_torch.volume import decoders, mc_table, surface
from hunyuan3d2_tpu_torch import config
from hunyuan3d2_tpu_torch.apps import api_server, gradio_app, minimal_demo
from hunyuan3d2_tpu_torch.geometry import postprocess
from hunyuan3d2_tpu_torch.io import checkpoints
from hunyuan3d2_tpu_torch.models import clip_vit, conditioner
from hunyuan3d2_tpu_torch.utils import rembg
from hunyuan3d2_tpu_torch.models import hunyuan_dit
from hunyuan3d2_tpu_torch.pipelines import t2i
from hunyuan3d2_tpu_torch.utils import text2image
from hunyuan3d2_tpu_torch.tools import flash_fp32_error
from hunyuan3d2_tpu_torch.models import controlnet, ip_adapter
from hunyuan3d2_tpu_torch.pipelines import align, delight, upscale
from hunyuan3d2_tpu_torch.utils import align_img4tex, dehighlight, imagesuper
import importlib
for name in sorted(os.listdir(os.path.join(os.path.dirname(hunyuan3d2_tpu_torch.__file__),
                                           "examples"))):
    if name.endswith(".py") and name != "__init__.py":
        importlib.import_module("hunyuan3d2_tpu_torch.examples." + name[:-3])

pipe = Hunyuan3DDiTFlowMatchingPipeline.init_random(size="tiny", dino="tiny", device="cpu")
pipe.enable_flashvdm(mc_algo="dmc")
img = np.zeros((32, 32, 4), np.uint8)
img[8:24, 8:24] = 200
mesh = pipe(Image.fromarray(img), num_inference_steps=1, octree_resolution=16)[0]
assert mesh.vertices.shape[1] == 3
for algo in ("mc", "mt"):
    pipe.enable_flashvdm(mc_algo=algo)
    assert len(pipe(Image.fromarray(img), num_inference_steps=1, octree_resolution=16)[0].faces)
pipe.enable_flashvdm(enabled=False)
assert len(pipe(Image.fromarray(img), num_inference_steps=1, octree_resolution=16)[0].faces)
paint = hunyuan3d2_tpu_torch.Hunyuan3DPaintPipeline.init_random(
    size="tiny", view_size=32, render_size=48, texture_size=48, num_inference_steps=1,
    device="cpu").set_turbo()
textured = paint(mesh, Image.fromarray(img))
assert textured.texture.shape == (48, 48, 3) and textured.uv.shape == (len(textured.vertices), 2)
standard = hunyuan3d2_tpu_torch.Hunyuan3DPaintPipeline.init_random(
    size="tiny", view_size=32, render_size=48, texture_size=48, num_inference_steps=1,
    device="cpu")
assert standard(mesh, Image.fromarray(img)).texture.shape == (48, 48, 3)
host = render.MeshRender(default_resolution=48, texture_size=48)
host.load_mesh(textured)
tex, trust = host.bake_texture_fused([np.full((48, 48, 3), 128, np.uint8)] * 2, [0, 0], [0, 180])
assert tex.shape == (48, 48, 3) and trust.any()
assert host.render_normal(0, 0).shape == (48, 48, 4)
assert paint_schedulers.DDIMScheduler().make_tables(5)[0].shape == (5,)
clean = postprocess.FaceReducer()(postprocess.DegenerateFaceRemover()(
    postprocess.FloaterRemover()(mesh)), max_facenum=200)
assert 0 < len(clean.faces) <= 200
import base64, io, os
buf = io.BytesIO()
Image.fromarray(img).save(buf, format="PNG")
worker = api_server.ModelWorker.from_pipelines(pipe, random_weights=True)
path = worker.generate("no-jax-probe", {"image": base64.b64encode(buf.getvalue()).decode(),
                                        "octree_resolution": 16, "num_inference_steps": 1})
assert len(mesh.__class__.load(path).faces)
os.unlink(path)
path = worker.generate("no-jax-probe-text", {"text": "a chair", "octree_resolution": 16,
                                             "num_inference_steps": 1})
assert len(mesh.__class__.load(path).faces)
os.unlink(path)
lit = dehighlight.Light_Shadow_Remover(pipeline=delight.DelightPipeline.init_random(
    resolution=32, num_inference_steps=1, device="cpu"))(Image.fromarray(img))
assert lit.size == (32, 32)
up = imagesuper.Image_Super_Net(pipeline=upscale.UpscalePipeline.init_random(
    num_inference_steps=1, device="cpu"))(Image.fromarray(img[8:24, 8:24, :3]))
assert up.size == (64, 64)
aligner = align.ControlNetSDPipeline.init_random(resolution=32, device="cpu")
out = align_img4tex.Img2img_Control_Ip_adapter(pipeline=aligner)(
    "a chair", Image.fromarray(img), Image.fromarray(img), "", height=32, width=32,
    num_inference_steps=1)
assert out.size == (32, 32)
assert align.HesModel(pipeline=aligner)(Image.fromarray(img), Image.fromarray(img), strength=0.5,
                                        num_inference_steps=2).size == (32, 32)
from hunyuan3d2_tpu_torch.training import flow_match_loss, make_train_step
from hunyuan3d2_tpu_torch.io import pytree_io
from hunyuan3d2_tpu_torch.volume import diff_surface
from hunyuan3d2_tpu_torch.utils import counters, debug, profiling
from hunyuan3d2_tpu_torch.geometry import voxel_hierarchy
from hunyuan3d2_tpu_torch.tools import export_native
from hunyuan3d2_tpu_torch.parallel import collectives, diagnostics, mesh, pipeline, sharding
from hunyuan3d2_tpu_torch.tools import parallel_check
from hunyuan3d2_tpu_torch.tools import profile_flash_bwd_variants
from hunyuan3d2_tpu_torch.pipelines import shapegen
from hunyuan3d2_tpu_torch.utils import flops
assert flops.dit_forward_flops(pipe.model.cfg, 64, 5, 2) > 0
assert flops.volume_decode_queries(decoders.VanillaVolumeDecoder(), 16, 65536) == 17 ** 3
assert all(hasattr(c, "shard") for c in (shapegen.Hunyuan3DDiTFlowMatchingPipeline,
                                         texgen.Hunyuan3DPaintPipeline,
                                         hunyuanpaint.HunyuanPaintPipeline))
assert hunyuan3d2_tpu_torch.ShapeVAE is not None and hunyuan3d2_tpu_torch.Mesh is not None
opt, step = make_train_step(pipe.model)
gen = torch.Generator().manual_seed(0)
loss = step(torch.randn(1, 64, 64, generator=gen), torch.randn(1, 5, 1536, generator=gen),
            generator=gen)
assert torch.isfinite(loss)
lin = torch.linspace(-1.01, 1.01, 12)
x, y, z = torch.meshgrid(lin, lin, lin, indexing="ij")
verts, tris, nq, count = diff_surface.differentiable_surface_nets(
    0.6 - (x * x + y * y + z * z).sqrt(), capacity=1024, face_capacity=1536)
assert int(count) > 0 and int(nq) > 0
bad = sorted(m for m in sys.modules if m in ("jax", "hunyuan3d2_tpu")
             or m.startswith(("jax.", "jaxlib", "hunyuan3d2_tpu.")))
print("FORBIDDEN", bad)
"""


def test_port_imports_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    # one intra-op thread: the suite's other workers share the host's cores
    env["OMP_NUM_THREADS"] = "1"
    res = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "FORBIDDEN []" in res.stdout, res.stdout


def test_port_sources_name_no_jax():
    """No module of the port (nor chip_smoke.py) imports jax or the JAX
    package, even inside a function."""
    import re

    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|hunyuan3d2_tpu)(\.|\s|$)", re.M)
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "hunyuan3d2_tpu_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    offenders = []
    for f in files:
        with open(f) as fh:
            if pat.search(fh.read()):
                offenders.append(os.path.relpath(f, ROOT))
    assert not offenders, offenders
