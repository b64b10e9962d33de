"""The port's texture path (hunyuan3d2_tpu_torch: ops/rasterize, the device
cond maps and bake, the UV unwrap copy, the native copy, and mesh + image →
textured mesh) against the JAX package's, on the CPU at tiny sizes.

The Pallas rasterizer runs in interpret mode (its default off the TPU); the
JAX texture pipeline runs its device path through it
(HY3D_DEVICE_BAKE=force). Meshes are spheres from the port's surface nets.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from hunyuan3d2_tpu.geometry import render_tpu as jrd
from hunyuan3d2_tpu.geometry.mesh import Mesh as JMesh
from hunyuan3d2_tpu.geometry.render import MeshRender as JRender
from hunyuan3d2_tpu.geometry.uv import mesh_uv_wrap as j_uv_wrap
from hunyuan3d2_tpu.ops.rasterize_tpu import rasterize_tpu
from hunyuan3d2_tpu_torch.geometry import render_device as trd
from hunyuan3d2_tpu_torch.geometry.mesh import Mesh
from hunyuan3d2_tpu_torch.geometry.render import MeshRender
from hunyuan3d2_tpu_torch.geometry.uv import mesh_uv_wrap
from hunyuan3d2_tpu_torch.ops.rasterize import (
    face_setup,
    interpolate,
    rasterize,
    rasterize_cuda,
)
from hunyuan3d2_tpu_torch.volume.decoders import quads_to_tris, surface_nets_from_grid

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VIEWS = [(0, 0), (0, 90), (0, 180), (0, 270), (90, 0), (-90, 180)]
WEIGHTS = [1, 0.1, 0.5, 0.1, 0.05, 0.05]


def _sphere(res: int = 24, radius: float = 0.6) -> Mesh:
    """A surface-nets sphere, turned off the grid axes: seen along an axis,
    the faces on the silhouette of an axis-aligned lattice mesh are exactly
    edge-on, and XLA's FMA contraction of the JAX kernel's area a·b − c·d
    gives them a spurious nonzero area (and bogus coverage) on the CPU."""
    lin = torch.linspace(-1.01, 1.01, res + 1)
    r = torch.sqrt(lin[:, None, None] ** 2 + lin[None, :, None] ** 2 + lin[None, None, :] ** 2)
    v, q, nq, count, ok = surface_nets_from_grid(radius - r, 0.0, 1.01, capacity=1 << 15,
                                                 face_capacity=1 << 15)
    assert bool(ok)
    a, b = 0.3, 0.2
    rot = (np.array([[1, 0, 0], [0, np.cos(a), -np.sin(a)], [0, np.sin(a), np.cos(a)]])
           @ np.array([[np.cos(b), 0, np.sin(b)], [0, 1, 0], [-np.sin(b), 0, np.cos(b)]]))
    return Mesh(v[:int(count)].numpy() @ rot.T.astype(np.float32), quads_to_tris(q[:int(nq)]))


@pytest.fixture(scope="module")
def sphere():
    return _sphere()


@pytest.fixture(scope="module")
def wrapped(sphere):
    return mesh_uv_wrap(sphere)


def _renders(mesh, res=96, tex=64):
    jr = JRender(default_resolution=res, texture_size=tex)
    tr = MeshRender(default_resolution=res, texture_size=tex)
    jr.load_mesh(JMesh(mesh.vertices, mesh.faces, uv=mesh.uv))
    tr.load_mesh(mesh)
    return jr, tr


def _mats(render):
    mvs = np.stack([render._mvp(e, a)[0] for e, a in VIEWS]).astype(np.float32)
    mvps = np.stack([render._mvp(e, a)[1] for e, a in VIEWS]).astype(np.float32)
    return mvs, mvps


def _compare_raster(verts, faces, h, w, min_agree=0.999):
    ref = rasterize_tpu(jnp.asarray(verts), jnp.asarray(faces), h, w)
    out = rasterize(torch.from_numpy(verts), torch.from_numpy(faces), h, w)
    fid = np.asarray(ref.face_id)
    same = out.face_id.numpy() == fid
    assert same.mean() >= min_agree, same.mean()
    assert (fid >= 0).any()
    # XLA contracts the per-face records' a·b − c·d into FMAs under jit where
    # PyTorch rounds each product, so the records' constants differ by ulps:
    # measured up to 1.5e-3 in the edge weights of small faces (whose c0 runs
    # to ~1e3) and 1.3e-6 in depth. tests/test_torch_texgen.py's numpy sweep
    # below holds the plain twin to the exact arithmetic.
    assert np.abs(out.bary.numpy() - np.asarray(ref.bary))[same].max() < 3e-3
    assert np.abs(out.depth.numpy() - np.asarray(ref.depth))[same].max() < 3e-6
    assert int(out.overflow.abs().sum()) == 0
    return out, ref


def test_raster_plain_matches_pallas_on_sphere(wrapped):
    _, tr = _renders(wrapped)
    _, mvps = _mats(tr)
    vh = np.concatenate([tr.vtx_pos, np.ones((len(tr.vtx_pos), 1), np.float32)], 1)
    for mvp in mvps[:3]:
        _compare_raster(vh @ mvp.T, tr.pos_idx, 96, 80)
    uvc = tr.vtx_uv * 2.0 - 1.0
    uv_clip = np.stack([uvc[:, 0], -uvc[:, 1], np.zeros(len(uvc)), np.ones(len(uvc))],
                       1).astype(np.float32)
    _compare_raster(uv_clip, tr.pos_idx, 96, 96)


def _sweep_reference(verts, faces, h, w):
    """The TPU kernel's sweep in numpy fp32, one face at a time in ascending
    id with a strict z < best, from the port's own face records."""
    recs, bbox = (t.numpy() for t in face_setup(torch.from_numpy(verts),
                                                torch.from_numpy(faces), h, w))
    py, px = np.mgrid[0:h, 0:w].astype(np.float32)
    best = np.full((h, w), 2.0, np.float32)
    fid = np.full((h, w), -1, np.int32)
    w0s, w1s = np.zeros((h, w), np.float32), np.zeros((h, w), np.float32)
    for f, (r, (x0, x1, y0, y1)) in enumerate(zip(recs, bbox)):
        if x0 > x1:
            continue
        w0 = (r[2] + r[0] * px) + r[1] * py
        w1 = (r[5] + r[3] * px) + r[4] * py
        w2 = (np.float32(1) - w0) - w1
        z = np.clip((r[8] + w0 * r[6]) + w1 * r[7], 0, 1)
        upd = (w0 >= 0) & (w1 >= 0) & (w2 >= 0) & (z < best)
        best[upd], fid[upd], w0s[upd], w1s[upd] = z[upd], f, w0[upd], w1[upd]
    hit = fid >= 0
    bary = np.stack([w0s, w1s, (np.float32(1) - w0s) - w1s], -1) * hit[..., None]
    return fid, bary, np.where(hit, best, 0)


def test_raster_ties_degenerate_and_windings_match_pallas():
    rs = np.random.RandomState(0)
    v = rs.uniform(-0.9, 0.9, (300, 4)).astype(np.float32)
    v[:, 2] = rs.uniform(-0.5, 0.5, 300)
    v[:, 3] = 1.0
    f = rs.randint(0, 300, (200, 3)).astype(np.int32)
    f[1::2] = f[1::2, ::-1]                    # both windings
    f = np.concatenate([f, f[:20], [[0, 0, 1], [5, 5, 5]]]).astype(np.int32)  # exact ties, degenerate
    out, _ = _compare_raster(v, f, 64, 72, min_agree=0.999)
    fid = out.face_id.numpy()
    assert not np.isin(fid, np.arange(200, 220)).any()   # a depth tie goes to the lower id
    assert not np.isin(fid, [220, 221]).any()
    rf, rb, rz = _sweep_reference(v, f, 64, 72)
    np.testing.assert_array_equal(fid, rf)
    np.testing.assert_array_equal(out.bary.numpy(), rb)
    np.testing.assert_array_equal(out.depth.numpy(), rz)
    attrs = rs.rand(300, 5).astype(np.float32)
    img = interpolate(out, torch.from_numpy(f), torch.from_numpy(attrs)).numpy()
    ref = np.asarray(jrd.interpolate(rasterize_tpu(jnp.asarray(v), jnp.asarray(f), 64, 72),
                                     jnp.asarray(f), jnp.asarray(attrs)))
    same = fid == np.asarray(rasterize_tpu(jnp.asarray(v), jnp.asarray(f), 64, 72).face_id)
    assert np.abs(img - ref)[same].max() < 1e-4


def test_raster_kernel_entry_takes_only_cuda_tensors():
    """On the CPU the wrapper takes the plain twin; the kernel's own entry
    raises rather than fall back."""
    v = torch.tensor([[-0.5, -0.5, 0.0, 1.0], [0.5, -0.5, 0.0, 1.0], [0.0, 0.5, 0.0, 1.0]])
    f = torch.tensor([[0, 1, 2]], dtype=torch.int32)
    assert (rasterize(v, f, 8, 8).face_id == 0).any()
    with pytest.raises(ValueError):
        rasterize_cuda(v, f, 8, 8)


def test_bilinear_upsample_matches_jax_resize():
    rs = np.random.RandomState(1)
    view = rs.randint(0, 256, (16, 12, 3)).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(view), (64, 48, 3), "bilinear"))
    out = F.interpolate(torch.from_numpy(view).permute(2, 0, 1)[None], size=(64, 48),
                        mode="bilinear", align_corners=False, antialias=False)
    np.testing.assert_allclose(out[0].permute(1, 2, 0).numpy(), ref, atol=1e-4, rtol=0)


def test_cond_maps_match_jax(sphere):
    jr, tr = _renders(sphere)
    _, mvps = _mats(tr)
    jn, jp = jrd.cond_maps_tpu(jrd.upload_mesh(jr), jnp.asarray(mvps), 48)
    tn, tp = trd.cond_maps(trd.upload_mesh(tr, "cpu"), torch.from_numpy(mvps), 48)
    for out, ref in ((tn, jn), (tp, jp)):
        out, ref = out.numpy().astype(int), np.asarray(ref).astype(int)
        assert out.shape == ref.shape == (6, 48, 48, 3)
        close = (np.abs(out - ref) <= 1).all(-1)
        assert close.mean() >= 0.995, close.mean()


def test_bake_matches_jax(wrapped):
    jr, tr = _renders(wrapped)
    mvs, mvps = _mats(tr)
    gy, gx = np.mgrid[0:32, 0:32].astype(np.float32) / 31.0
    views = np.stack([np.stack([gx * 255, gy * 255, np.full_like(gx, 40.0 * i)], -1)
                      for i in range(6)]).astype(np.uint8)
    geom = jrd.prepare_bake_tpu(jrd.upload_mesh(jr, need_uv=True), jnp.asarray(mvs),
                                jnp.asarray(mvps), jnp.asarray(WEIGHTS, jnp.float32),
                                render_res=96, tex_res=64, up_res=96, exp=4.0)
    jtex, jtrust = jrd.bake_tpu_prepared(geom, jnp.asarray(views), 64, up_res=96)
    tgeom = trd.prepare_bake(trd.upload_mesh(tr, "cpu", need_uv=True), torch.from_numpy(mvs),
                             torch.from_numpy(mvps), WEIGHTS, render_res=96, tex_res=64,
                             up_res=96, exp=4.0)
    ttex, ttrust = trd.bake_prepared(tgeom, torch.from_numpy(views), 64, 96)
    jmask, tmask = np.asarray(jtrust) > 1e-8, ttrust.numpy() > 1e-8
    assert jmask.mean() > 0.2
    assert (jmask == tmask).mean() >= 0.995
    both = jmask & tmask
    close = (np.abs(ttex.numpy() - np.asarray(jtex)) <= 2 / 255).all(-1)[both]
    assert close.mean() >= 0.99, close.mean()


def test_mesh_uv_wrap_copy_gives_the_jax_uvs(sphere, wrapped):
    ref = j_uv_wrap(JMesh(sphere.vertices, sphere.faces))
    np.testing.assert_array_equal(wrapped.vertices, ref.vertices)
    np.testing.assert_array_equal(wrapped.faces, ref.faces)
    np.testing.assert_array_equal(wrapped.uv, ref.uv)


_SPLAT = r"""
import sys
import numpy as np
sys.path.insert(0, sys.argv[3])
if sys.argv[1] == "port":
    from hunyuan3d2_tpu_torch import native
else:
    from hunyuan3d2_tpu import native
rs = np.random.RandomState(0)
coords = rs.rand(20000, 2).astype(np.float32)
values = rs.rand(20000, 3).astype(np.float32)
np.save(sys.argv[2], native.grid_put_linear(coords, values, 96, 80))
"""


def test_native_copy_splat_runs_on_many_threads(tmp_path):
    """The JAX package's hy3d_grid_put_linear reads thread_local scratch from
    OpenMP workers (ROADMAP C.1); the port's copy hands it over by pointer
    and gives the single-thread result of the original under 4 threads."""
    outs = {}
    for which, threads in (("port", "4"), ("jax", "1")):
        env = dict(os.environ, OMP_NUM_THREADS=threads)
        path = str(tmp_path / f"{which}.npy")
        res = subprocess.run([sys.executable, "-c", _SPLAT, which, path, ROOT], env=env,
                             capture_output=True, text=True, timeout=300)
        assert res.returncode == 0, res.stderr[-2000:]
        outs[which] = np.load(path)
    # the JAX package builds its library with -march=native, where GCC
    # contracts the splat's multiply-adds into FMAs; the port's copy is built
    # for generic x86-64: last-ulp differences (measured ≤ 1.8e-7)
    np.testing.assert_allclose(outs["port"], outs["jax"], rtol=1e-6, atol=1e-7)


def _jax_turbo_noise(shape, n_steps):
    """The draws of the JAX turbo loop (hunyuanpaint.py _denoise_loop_lcm),
    replayed outside its jit: key 0 split once for the initial latents, then
    once per step."""
    key = jax.random.PRNGKey(0)
    key, k0 = jax.random.split(key)
    init = np.asarray(jax.random.normal(k0, shape, jnp.float32))
    noises = []
    for _ in range(n_steps):
        key, kn = jax.random.split(key)
        noises.append(np.asarray(jax.random.normal(kn, shape, jnp.float32)))
    return init, noises


def test_texgen_end_to_end_matches_jax(sphere, monkeypatch):
    """mesh + image → textured mesh: the tiny paint-turbo stack with the JAX
    package's weights and noise, 32² views, 2 steps, render and texture 96²."""
    from PIL import Image

    from hunyuan3d2_tpu.pipelines import multiview as jmv
    from hunyuan3d2_tpu.pipelines.texgen import Hunyuan3DPaintPipeline as JPipe
    from hunyuan3d2_tpu_torch import Hunyuan3DPaintPipeline
    from hunyuan3d2_tpu_torch.io import convert
    from hunyuan3d2_tpu_torch.pipelines import multiview as tmv

    monkeypatch.setenv("HY3D_DEVICE_BAKE", "force")
    views = {}

    def spy(cls, tag):
        orig = cls.__call__

        def call(self, *args, **kwargs):
            out = orig(self, *args, **kwargs)
            views[tag] = np.asarray(out.cpu() if isinstance(out, torch.Tensor) else out)
            return out

        monkeypatch.setattr(cls, "__call__", call)

    spy(jmv.Multiview_Diffusion_Net, "jax")
    spy(tmv.Multiview_Diffusion_Net, "port")

    img = np.zeros((64, 64, 4), np.uint8)
    img[12:52, 20:44, :3] = [200, 30, 30]
    img[20:40, 24:40, :3] = [30, 160, 220]
    img[12:52, 20:44, 3] = 255
    image = Image.fromarray(img)

    jpipe = JPipe.init_random(jax.random.PRNGKey(0), size="tiny", view_size=32, render_size=96,
                              texture_size=96, num_inference_steps=2)
    jinner = jpipe.models["multiview_model"].pipeline
    jinner.set_turbo(True)
    ref = jpipe(JMesh(sphere.vertices, sphere.faces), image)

    pipe = Hunyuan3DPaintPipeline.init_random(size="tiny", view_size=32, render_size=96,
                                              texture_size=96, num_inference_steps=2,
                                              device="cpu").set_turbo()
    inner = pipe.models["multiview_model"].pipeline
    convert.load_numpy_state_dict(inner.unet, convert.paint_unet_state_dict(
        jax.tree_util.tree_map(np.asarray, jinner.unet_params)))
    convert.load_numpy_state_dict(inner.vae, convert.sd_vae_state_dict(
        jax.tree_util.tree_map(np.asarray, jinner.vae_params)))
    init, noises = _jax_turbo_noise((1, 6, 16, 16, 4), 2)
    out = pipe(sphere, image, init_latents=init, step_noises=noises)

    assert out.texture.shape == ref.texture.shape == (96, 96, 3)
    np.testing.assert_array_equal(out.uv, ref.uv)
    np.testing.assert_array_equal(out.faces, ref.faces)
    np.testing.assert_allclose(out.vertices, ref.vertices, atol=1e-6)
    for name, a, b in (("views", views["port"], views["jax"]),
                       ("texture", out.texture, ref.texture)):
        a, b = a.astype(np.float64), b.astype(np.float64)
        assert a.shape == b.shape, name
        corr = np.corrcoef(a.ravel(), b.ravel())[0, 1]
        mad = np.abs(a - b).mean()
        # measured: views corr 0.9995, mean |Δ| 0.90 levels; texture corr
        # 0.9994, mean |Δ| 0.71 levels (bf16 UNet rounding, the u8 wire the
        # JAX path keeps)
        assert corr >= 0.99 and mad <= 3.0, (name, corr, mad)
