"""The port's host renderer and baker (hunyuan3d2_tpu_torch: geometry/render.py
MeshRender, the three native functions it adds, the texture pipeline's host
stage methods) against the JAX package's, on the CPU at small sizes.

Meshes are the surface-nets sphere of tests/test_torch_texgen.py and its UV
unwrap; a per-corner-UV copy of the unwrapped sphere (uv_idx ≠ pos_idx)
takes the un-fused paths. The JAX package's native splat
(``hunyuan3d2_tpu.native.grid_put_linear``) reads OpenMP scratch that its
workers do not have (ROADMAP C.1) and crashes on a multi-core host, so its
binding is patched to raise here: the JAX ``linear_grid_put_2d`` then takes
its numpy bincount version, which the port's native splat is held to.
"""

import inspect

import numpy as np
import pytest

from hunyuan3d2_tpu.geometry.mesh import Mesh as JMesh
from hunyuan3d2_tpu.geometry.render import MeshRender as JRender
from hunyuan3d2_tpu_torch import native
from hunyuan3d2_tpu_torch.geometry.mesh import Mesh
from hunyuan3d2_tpu_torch.geometry.render import MeshRender
from hunyuan3d2_tpu_torch.geometry.uv import mesh_uv_wrap
from tests.test_torch_texgen import VIEWS, WEIGHTS, _sphere

RES, TEX = 128, 96


@pytest.fixture(autouse=True)
def jax_splat_takes_numpy(monkeypatch):
    import hunyuan3d2_tpu.native as jnative

    def refuse(*args, **kwargs):
        raise RuntimeError("the JAX package's OpenMP splat is not run here (ROADMAP C.1)")

    monkeypatch.setattr(jnative, "grid_put_linear", refuse)


@pytest.fixture(scope="module")
def wrapped():
    return mesh_uv_wrap(_sphere())


def _renders(mesh, per_corner=False, res=RES, tex=TEX, **kw):
    """The JAX and port renders of ``mesh``; with ``per_corner`` its UVs are
    given per face corner (uv_idx = arange(3F))."""
    jr = JRender(default_resolution=res, texture_size=tex, **kw)
    tr = MeshRender(default_resolution=res, texture_size=tex, **kw)
    if per_corner:
        f = np.asarray(mesh.faces, np.int32)
        uv = mesh.uv[f].reshape(-1, 2)
        idx = np.arange(3 * len(f), dtype=np.int32).reshape(-1, 3)
        for r in (jr, tr):
            r.set_mesh(mesh.vertices, f, vtx_uv=uv, uv_idx=idx)
    else:
        jr.load_mesh(JMesh(mesh.vertices, mesh.faces, uv=mesh.uv))
        tr.load_mesh(mesh)
    return jr, tr


def _views(seed=0, n=len(VIEWS), size=RES, dtype=np.uint8):
    rs = np.random.RandomState(seed)
    gy, gx = np.mgrid[0:size, 0:size].astype(np.float32) / (size - 1)
    views = [np.stack([gx, gy, np.full_like(gx, i / n)], -1) * 0.8
             + rs.rand(size, size, 3).astype(np.float32) * 0.2 for i in range(n)]
    if dtype == np.uint8:
        return [np.round(v * 255).astype(np.uint8) for v in views]
    return views


def _same(out, ref, tol=1e-5):
    if isinstance(ref, tuple):
        assert isinstance(out, tuple) and len(out) == len(ref)
        for a, b in zip(out, ref):
            _same(a, b, tol)
        return
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape and out.dtype == ref.dtype, (out.shape, ref.shape)
    if out.dtype == bool or np.issubdtype(out.dtype, np.integer):
        np.testing.assert_array_equal(out, ref)
    else:
        np.testing.assert_allclose(out, ref, rtol=0, atol=tol)


# ---------------------------------------------------------------------------
# the native functions
# ---------------------------------------------------------------------------
def _random_clip(rs, n=400, m=300):
    v = rs.uniform(-0.9, 0.9, (n, 4)).astype(np.float32)
    v[:, 2] = rs.uniform(-0.5, 0.5, n)
    v[:, 3] = 1.0
    f = rs.randint(0, n, (m, 3)).astype(np.int32)
    return v, f


def test_native_rasterize_interp_matches_jax():
    import hunyuan3d2_tpu.native as jnative

    rs = np.random.RandomState(0)
    v, f = _random_clip(rs)
    attrs = rs.rand(len(v), 5).astype(np.float32)
    bufs = {}
    for h, w in ((64, 72), (33, 100)):
        ref = jnative.rasterize_interp(v, f, attrs, h, w)
        out = native.rasterize_interp(v, f, attrs, h, w, bufs=bufs)
        for a, b in zip(out, ref):
            _same(a, b)
        assert (ref[0] >= 0).mean() > 0.3
        # the buffers are reused on the next call of the same shape
        again = native.rasterize_interp(v, f, attrs, h, w, bufs=bufs)
        assert all(a is b for a, b in zip(again, out))
    with pytest.raises(ValueError):
        native.rasterize_interp(v, f, attrs[:-1], 8, 8)
    with pytest.raises(ValueError):
        native.rasterize_interp(v, f + len(v), attrs, 8, 8)


@pytest.mark.parametrize("u8", [False, True])
def test_native_bake_view_matches_jax(wrapped, u8):
    """One view's fused mask + splat + merge into a running texture, twice:
    the second call sees the first's trust (and is skipped as > 99 %
    painted)."""
    import hunyuan3d2_tpu.native as jnative

    jr, tr = _renders(wrapped)
    geom = tr.prepare_bake_geometry([0], [0])
    amap, fid, reliable = (np.array(a) for a in geom[0])
    size = 48 if u8 else RES
    image = _views(1, 1, size, np.uint8 if u8 else np.float32)[0]
    results = []
    for lib in (native, jnative):
        tex = np.zeros((TEX, TEX, 3), np.float32)
        trust = np.zeros((TEX, TEX), np.float32)
        fn = lib.bake_view_u8 if u8 else lib.bake_view
        merged = [fn(amap, fid, image, reliable, np.cos(75 / 180 * np.pi), 0.5, 4.0, tex, trust)
                  for _ in range(2)]
        results.append((merged, tex, trust))
    (m_out, tex_out, trust_out), (m_ref, tex_ref, trust_ref) = results
    assert m_out == m_ref == [True, False]
    _same(tex_out, tex_ref)
    _same(trust_out, trust_ref)
    assert (trust_ref > 0).mean() > 0.1
    with pytest.raises(ValueError):
        native.bake_view(amap[:-1], fid, image, reliable, 0.2, 1.0, 4.0, tex_out, trust_out)


def test_native_splat_into_a_reused_buffer_matches_jax_numpy():
    from hunyuan3d2_tpu.geometry.render import linear_grid_put_2d as jput
    from hunyuan3d2_tpu_torch.geometry.render import linear_grid_put_2d

    rs = np.random.RandomState(2)
    coords = rs.rand(5000, 2).astype(np.float32)
    values = rs.rand(5000, 4).astype(np.float32)
    buf = np.full((40, 56, 4), np.nan, np.float32)
    out = linear_grid_put_2d(40, 56, coords, values, out=buf)
    assert out is buf
    # the numpy version sums in float64 bincounts, the native one in fp32
    _same(out, jput(40, 56, coords, values))
    with pytest.raises(ValueError):
        linear_grid_put_2d(40, 56, coords, values, out=np.zeros((40, 56, 3), np.float32))


# ---------------------------------------------------------------------------
# MeshRender
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("camera_type", ["orth", "perspective"])
@pytest.mark.parametrize("abs_coor", [True, False])
def test_render_normal_position_depth_match_jax(wrapped, camera_type, abs_coor):
    jr, tr = _renders(wrapped, camera_type=camera_type)
    for elev, azim in VIEWS[:3]:
        _same(tr.render_normal(elev, azim, use_abs_coor=abs_coor),
              jr.render_normal(elev, azim, use_abs_coor=abs_coor))
        _same(tr.render_position(elev, azim, resolution=(64, 80)),
              jr.render_position(elev, azim, resolution=(64, 80)))
        _same(tr.render_depth(elev, azim), jr.render_depth(elev, azim))
        for a, b in zip(tr.render_normal_position(elev, azim, resolution=64),
                        jr.render_normal_position(elev, azim, resolution=64)):
            _same(a, b)
    pl = tr.render_normal(0, 0, return_type="pl")
    assert pl.size == (RES, RES)
    np.testing.assert_array_equal(np.asarray(pl),
                                  np.asarray(jr.render_normal(0, 0, return_type="pl")))


@pytest.mark.parametrize("per_corner", [False, True])
def test_textured_and_uv_space_renders_match_jax(wrapped, per_corner):
    jr, tr = _renders(wrapped, per_corner)
    tex = np.random.RandomState(3).rand(TEX, TEX, 3).astype(np.float32)
    for r in (jr, tr):
        r.set_texture(tex)
    _same(tr.get_texture(), jr.get_texture())
    for elev, azim in VIEWS[::2]:
        _same(tr.render(elev, azim), jr.render(elev, azim))
        _same(tr.render(elev, azim, keep_alpha=False, bgcolor=[1, 1, 1]),
              jr.render(elev, azim, keep_alpha=False, bgcolor=[1, 1, 1]))
    _same(tr.render_uvpos(), jr.render_uvpos())
    feat = np.random.RandomState(4).rand(len(tr.vtx_pos), 2).astype(np.float32)
    _same(tr.uv_feature_map(feat, bg=-1.0), jr.uv_feature_map(feat, bg=-1.0))
    depth = tr.render_depth(0, 90)
    _same(tr.render_sketch_from_depth(depth), jr.render_sketch_from_depth(depth))
    assert tr.render_sketch_from_depth(depth).max() == 1.0


def test_resolution_setters_match_jax(wrapped):
    jr, tr = _renders(wrapped)
    for r in (jr, tr):
        r.set_default_render_resolution(72)
        r.set_default_texture_resolution((48, 64))
    assert tr.default_resolution == jr.default_resolution == (72, 72)
    assert tr.texture_size == jr.texture_size == (48, 64)
    _same(tr.render_position(90, 0), jr.render_position(90, 0))
    _same(tr.render_uvpos(), jr.render_uvpos())


@pytest.mark.parametrize("per_corner", [False, True])
def test_back_project_matches_jax(wrapped, per_corner):
    jr, tr = _renders(wrapped, per_corner)
    views = _views(5)
    for view, (elev, azim) in zip(views[:3], VIEWS[:3]):
        out, ref = tr.back_project(view, elev, azim), jr.back_project(view, elev, azim)
        for a, b in zip(out, ref):
            _same(a, b)
        assert (ref[1] > 0).mean() > 0.05
    # the buffer-reusing call gives the same maps
    bufs = {}
    out = tr.back_project(views[0], *VIEWS[0], _bufs=bufs)
    for a, b in zip(out, jr.back_project(views[0], *VIEWS[0])):
        _same(a, b)


@pytest.mark.parametrize("per_corner", [False, True])
def test_bake_texture_and_fused_bake_match_jax(wrapped, per_corner):
    jr, tr = _renders(wrapped, per_corner)
    elevs, azims = [e for e, _ in VIEWS], [a for _, a in VIEWS]
    views = _views(6)
    ref_tex, ref_mask = jr.bake_texture(views, elevs, azims, exp=4, weights=WEIGHTS)
    for bake in (tr.bake_texture, tr.bake_texture_fused):
        tex, mask = bake(views, elevs, azims, exp=4, weights=WEIGHTS)
        _same(mask, ref_mask)
        _same(tex, ref_tex)
    _same(*(r.bake_texture_fused(views, elevs, azims, exp=4, weights=WEIGHTS)
            for r in (tr, jr)))
    assert ref_mask.mean() > 0.2
    # fast_bake_texture's > 99 % skip: a view repeated is not merged twice
    t, c, _ = tr.back_project(views[0], *VIEWS[0])
    once = tr.fast_bake_texture([t], [c])
    _same(tr.fast_bake_texture([t, t * 0.5], [c, c]), once)
    _same(once, jr.fast_bake_texture([t], [c]))


def test_prepared_bake_matches_jax(wrapped):
    """The colour-independent geometry, then uint8 views at their native
    size sampled at the raster's pixels."""
    jr, tr = _renders(wrapped)
    elevs, azims = [e for e, _ in VIEWS], [a for _, a in VIEWS]
    geom, jgeom = tr.prepare_bake_geometry(elevs, azims), jr.prepare_bake_geometry(elevs, azims)
    assert len(geom) == len(jgeom) == 6
    for g, jg in zip(geom, jgeom):
        for a, b in zip(g, jg):
            _same(a, b)
    views = np.stack(_views(7, size=48))
    out = tr.bake_texture_prepared(views, geom, exp=4, weights=WEIGHTS)
    ref = jr.bake_texture_prepared(views, jgeom, exp=4, weights=WEIGHTS)
    for a, b in zip(out, ref):
        _same(a, b)
    per_corner = _renders(wrapped, per_corner=True)[1]
    assert per_corner.prepare_bake_geometry(elevs, azims) is None


def test_texgen_host_stages_match_jax(wrapped):
    from hunyuan3d2_tpu.pipelines.texgen import Hunyuan3DPaintPipeline as JPipe
    from hunyuan3d2_tpu.pipelines.texgen import Hunyuan3DTexGenConfig as JConfig
    from hunyuan3d2_tpu_torch.pipelines.texgen import Hunyuan3DPaintPipeline, Hunyuan3DTexGenConfig

    pipes = []
    for pipe_cls, cfg_cls, kw in ((Hunyuan3DPaintPipeline, Hunyuan3DTexGenConfig,
                                   {"device": "cpu"}), (JPipe, JConfig, {})):
        cfg = cfg_cls()
        cfg.render_size, cfg.texture_size = RES, TEX
        pipes.append(pipe_cls({}, cfg, **kw))
    tp, jp = pipes
    tp.render.load_mesh(wrapped)
    jp.render.load_mesh(JMesh(wrapped.vertices, wrapped.faces, uv=wrapped.uv))
    elevs, azims = [e for e, _ in VIEWS], [a for _, a in VIEWS]
    for name, args in (("render_normal_multiview", (elevs, azims)),
                       ("render_position_multiview", (elevs, azims))):
        out, ref = getattr(tp, name)(*args, resolution=64), getattr(jp, name)(*args, resolution=64)
        assert len(out) == len(ref) == 6
        for a, b in zip(out, ref):
            assert a.mode == b.mode == "RGB"
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    views = _views(8)
    for a, b in zip(tp.bake_from_multiview(views, elevs, azims, WEIGHTS),
                    jp.bake_from_multiview(views, elevs, azims, WEIGHTS)):
        _same(a, b)
    with pytest.raises(ValueError):
        tp.bake_from_multiview(views, elevs, azims, WEIGHTS, method="slow")


def test_device_upload_refuses_per_corner_uvs(wrapped):
    from hunyuan3d2_tpu_torch.geometry.render_device import upload_mesh

    _, tr = _renders(wrapped, per_corner=True)
    with pytest.raises(ValueError, match="bake_texture_fused"):
        upload_mesh(tr, "cpu", need_uv=True)


def _names(fn):
    return [n for n, p in inspect.signature(fn).parameters.items()
            if p.kind not in (p.VAR_POSITIONAL, p.VAR_KEYWORD)]


RENDER_METHODS = ["load_mesh", "set_mesh", "get_mesh", "set_texture", "get_texture",
                  "set_default_render_resolution", "set_default_texture_resolution",
                  "render_normal", "render_position", "render_normal_position", "render_depth",
                  "render", "render_uvpos", "uv_feature_map", "render_sketch_from_depth",
                  "back_project", "fast_bake_texture", "bake_texture", "bake_texture_fused",
                  "prepare_bake_geometry", "bake_texture_prepared", "uv_inpaint", "save_mesh"]


@pytest.mark.parametrize("name", RENDER_METHODS)
def test_render_methods_keep_the_jax_parameter_names(name):
    assert _names(getattr(MeshRender, name)) == _names(getattr(JRender, name))


def test_stage_methods_keep_the_jax_parameter_names():
    from hunyuan3d2_tpu.pipelines.hunyuanpaint import HunyuanPaintPipeline as JInner
    from hunyuan3d2_tpu.pipelines.multiview import Multiview_Diffusion_Net as JNet
    from hunyuan3d2_tpu.pipelines.texgen import Hunyuan3DPaintPipeline as JPipe
    from hunyuan3d2_tpu_torch.pipelines.hunyuanpaint import HunyuanPaintPipeline
    from hunyuan3d2_tpu_torch.pipelines.multiview import Multiview_Diffusion_Net
    from hunyuan3d2_tpu_torch.pipelines.texgen import Hunyuan3DPaintPipeline

    for name in ("render_normal_multiview", "render_position_multiview", "bake_from_multiview",
                 "texture_inpaint", "recenter_image", "__call__"):
        j = _names(getattr(JPipe, name))
        assert _names(getattr(Hunyuan3DPaintPipeline, name))[:len(j)] == j, name
    j = _names(JNet.__call__)
    assert _names(Multiview_Diffusion_Net.__call__)[:len(j)] == j
    # the JAX call's ``key`` (a jax.random key) is the port's ``seed`` alone
    j = [n for n in _names(JInner.__call__) if n != "key"]
    assert _names(HunyuanPaintPipeline.__call__)[:len(j)] == j
    assert _names(HunyuanPaintPipeline.set_turbo) == _names(JInner.set_turbo)


def test_mesh_round_trip_through_the_renderer(wrapped, tmp_path):
    _, tr = _renders(wrapped)
    tr.set_texture(np.random.RandomState(9).randint(0, 256, (64, 64, 3)).astype(np.uint8))
    assert tr.get_texture().shape == (TEX, TEX, 3)
    out = tr.save_mesh()
    np.testing.assert_allclose(out.uv, wrapped.uv, atol=1e-6)
    np.testing.assert_allclose(out.vertices, tr.get_mesh()[0])
    path = str(tmp_path / "m.glb")
    out.export(path)
    back = MeshRender(texture_size=TEX)
    back.load_mesh(path)
    assert back.tex.shape == (TEX, TEX, 3)
    np.testing.assert_array_equal(back.pos_idx, tr.pos_idx)
    assert isinstance(Mesh.load(path), Mesh)
