"""The shape stack's decoders, extractors and meshing surface against the JAX
package, on the CPU.

The host extractors ('mc', 'mt', 'sn') are held to the JAX package exactly on
one SDF grid, from the dense grid and from the compacted active cells; the
vanilla and hierarchical decoders on the same tiny VAE (weights carried by
hunyuan3d2_tpu_torch/io/convert.py) within the f16 storage tolerance of
``test_flashvdm_decoder_matches``; ``latents2mesh`` with each extractor and
decoder, ``pipe(image)`` without ``enable_flashvdm`` and the host-assembled
overflow fallback within the mesh tolerances of
``tests/test_torch_shapegen.py``; and the public signatures to the JAX
package's.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from hunyuan3d2_tpu.models import shapevae as jsv
from hunyuan3d2_tpu.pipelines.shapegen import \
    Hunyuan3DDiTFlowMatchingPipeline as JaxPipeline
from hunyuan3d2_tpu.volume import decoders as jdec
from hunyuan3d2_tpu.volume import mc_table as jmc
from hunyuan3d2_tpu.volume import surface as jsurf
from hunyuan3d2_tpu_torch.io import convert
from hunyuan3d2_tpu_torch.models import shapevae as tsv
from hunyuan3d2_tpu_torch.pipelines.shapegen import \
    Hunyuan3DDiTFlowMatchingPipeline as TorchPipeline
from hunyuan3d2_tpu_torch.volume import decoders as tdec
from hunyuan3d2_tpu_torch.volume import mc_table as tmc
from hunyuan3d2_tpu_torch.volume import surface as tsurf

ALGOS = ("mc", "mt", "sn")


def _sdf_grid(r: int = 33, seed: int = 0) -> np.ndarray:
    """A wavy ball with noise (inside > 0): many cells, several ambiguous
    cases."""
    x = np.linspace(-1.0, 1.0, r)
    X, Y, Z = np.meshgrid(x, x, x, indexing="ij")
    noise = np.random.RandomState(seed).randn(r, r, r)
    g = 0.6 - np.sqrt(X ** 2 + Y ** 2 + Z ** 2) + 0.05 * np.sin(7 * X) + 0.02 * noise
    return g.astype(np.float32)


def _same_mesh(a, b):
    np.testing.assert_array_equal(b.mesh_v, a.mesh_v)
    np.testing.assert_array_equal(b.mesh_f, a.mesh_f)
    assert b.mesh_v.dtype == a.mesh_v.dtype and b.mesh_f.dtype == a.mesh_f.dtype


def test_mc_table_copy_matches():
    for name in ("CORNERS", "CUBE_EDGES", "NTRI", "TRI_TABLE"):
        np.testing.assert_array_equal(getattr(tmc, name), getattr(jmc, name))


@pytest.mark.parametrize("algo", ALGOS)
def test_extractor_matches_on_grid(algo):
    """Dense-grid extraction, batched (two grids), f32 and f16 input."""
    grids = np.stack([_sdf_grid(33, 0), _sdf_grid(33, 1)])
    for g in (grids, grids.astype(np.float16)):
        ref = jsurf.SurfaceExtractors[algo]()(g, mc_level=0.01, box_v=1.01)
        out = tsurf.SurfaceExtractors[algo]()(torch.from_numpy(g), mc_level=0.01, box_v=1.01)
        assert len(out) == len(ref) == 2
        for a, b in zip(ref, out):
            assert len(a.mesh_f) > 1000
            _same_mesh(a, b)


@pytest.mark.parametrize("capacity", [40000, 1500], ids=["fits", "overflows"])
def test_extract_active_cells_matches(capacity):
    """Ascending flat ids, -1 padding (or the stable truncation), fp16
    corner values and the count: equal."""
    g = _sdf_grid(41, 2)
    jc, jv, jn = jdec.extract_active_cells(jnp.asarray(g)[None], 0.0, capacity)
    tc, tv, tn = tdec.extract_active_cells(torch.from_numpy(g)[None], 0.0, capacity)
    assert tc.dtype == torch.int32 and tv.dtype == torch.float16
    assert int(tn) == int(jn) and (int(tn) > capacity) == (capacity == 1500)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("algo", ALGOS)
def test_extractor_from_actives_matches(algo):
    g = _sdf_grid(41, 3)
    cap = 20000
    jc, jv, jn = jdec.extract_active_cells(jnp.asarray(g), 0.0, cap)
    tc, tv, tn = tdec.extract_active_cells(torch.from_numpy(g), 0.0, cap)
    ref = jsurf.SurfaceExtractors[algo]().from_actives(jc, jv, int(jn), 41, 0.0, 1.01)
    out = tsurf.SurfaceExtractors[algo]().from_actives(tc, tv, int(tn), 41, 0.0, 1.01)
    assert len(ref.mesh_f) > 1000
    _same_mesh(ref, out)


def test_surface_nets_numpy_twin_matches_native():
    """The SN extractor's numpy twin against its native passes (the
    default): the same faces (the dense pass emits them in another order);
    vertices within the native build's multiply-add contraction."""
    g = _sdf_grid(33, 4)
    plain = tsurf.SurfaceNetsExtractor()
    plain.use_native = False
    a, b = tsurf.SurfaceNetsExtractor()(g[None])[0], plain(g[None])[0]
    np.testing.assert_array_equal(np.unique(b.mesh_f, axis=0), np.unique(a.mesh_f, axis=0))
    assert len(b.mesh_f) == len(a.mesh_f) > 1000
    np.testing.assert_allclose(b.mesh_v, a.mesh_v, atol=1e-6)
    cells = tsurf._active_cells(g, 0.0)
    vals = tsurf._gather_corner_vals(g, cells)
    vn, fn = tsurf._sn_from_actives(cells, vals, 33, 0.0)
    vp, fp = tsurf._sn_from_actives(cells, vals, 33, 0.0, use_native=False)
    np.testing.assert_array_equal(fp, fn)
    np.testing.assert_allclose(vp, vn, atol=1e-5)


def test_failed_extraction_gives_none():
    class Broken(tsurf.MarchingCubesExtractor):
        def _extract(self, grid, level):
            if grid.max() > 5:
                raise ValueError("bad grid")
            return super()._extract(grid, level)

    g = np.stack([_sdf_grid(17, 0), _sdf_grid(17, 0) + 10.0])
    out = Broken()(g)
    assert out[0] is not None and len(out[0].mesh_f) > 0 and out[1] is None


def test_assemble_sparse_grid_matches():
    def field_j(p):
        return 0.55 - (p ** 2).sum(-1) + 0.05 * jnp.sin(7.0 * p[..., 0])

    def field_t(p):
        return 0.55 - (p ** 2).sum(-1) + 0.05 * torch.sin(7.0 * p[..., 0])

    jd, td = jdec.HierarchicalVolumeDecoding(), tdec.HierarchicalVolumeDecoding()
    js = jd.decode_sparse(field_j, 1, 40, 4096)
    ts = td.decode_sparse(field_t, 1, 40, 4096)
    ref = jdec.assemble_sparse_grid(*js, 40, jd.block, jd.coarse_factor)
    out = tdec.assemble_sparse_grid(*ts, 40, td.block, td.coarse_factor)
    assert out.shape == ref.shape == (1, 41, 41, 41) and out.dtype == np.float16
    np.testing.assert_allclose(out.astype(np.float32), ref.astype(np.float32), atol=1e-3)


# ---------------------------------------------------------------------------
# the VAE's decoders and latents2mesh
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def vaes():
    """The tiny VAE on both packages, the same weights, and random latents."""
    jvae = jsv.ShapeVAE.init_random(jax.random.PRNGKey(1), jsv.TINY)
    tvae = tsv.ShapeVAE.init_random(tsv.TINY, device="cpu")
    convert.load_numpy_state_dict(
        tvae, convert.shapevae_state_dict(jax.device_get(jvae.params), jvae.cfg))
    lat = np.random.RandomState(7).randn(1, 64, 64).astype(np.float32)
    return jvae, tvae, lat


def _enable(vae, kind, mc_algo="mc"):
    if kind == "vanilla":
        vae.enable_flashvdm_decoder(enabled=False)
    else:
        vae.enable_flashvdm_decoder(mc_algo=mc_algo,
                                    adaptive_kv_selection=(kind == "flashvdm"))


@pytest.mark.parametrize("kind,octree,num_chunks", [
    ("vanilla", 24, 4096), ("hierarchical", 32, 65536), ("hierarchical", 40, 4096)])
def test_volume_decoder_grid_matches(vaes, kind, octree, num_chunks):
    """The plain fp32 decode on both sides: the device grid (vanilla in
    several chunks, hierarchical with ragged blocks at 41) and the host grid
    of ``to_host``, within the f16 storage of the decoded values."""
    jvae, tvae, lat = vaes
    _enable(jvae, kind)
    _enable(tvae, kind)
    ref = np.asarray(jvae.decode_grid(jnp.asarray(lat), octree, num_chunks))
    out = tvae.decode_grid(torch.from_numpy(lat), octree, num_chunks).numpy()
    assert out.shape == ref.shape == (1, octree + 1, octree + 1, octree + 1)
    assert np.abs(ref).max() > 0.05
    np.testing.assert_allclose(out, ref, atol=1e-3)
    ref_h = jvae.decode_grid(jnp.asarray(lat), octree, num_chunks, to_host=True)
    out_h = tvae.decode_grid(torch.from_numpy(lat), octree, num_chunks, to_host=True)
    assert out_h.shape == ref_h.shape and out_h.dtype == ref_h.dtype
    np.testing.assert_allclose(out_h.astype(np.float32), ref_h.astype(np.float32), atol=1e-3)


def _close_meshes(mj, mt, octree):
    """tests/test_torch_shapegen.py's mesh tolerances: grid points within the
    logit noise of 0 may flip sign, adding or dropping a few cells."""
    nvj, nvt, nfj, nft = len(mj.mesh_v), len(mt.mesh_v), len(mj.mesh_f), len(mt.mesh_f)
    assert nvj > 0 and nfj > 0
    assert abs(nvt - nvj) <= 0.03 * nvj and abs(nft - nfj) <= 0.03 * nfj, (nvj, nvt, nfj, nft)
    assert mt.mesh_f.min() >= 0 and mt.mesh_f.max() < nvt
    dist, _ = cKDTree(mj.mesh_v).query(mt.mesh_v)
    cell = 2 * 1.01 / octree
    assert np.quantile(dist, 0.99) < 0.25 * cell and dist.max() < 2 * cell, (dist.max(), cell)


@pytest.mark.parametrize("kind,mc_algo", [
    ("flashvdm", "mc"), ("flashvdm", "mt"), ("flashvdm", "dmc"), ("flashvdm", "sn"),
    ("hierarchical", "mc"), ("vanilla", "mc")])
def test_latents2mesh_matches(vaes, kind, mc_algo):
    jvae, tvae, lat = vaes
    _enable(jvae, kind, mc_algo)
    _enable(tvae, kind, mc_algo)
    assert type(tvae.surface_extractor).__name__ == type(jvae.surface_extractor).__name__
    mj = jvae.latents2mesh(jnp.asarray(lat), octree_resolution=32)
    mt = tvae.latents2mesh(torch.from_numpy(lat), octree_resolution=32)
    assert len(mt) == len(mj) == 1
    _close_meshes(mj[0], mt[0], 32)


def test_mc_algo_picks_only_an_unset_extractor(vaes):
    _, tvae, lat = vaes
    tvae.enable_flashvdm_decoder(mc_algo="dmc")
    tvae.latents2mesh(torch.from_numpy(lat), octree_resolution=16, mc_algo="mt")
    assert isinstance(tvae.surface_extractor, tsurf.SurfaceNetsExtractor)
    tvae.volume_decoder = tvae.surface_extractor = None
    tvae.latents2mesh(torch.from_numpy(lat), octree_resolution=16, mc_algo="mt")
    assert isinstance(tvae.volume_decoder, tdec.VanillaVolumeDecoder)
    assert isinstance(tvae.surface_extractor, tsurf.MarchingTetrahedraExtractor)
    with pytest.raises(ValueError, match="Unsupported mc_algo"):
        tvae.enable_flashvdm_decoder(mc_algo="marching")


def _force_overflow(monkeypatch, capacity, face_cap):
    """Tiny buffers in both packages; the JAX grid decode is traced anew
    (its capacities are fixed at trace time)."""
    for mod in (jsv, tsv):
        monkeypatch.setattr(mod, "active_capacity", lambda r: capacity)
        monkeypatch.setattr(mod, "face_capacity", lambda r: face_cap)
    jsv._grid_decode_jit.clear_cache()
    monkeypatch.delenv("HY3D_CAP_ACTIVES", raising=False)


@pytest.mark.parametrize("kind,mc_algo", [("flashvdm", "mc"), ("hierarchical", "mt")])
def test_uncapped_overflow_falls_back_to_host_grid(vaes, monkeypatch, kind, mc_algo):
    """An active-cell overflow without HY3D_CAP_ACTIVES: the host-assembled
    grid (nearest-neighbour background, f16) and the dense host extractor,
    in both packages."""
    jvae, tvae, lat = vaes
    _enable(jvae, kind, mc_algo)
    _enable(tvae, kind, mc_algo)
    _force_overflow(monkeypatch, 64, 96)
    try:
        mj = jvae.latents2mesh(jnp.asarray(lat), octree_resolution=28)[0]
        mt = tvae.latents2mesh(torch.from_numpy(lat), octree_resolution=28)[0]
    finally:
        jsv._grid_decode_jit.clear_cache()
    assert len(mt.mesh_v) > 64
    _close_meshes(mj, mt, 28)


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------
def _image():
    from PIL import Image

    rs = np.random.RandomState(0)
    img = np.zeros((64, 64, 4), np.uint8)
    img[16:48, 16:48, :3] = rs.randint(0, 255, (32, 32, 3))
    img[16:48, 16:48, 3] = 255
    return Image.fromarray(img)


def test_pipeline_without_enable_flashvdm_matches():
    """``pipe(image)`` on a pipeline where enable_flashvdm was never called:
    the vanilla decode and dense marching cubes in both packages, with the
    same weights and the same initial latents."""
    jp = JaxPipeline.init_random(jax.random.PRNGKey(0), size="tiny", dino="tiny")
    tp = TorchPipeline.init_random(size="tiny", dino="tiny", device="cpu")
    convert.load_numpy_state_dict(
        tp.model, convert.dit_state_dict(jax.device_get(jp.model_params), jp.model_cfg))
    convert.load_numpy_state_dict(
        tp.vae, convert.shapevae_state_dict(jax.device_get(jp.vae.params), jp.vae.cfg))
    convert.load_numpy_state_dict(
        tp.conditioner.main, convert.dinov2_state_dict(
            jax.device_get(jp.conditioner.main.params), jp.conditioner.main.cfg.dino))
    lat = np.random.RandomState(5).randn(1, 64, 64).astype(np.float32)
    jp.prepare_latents = lambda batch_size, key: jnp.asarray(lat)
    tp.prepare_latents = lambda batch_size, generator: torch.from_numpy(lat)
    kw = dict(num_inference_steps=2, guidance_scale=5.0, octree_resolution=32, seed=3,
              enable_pbar=False)
    mj = jp(_image(), output_type="raw", **kw)
    mt = tp(_image(), output_type="raw", **kw)
    assert isinstance(tp.vae.volume_decoder, tdec.VanillaVolumeDecoder)
    assert isinstance(tp.vae.surface_extractor, tsurf.MarchingCubesExtractor)
    _close_meshes(mj[0], mt[0], 32)
    mesh = tp(_image(), **kw)[0]
    assert len(mesh.faces) == len(mt[0].mesh_f)


def test_public_signatures_match():
    """Parameter names, order and defaults of the meshing surface; the one
    allowed difference is the port's ``generator`` where JAX takes ``key``."""
    pairs = [
        (JaxPipeline.__call__, TorchPipeline.__call__),
        (JaxPipeline._export, TorchPipeline._export),
        (JaxPipeline.enable_flashvdm, TorchPipeline.enable_flashvdm),
        (jsv.ShapeVAE.enable_flashvdm_decoder, tsv.ShapeVAE.enable_flashvdm_decoder),
        (jsv.ShapeVAE.latents2mesh, tsv.ShapeVAE.latents2mesh),
        (jsv.ShapeVAE.decode_grid, tsv.ShapeVAE.decode_grid),
    ]
    for jf, tf in pairs:
        js = [(n, p.default, p.kind) for n, p in inspect.signature(jf).parameters.items()]
        ts = [(n, p.default, p.kind) for n, p in inspect.signature(tf).parameters.items()]
        js = [("generator", None, k) if n == "key" else (n, d, k) for n, d, k in js]
        assert ts == js, (jf.__qualname__, js, ts)
