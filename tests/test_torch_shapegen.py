"""The image → mesh slice of the port against the JAX package, on the CPU.

The volume decoder and the surface nets are held to the JAX package exactly
on a shared field; the whole pipeline runs on both packages with the same
weights (carried by hunyuan3d2_tpu_torch/io/convert.py), the same image and
the same injected initial latents, and the final latents, the decoded grid
logits and the mesh are compared.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from hunyuan3d2_tpu.pipelines.shapegen import \
    Hunyuan3DDiTFlowMatchingPipeline as JaxPipeline
from hunyuan3d2_tpu.volume import decoders as jdec
from hunyuan3d2_tpu_torch.io import convert
from hunyuan3d2_tpu_torch.pipelines.shapegen import \
    Hunyuan3DDiTFlowMatchingPipeline as TorchPipeline
from hunyuan3d2_tpu_torch.volume import decoders as tdec

OCTREE = 32


def _field_j(pts):
    """An occupancy field with a surface: a wavy ball (inside > 0)."""
    r2 = (pts ** 2).sum(-1)
    return 0.55 - r2 + 0.05 * jnp.sin(7.0 * pts[..., 0])


def _field_t(pts):
    r2 = (pts ** 2).sum(-1)
    return 0.55 - r2 + 0.05 * torch.sin(7.0 * pts[..., 0])


@pytest.mark.parametrize("octree,num_chunks", [(32, 65536), (40, 4096)])
def test_flashvdm_decoder_matches(octree, num_chunks):
    """Same block choice and same grid: ragged blocks at 41, several chunks
    at num_chunks=4096."""
    jd, td = jdec.FlashVDMVolumeDecoding(), tdec.FlashVDMVolumeDecoding()
    _, jblk, _ = jd.decode_sparse(_field_j, 1, octree, num_chunks)
    _, tblk, _ = td.decode_sparse(_field_t, 1, octree, num_chunks)
    np.testing.assert_array_equal(tblk.numpy(), np.asarray(jblk))
    ref = np.asarray(jd(_field_j, 1, octree, num_chunks))
    out = td(_field_t, 1, octree, num_chunks).numpy()
    assert out.shape == ref.shape == (1, octree + 1, octree + 1, octree + 1)
    # f16 storage of the decoded values: half an f16 ulp at |value| <= 1
    np.testing.assert_allclose(out, ref, atol=1e-3)


@pytest.mark.parametrize("capacity,face_capacity", [(4096, 6144), (700, 900)],
                         ids=["fits", "overflows"])
def test_surface_nets_matches_on_the_same_grid(capacity, face_capacity):
    """On one grid the device surface nets agree exactly, overflow and
    stable truncation included."""
    grid = np.asarray(jdec.FlashVDMVolumeDecoding()(_field_j, 1, OCTREE))
    jv, jq, jnq, jcount, jok = jdec.surface_nets_from_grid(
        jnp.asarray(grid), 0.0, 1.01, capacity, face_capacity)
    tv, tq, tnq, tcount, tok = tdec.surface_nets_from_grid(
        torch.from_numpy(grid.copy()), 0.0, 1.01, capacity, face_capacity)
    assert (int(tnq), int(tcount), bool(tok)) == (int(jnq), int(jcount), bool(jok))
    assert bool(tok) == (capacity == 4096)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    n = min(int(tcount), capacity)
    np.testing.assert_allclose(tv.numpy()[:n], np.asarray(jv)[:n], atol=1e-6)
    np.testing.assert_array_equal(tdec.quads_to_tris(tq[:int(tnq)]),
                                  jdec.quads_to_tris(np.asarray(jq)[:int(jnq)]))


def _image():
    rs = np.random.RandomState(0)
    img = np.zeros((64, 64, 4), np.uint8)
    img[16:48, 16:48, :3] = rs.randint(0, 255, (32, 32, 3))
    img[16:48, 16:48, 3] = 255
    return Image.fromarray(img)


def _pipeline_pair(guidance_embed: bool = False):
    """Tiny pipelines on both packages with the JAX weights carried into the
    port and the same injected initial latents."""
    jp = JaxPipeline.init_random(jax.random.PRNGKey(0), size="tiny", dino="tiny",
                                 guidance_embed=guidance_embed)
    tp = TorchPipeline.init_random(size="tiny", dino="tiny", device="cpu",
                                   guidance_embed=guidance_embed)
    convert.load_numpy_state_dict(
        tp.model, convert.dit_state_dict(jax.device_get(jp.model_params), jp.model_cfg))
    convert.load_numpy_state_dict(
        tp.vae, convert.shapevae_state_dict(jax.device_get(jp.vae.params), jp.vae.cfg))
    convert.load_numpy_state_dict(
        tp.conditioner.main, convert.dinov2_state_dict(
            jax.device_get(jp.conditioner.main.params), jp.conditioner.main.cfg.dino))
    lat = np.random.RandomState(5).randn(1, jp.vae.cfg.num_latents,
                                         jp.vae.cfg.embed_dim).astype(np.float32)
    # the same initial latents on both instances (attributes, not code)
    jp.prepare_latents = lambda batch_size, key: jnp.asarray(lat)
    tp.prepare_latents = lambda batch_size, generator: torch.from_numpy(lat)
    jp.enable_flashvdm(True, mc_algo="dmc")
    tp.enable_flashvdm(mc_algo="dmc")
    return jp, tp


@pytest.fixture(scope="module")
def pipelines():
    return _pipeline_pair()


def test_guidance_distilled_sampling_matches():
    """A guidance-embedded (Fast) DiT takes the guidance as an embedding and
    runs no CFG batch: the same latents come out of both packages."""
    jp, tp = _pipeline_pair(guidance_embed=True)
    kw = dict(image=_image(), num_inference_steps=2, guidance_scale=5.0, output_type="latents")
    lat_j = np.asarray(jp(**kw))
    lat_t = tp(**kw).numpy()
    err = np.abs(lat_t - lat_j).max()
    assert err < 0.02 * np.abs(lat_j).max(), err


def test_slice_end_to_end_matches(pipelines, tmp_path):
    jp, tp = pipelines
    kw = dict(image=_image(), num_inference_steps=2, guidance_scale=5.0, seed=3)
    lat_j = np.asarray(jp(output_type="latents", **kw))
    lat_t = tp(output_type="latents", **kw)
    assert lat_t.dtype == torch.float32
    # bf16 model over 2 Euler steps from the same start
    err = np.abs(lat_t.numpy() - lat_j).max()
    assert err < 0.02 * np.abs(lat_j).max(), err

    grid_j = np.asarray(jp.vae.decode_grid(jnp.asarray(lat_j), OCTREE), np.float32)
    grid_t = tp.vae.decode_grid(lat_t, OCTREE).numpy()
    assert grid_t.shape == grid_j.shape == (1, OCTREE + 1, OCTREE + 1, OCTREE + 1)
    scale = np.abs(grid_j).max()
    assert np.abs(grid_t - grid_j).max() < 0.05 * scale
    assert np.corrcoef(grid_t.ravel(), grid_j.ravel())[0, 1] > 0.999

    mj = jp.vae.latents2mesh(jnp.asarray(lat_j), octree_resolution=OCTREE)[0]
    mt = tp.vae.latents2mesh(lat_t, octree_resolution=OCTREE)[0]
    nvj, nvt = len(mj.mesh_v), len(mt.mesh_v)
    nfj, nft = len(mj.mesh_f), len(mt.mesh_f)
    assert nvj > 0 and nfj > 0
    # grid points within the logit noise of 0 may flip sign (43 of 33³
    # here), adding or dropping a few cells: counts within 3 %, 99 % of the
    # port's vertices within a quarter cell of a JAX vertex, all within two
    assert abs(nvt - nvj) <= 0.03 * nvj and abs(nft - nfj) <= 0.03 * nfj, (nvj, nvt, nfj, nft)
    from scipy.spatial import cKDTree

    dist, _ = cKDTree(mj.mesh_v).query(mt.mesh_v)
    cell = 2 * 1.01 / OCTREE
    assert np.quantile(dist, 0.99) < 0.25 * cell and dist.max() < 2 * cell, (dist.max(), cell)

    # the public entry point end to end: image → [Mesh] → GLB
    mesh = tp(octree_resolution=OCTREE, **kw)[0]
    assert len(mesh.vertices) == nvt and len(mesh.faces) == nft
    assert mesh.faces.max() < len(mesh.vertices)
    assert np.abs(mesh.vertices).max() <= 1.01 + 1e-5
    out = os.path.join(tmp_path, "slice.glb")
    mesh.export(out)
    from hunyuan3d2_tpu_torch.geometry.mesh import Mesh

    back = Mesh.load(out)
    np.testing.assert_array_equal(back.faces, mesh.faces)
    np.testing.assert_array_equal(back.vertices, mesh.vertices)


def test_overflow_raises_unless_capped(pipelines, monkeypatch):
    """An overflow of the surface buffers without HY3D_CAP_ACTIVES falls back,
    as in the JAX package, to the host-assembled grid and the host surface
    nets (the same mesh in both packages); HY3D_CAP_ACTIVES=1 keeps the
    stable truncation instead."""
    jp, tp = pipelines
    from hunyuan3d2_tpu.models import shapevae as jsv
    from hunyuan3d2_tpu_torch.models import shapevae

    for mod in (jsv, shapevae):
        monkeypatch.setattr(mod, "active_capacity", lambda r: 64)
        monkeypatch.setattr(mod, "face_capacity", lambda r: 96)
    lat = np.random.RandomState(6).randn(1, 64, 64).astype(np.float32)
    monkeypatch.delenv("HY3D_CAP_ACTIVES", raising=False)
    jsv._grid_decode_jit.clear_cache()   # the capacities are fixed at trace time
    try:
        mj = jp.vae.latents2mesh(jnp.asarray(lat), octree_resolution=16)[0]
    finally:
        jsv._grid_decode_jit.clear_cache()
    mf = tp.vae.latents2mesh(torch.from_numpy(lat), octree_resolution=16)[0]
    assert len(mf.mesh_v) > 64 and len(mf.mesh_f) > 2 * 96
    assert abs(len(mf.mesh_v) - len(mj.mesh_v)) <= 0.03 * len(mj.mesh_v)
    assert abs(len(mf.mesh_f) - len(mj.mesh_f)) <= 0.03 * len(mj.mesh_f)
    from scipy.spatial import cKDTree

    dist, _ = cKDTree(mj.mesh_v).query(mf.mesh_v)
    cell = 2 * 1.01 / 16
    assert np.quantile(dist, 0.99) < 0.25 * cell and dist.max() < 2 * cell, (dist.max(), cell)
    monkeypatch.setenv("HY3D_CAP_ACTIVES", "1")
    m = tp.vae.latents2mesh(torch.from_numpy(lat), octree_resolution=16)[0]
    assert 0 < len(m.mesh_v) <= 64 and len(m.mesh_f) <= 2 * 96
    assert m.mesh_f.max() < len(m.mesh_v)
