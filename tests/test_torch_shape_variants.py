"""The shape variants of the port (the v2-0 streamed decode, the K/V-pruned
decode, the guidance-distilled "Fast" DiT and the multiview conditioner)
against the JAX package, on the CPU.

Inputs are made by numpy from a seed; weights are the JAX package's,
carried into the port by hunyuan3d2_tpu_torch/io/convert.py (the 3072-latent
and multiview stacks use the same mappers as slice 1). On the CPU the JAX
package sends > 1024 latents to the pruned decode unless
``HY3D_FUSED_GEO=force``, which runs its streamed decode with the Pallas
MLP tail in interpret mode; the port runs the stream's plain twins there, so
the JAX side of these tests runs under ``force`` (an autouse fixture).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from hunyuan3d2_tpu.models import conditioner as jcond
from hunyuan3d2_tpu.models import dinov2 as jdino
from hunyuan3d2_tpu.models import shapevae as jsv
from hunyuan3d2_tpu.ops import embeddings as jemb
from hunyuan3d2_tpu.ops.geo_decoder_pallas import fused_geo_decode_stream as jax_stream
from hunyuan3d2_tpu.pipelines.shapegen import Hunyuan3DDiTFlowMatchingPipeline as JaxPipeline
from hunyuan3d2_tpu.utils import imageproc as jimproc
from hunyuan3d2_tpu_torch.io import convert
from hunyuan3d2_tpu_torch.models import conditioner as tcond
from hunyuan3d2_tpu_torch.models import dinov2 as tdino
from hunyuan3d2_tpu_torch.models import shapevae as tsv
from hunyuan3d2_tpu_torch.ops import embeddings as temb
from hunyuan3d2_tpu_torch.ops import geo_decoder as tgeo
from hunyuan3d2_tpu_torch.ops.nn import build
from hunyuan3d2_tpu_torch.pipelines import shapegen as tshapegen
from hunyuan3d2_tpu_torch.pipelines.shapegen import Hunyuan3DDiTFlowMatchingPipeline as TorchPipeline
from hunyuan3d2_tpu_torch.utils import imageproc as timproc

# the smallest configs that pass the stream's gate (> 1024 latents, % 256,
# width % 128, head_dim 64) and that reach the pruned decode (>= 2048)
STREAM = jsv.ShapeVAEConfig(num_latents=1280, width=128, heads=2, num_decoder_layers=2)
PRUNED = jsv.ShapeVAEConfig(num_latents=2048, width=64, heads=2, num_decoder_layers=1)
SMALL_DINO = dict(hidden_size=128, num_layers=2, num_heads=2, patch_size=14, image_size=56,
                  swiglu_hidden=64)
OCTREE = 32


@pytest.fixture(autouse=True)
def _stream_on_the_jax_side(monkeypatch):
    monkeypatch.setenv("HY3D_FUSED_GEO", "force")


def _vae(cfg, seed=0):
    params = jax.device_get(jax.jit(jsv.init, static_argnums=1)(jax.random.PRNGKey(seed), cfg))
    vae = tsv.ShapeVAE.init_random(tsv.ShapeVAEConfig(**cfg.__dict__), device="cpu")
    return params, convert.load_numpy_state_dict(vae, convert.shapevae_state_dict(params, cfg))


def _kv(params, cfg, seed):
    lat = np.random.RandomState(seed).randn(1, cfg.num_latents, cfg.embed_dim)
    hidden = jsv.decode_latents(params, cfg, jnp.asarray(lat, jnp.float32))
    return tuple(np.array(a, np.float32) for a in jsv.compute_kv(params, cfg, hidden))


@pytest.fixture(scope="module")
def stream_vae():
    params, vae = _vae(STREAM)
    return params, vae, _kv(params, STREAM, 1)


def test_stream_gate_matches_jax():
    from hunyuan3d2_tpu.models.shapevae import _fused_geo_stream_enabled

    cfgs = [jsv.FULL, jsv.MINI, jsv.TINY, STREAM, PRUNED,
            jsv.ShapeVAEConfig(num_latents=1300, width=128, heads=2),
            jsv.ShapeVAEConfig(num_latents=2048, width=128, heads=4)]
    for cfg in cfgs:   # HY3D_FUSED_GEO=force: the JAX gate without its TPU test
        assert tgeo.fused_geo_stream_supported(cfg) == _fused_geo_stream_enabled(cfg), cfg
    assert tgeo.fused_geo_stream_supported(tsv.FULL)


@pytest.mark.parametrize("p", [700, 1500])
def test_stream_decode_matches_jax(stream_vae, p):
    """The port's streamed decode (plain twins on the CPU) against the JAX
    one (sdpa attention and the interpreted Pallas tail); P is ragged
    against the Pallas tile of 512."""
    params, vae, (k, v) = stream_vae
    pts = np.random.RandomState(p).uniform(-1.01, 1.01, (1, p, 3)).astype(np.float32)
    kv16 = (jnp.asarray(k, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16))
    ref = np.asarray(jax_stream(params, STREAM, jnp.asarray(pts), kv16), np.float32)
    tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (k, v))
    out = tgeo.fused_geo_decode_stream(vae, torch.from_numpy(pts), tk, tv)
    assert out.dtype == torch.float32 and tuple(out.shape) == ref.shape == (1, p)
    out = out.numpy()
    # the same rounding points (x2, LN3 and GELU outputs, ln_post to bf16)
    # with fp32 sums in another order: an element that lands on a bf16
    # rounding boundary flips by one ulp (2^-8 relative); 2.2e-3 of the
    # scale and 1 - corr = 8.5e-8 measured at P=700
    assert np.abs(out - ref).max() <= 1e-2 * max(1.0, np.abs(ref).max())
    assert np.corrcoef(out.ravel(), ref.ravel())[0, 1] > 0.99999


def test_mlp_tail_wrapper(stream_vae):
    """On a CPU tensor the tail's wrapper is its plain twin; it refuses what
    the kernel does not take."""
    _, vae, _ = stream_vae
    x2 = torch.from_numpy(np.random.RandomState(2).randn(1, 37, 128).astype(np.float32))
    x2 = x2.to(torch.bfloat16)
    before = tgeo.geo_mlp_tail.launches
    out = tgeo.geo_mlp_tail(vae, x2)
    assert tgeo.geo_mlp_tail.launches == before          # no kernel on the CPU
    np.testing.assert_array_equal(out.numpy(), tgeo.geo_mlp_tail_plain(vae, x2).numpy())
    assert out.dtype == torch.float32 and tuple(out.shape) == (1, 37)
    with pytest.raises(TypeError):
        tgeo.geo_mlp_tail(vae, x2.float())
    with pytest.raises(ValueError):
        tgeo.geo_mlp_tail(vae, x2[:, :, :64])
    with pytest.raises(ValueError):
        tgeo.geo_mlp_tail(vae, x2.transpose(0, 1))
    with pytest.raises(ValueError):
        tgeo.fused_geo_decode_stream(tsv.ShapeVAE.init_random(tsv.TINY, device="cpu"),
                                     torch.zeros(1, 4, 3), x2, x2)


def test_stream_refuses_width_over_tail_limit():
    """A 1280-wide config passes the stream's (JAX) gate. The MLP tail once
    refused it (its 32-row fp32 tile filled a block's shared memory); the
    tail's kernels no longer hold a row in shared memory, so the stream
    takes it and matches the JAX stream on the CPU."""
    cfg = jsv.ShapeVAEConfig(num_latents=1280, width=1280, heads=20, num_decoder_layers=1)
    assert tgeo.fused_geo_stream_supported(cfg)
    params, vae = _vae(cfg)
    k, v = _kv(params, cfg, 3)
    pts = np.random.RandomState(5).uniform(-1.01, 1.01, (1, 300, 3)).astype(np.float32)
    kv16 = (jnp.asarray(k, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16))
    ref = np.asarray(jax_stream(params, cfg, jnp.asarray(pts), kv16), np.float32)
    tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (k, v))
    out = tgeo.fused_geo_decode_stream(vae, torch.from_numpy(pts), tk, tv).numpy()
    assert out.shape == ref.shape == (1, 300)
    assert np.abs(out - ref).max() <= 1e-2 * max(1.0, np.abs(ref).max())
    assert np.corrcoef(out.ravel(), ref.ravel())[0, 1] > 0.99999


@pytest.mark.parametrize("latents,width,topk_mode,want", [
    (1280, 128, "mean", "stream"),
    (2048, 128, "mean", "stream"),
    (2048, 64, "merge", "pruned"),    # width 64 fails the stream's gate
    (2048, 64, "mean", "pruned"),
    (1280, 64, "mean", "dense"),      # no kernel takes it, < 2048 latents
    (512, 128, "mean", "fused"),
])
def test_query_decoder_routes_as_jax(monkeypatch, latents, width, topk_mode, want):
    """The FlashVDM decode function is chosen from the config's shape, as
    shapevae.py:258-306 chooses it on a TPU; the pruned decode gets the
    decoder's topk_mode and the k rule (2048 → 682)."""
    calls = []

    def spy(name, fn):
        def wrapped(*args, **kwargs):
            calls.append((name, args[4:]))
            return fn(*args, **kwargs)
        monkeypatch.setattr(tsv, name, wrapped)

    for name in ("fused_geo_decode_stream", "decode_queries_pruned", "decode_queries_plain",
                 "fused_geo_decode"):
        spy(name, getattr(tsv, name))
    cfg = tsv.ShapeVAEConfig(num_latents=latents, width=width, heads=2, num_decoder_layers=1)
    vae = tsv.ShapeVAE.init_random(cfg, device="cpu")
    vae.enable_flashvdm_decoder(topk_mode=topk_mode)
    lat = torch.from_numpy(np.random.RandomState(3).randn(1, latents, 64).astype(np.float32))
    grid = vae.decode_grid(lat, octree_resolution=8)
    assert tuple(grid.shape) == (1, 9, 9, 9) and torch.isfinite(grid).all()
    names = {"stream": "fused_geo_decode_stream", "pruned": "decode_queries_pruned",
             "dense": "decode_queries_plain", "fused": "fused_geo_decode"}
    assert calls and {n for n, _ in calls} == {names[want]}, calls
    if want == "pruned":   # (k_top, group size min(512, P), mode) per call
        assert {(a[0], a[2]) for _, a in calls} == {(682, topk_mode)}
        assert {a[1] for _, a in calls} == {27, 512}      # the 3³ coarse pass, then fine


@pytest.mark.parametrize("mode", ["mean", "merge"])
def test_pruned_decode_matches_jax(mode):
    """decode_queries_pruned in both modes, fp32 throughout (bf16 weights
    in both): only the order of fp32 sums differs, ~5e-7 measured."""
    params, vae = _vae(PRUNED, seed=1)
    k, v = _kv(params, PRUNED, 2)
    pts = np.random.RandomState(4).uniform(-1.01, 1.01, (1, 1024, 3)).astype(np.float32)
    k_top = tsv.pruned_k_top(PRUNED.num_latents)
    ref = np.asarray(jsv.decode_queries_pruned(params, PRUNED, jnp.asarray(pts),
                                               (jnp.asarray(k), jnp.asarray(v)), k_top, 512,
                                               mode=mode))
    out = tsv.decode_queries_pruned(vae, torch.from_numpy(pts), torch.from_numpy(k),
                                    torch.from_numpy(v), k_top, 512, mode).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-4 * max(1.0, np.abs(ref).max()))
    assert tsv.pruned_k_top(3072) == 1024 and tsv.pruned_k_top(512) == 256


def test_sincos_and_multiview_processor():
    for dim, pos in ((1536, [0, 1, 2, 3]), (128, [3, 1])):
        ref = jemb.sincos_1d_pos_embed(dim, jnp.asarray(pos))
        out = temb.sincos_1d_pos_embed(dim, torch.tensor(pos))
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6)
    rs = np.random.RandomState(5)
    views = {}
    for name in ("back", "front", "left"):          # no "right"; order comes from the processor
        img = np.zeros((48, 40, 4), np.uint8)
        img[8:40, 10:30] = rs.randint(0, 255, (32, 20, 4))
        img[8:40, 10:30, 3] = 255
        views[name] = Image.fromarray(img)
    ref = jimproc.MVImageProcessorV2(size=64)(views)
    out = timproc.MVImageProcessorV2(size=64)(views)
    assert out["view_idxs"] == ref["view_idxs"] == [[0, 1, 2]]
    for key in ("image", "mask"):
        assert out[key].shape == (1, 3, 64, 64, 3 if key == "image" else 1)
        np.testing.assert_array_equal(out[key], ref[key])


def test_multiview_encoder_matches_jax():
    """DinoImageEncoderMV tokens and the multiview uncond, with the DINOv2
    weights carried by the single-view mapper (the MV encoder adds none)."""
    dcfg = jdino.DinoConfig(**SMALL_DINO)
    params = jax.device_get(jax.jit(jdino.init, static_argnums=1)(jax.random.PRNGKey(0), dcfg))
    tcfg = tcond.DinoEncoderConfig(dino=tdino.DinoConfig(**SMALL_DINO), image_size=56)
    enc = build(tcond.DinoImageEncoderMV, tcfg, device="cpu")
    convert.load_numpy_state_dict(enc, convert.dinov2_state_dict(params, dcfg))
    jenc = jcond.SingleImageEncoder(jcond.DinoImageEncoderMV(
        params, jcond.DinoEncoderConfig(dino=dcfg, image_size=56)))
    tenc = tcond.SingleImageEncoder(enc)
    img = np.random.RandomState(6).uniform(-1, 1, (1, 3, 64, 64, 3)).astype(np.float32)
    view_idxs = [[0, 2, 3]]
    ref = jenc.encode_image(img, view_idxs)["main"]
    out = tenc.encode_image(img, view_idxs)["main"]
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == ref.shape == (1, 3 * 17, 128)
    err = np.abs(out.float().numpy() - np.asarray(ref, np.float32)).max()
    # bf16 activations through two layers, as test_torch_models holds DINOv2
    assert err <= 0.05 * np.abs(np.asarray(ref, np.float32)).max()
    # the pipeline's CFG cond: [cond | zeros of V views' tokens]
    pipe = TorchPipeline(vae=None, model=None, scheduler=None, conditioner=tenc, device="cpu")
    cond = pipe.encode_cond(img, True, view_idxs)
    assert tuple(cond.shape) == (2, 3 * 17, 128)
    assert torch.equal(cond[:1], out) and not cond[1].any()


def test_init_random_full_is_the_v2_0_stack(monkeypatch):
    """size="full" takes the FULL DiT (16 + 32 blocks) and the 3072-latent
    VAE, on cuda unless asked otherwise (built here as configs only)."""
    from hunyuan3d2_tpu_torch.models import dit as tdit

    built = []
    monkeypatch.setattr(tshapegen, "build", lambda cls, cfg, device, generator: (
        built.append((cls.__name__, cfg, str(device))) or torch.nn.Identity()))
    monkeypatch.setattr(torch, "Generator", lambda device: types.SimpleNamespace(
        manual_seed=lambda seed: None))
    pipe = TorchPipeline.init_random(size="full", guidance_embed=True, dino="giant")
    cfgs = {name: (cfg, dev) for name, cfg, dev in built}
    assert cfgs["ShapeVAE"] == (tsv.FULL, "cuda")
    dit_cfg, dev = cfgs["Hunyuan3DDiT"]
    assert dev == "cuda" and dit_cfg.guidance_embed
    assert (dit_cfg.depth, dit_cfg.depth_single_blocks, dit_cfg.hidden_size) == (16, 32, 1024)
    assert dit_cfg == tdit.DiTConfig(**{**tdit.FULL.__dict__, "guidance_embed": True})
    assert str(pipe.device) == "cuda"


def _image():
    rs = np.random.RandomState(0)
    img = np.zeros((64, 64, 4), np.uint8)
    img[16:48, 16:48, :3] = rs.randint(0, 255, (32, 32, 3))
    img[16:48, 16:48, 3] = 255
    return Image.fromarray(img)


@pytest.fixture(scope="module")
def v20_pipelines(stream_vae):
    """Tiny guidance-distilled DiT and tiny DINOv2 on both packages, with
    the 1280-latent (streamed) VAE and injected initial latents."""
    params, vae, _ = stream_vae
    jp = JaxPipeline.init_random(jax.random.PRNGKey(0), size="tiny", dino="tiny",
                                 guidance_embed=True)
    tp = TorchPipeline.init_random(size="tiny", dino="tiny", device="cpu", guidance_embed=True)
    jp.vae = jsv.ShapeVAE(params, STREAM)
    tp.vae = vae
    convert.load_numpy_state_dict(
        tp.model, convert.dit_state_dict(jax.device_get(jp.model_params), jp.model_cfg))
    convert.load_numpy_state_dict(
        tp.conditioner.main, convert.dinov2_state_dict(
            jax.device_get(jp.conditioner.main.params), jp.conditioner.main.cfg.dino))
    lat = np.random.RandomState(7).randn(1, STREAM.num_latents, STREAM.embed_dim)
    lat = lat.astype(np.float32)
    jp.prepare_latents = lambda batch_size, key: jnp.asarray(lat)
    tp.prepare_latents = lambda batch_size, generator: torch.from_numpy(lat)
    jp.enable_flashvdm(True, mc_algo="dmc")
    tp.enable_flashvdm(mc_algo="dmc")
    return jp, tp


def test_v20_fast_slice_end_to_end_matches(v20_pipelines):
    """Image → latents → octree-32 grid → mesh on both packages, held to
    test_torch_shapegen's tolerances."""
    jp, tp = v20_pipelines
    kw = dict(image=_image(), num_inference_steps=2, guidance_scale=5.0, seed=3)
    lat_j = np.asarray(jp(output_type="latents", **kw))
    lat_t = tp(output_type="latents", **kw)
    assert lat_t.dtype == torch.float32 and tuple(lat_t.shape) == (1, 1280, 64)
    # bf16 model over 2 Euler steps from the same start
    assert np.abs(lat_t.numpy() - lat_j).max() < 0.02 * np.abs(lat_j).max()

    grid_j = np.asarray(jp.vae.decode_grid(jnp.asarray(lat_j), OCTREE), np.float32)
    grid_t = tp.vae.decode_grid(lat_t, OCTREE).numpy()
    assert grid_t.shape == grid_j.shape == (1, OCTREE + 1, OCTREE + 1, OCTREE + 1)
    scale = np.abs(grid_j).max()
    assert np.abs(grid_t - grid_j).max() < 0.05 * scale
    assert np.corrcoef(grid_t.ravel(), grid_j.ravel())[0, 1] > 0.999

    mj = jp.vae.latents2mesh(jnp.asarray(lat_j), octree_resolution=OCTREE)[0]
    mt = tp.vae.latents2mesh(lat_t, octree_resolution=OCTREE)[0]
    nvj, nvt, nfj, nft = len(mj.mesh_v), len(mt.mesh_v), len(mj.mesh_f), len(mt.mesh_f)
    assert nvj > 0 and nfj > 0
    # grid points within the logit noise of 0 may flip sign, adding or
    # dropping a few cells: counts within 3 %, 99 % of the port's vertices
    # within a quarter cell of a JAX vertex, all within two
    assert abs(nvt - nvj) <= 0.03 * nvj and abs(nft - nfj) <= 0.03 * nfj, (nvj, nvt, nfj, nft)
    from scipy.spatial import cKDTree

    dist, _ = cKDTree(mj.mesh_v).query(mt.mesh_v)
    cell = 2 * 1.01 / OCTREE
    assert np.quantile(dist, 0.99) < 0.25 * cell and dist.max() < 2 * cell, (dist.max(), cell)


def test_multiview_slice_latents_match(v20_pipelines):
    """A 2-step run with three views through the multiview encoder and
    processor on both packages (the tiny tower's weights, shared)."""
    jp, tp = v20_pipelines
    jp_cond, tp_cond = jp.conditioner, tp.conditioner
    jp_proc, tp_proc = jp.image_processor, tp.image_processor
    try:
        jp.conditioner = jcond.SingleImageEncoder(jcond.DinoImageEncoderMV(
            jp_cond.main.params, jp_cond.main.cfg))
        tp.conditioner = tcond.SingleImageEncoder(tcond.DinoImageEncoderMV(
            tp_cond.main.cfg, model=tp_cond.main.model))
        jp.image_processor, tp.image_processor = jimproc.MVImageProcessorV2(), \
            timproc.MVImageProcessorV2()
        img = _image()
        views = {"front": img, "left": img.rotate(90), "back": img.transpose(Image.FLIP_LEFT_RIGHT)}
        kw = dict(image=views, num_inference_steps=2, guidance_scale=5.0, output_type="latents")
        lat_j = np.asarray(jp(**kw))
        lat_t = tp(**kw).numpy()
    finally:
        jp.conditioner, tp.conditioner = jp_cond, tp_cond
        jp.image_processor, tp.image_processor = jp_proc, tp_proc
    assert lat_t.shape == lat_j.shape == (1, 1280, 64)
    assert np.abs(lat_t - lat_j).max() < 0.02 * np.abs(lat_j).max()
