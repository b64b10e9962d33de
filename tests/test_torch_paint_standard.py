"""The port's standard paint path (hunyuan3d2_tpu_torch: the paint samplers,
the UNet's per-branch reference scale and single-stream pass, the voxel
indices, the EulerAncestral + CFG loop, the multiview wrapper's PIL control
images, mesh + image → textured mesh) against the JAX package's, on the CPU
at tiny sizes.

Weights are drawn by the JAX package and carried over by io/convert.py;
inputs are made by numpy from a seed. The JAX draws of the standard loop
(key 0 split once for the initial latents, then once per step) are replayed
outside its jit and handed to the port. The JAX texture pipeline runs its
device path, the Pallas rasterizer in interpret mode (HY3D_DEVICE_BAKE=force).
"""

import contextlib
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from hunyuan3d2_tpu.models import paint_unet as jpu
from hunyuan3d2_tpu.pipelines import paint_schedulers as jps
from hunyuan3d2_tpu_torch.io import convert
from hunyuan3d2_tpu_torch.models import paint_unet as tpu
from hunyuan3d2_tpu_torch.ops.nn import build
from hunyuan3d2_tpu_torch.pipelines import paint_schedulers as tps
from tests.test_torch_texgen import _jax_turbo_noise as _jax_loop_noise
from tests.test_torch_texgen import _sphere

STEPS = 2
VIEW = 32
# the TINY UNet at the paint UNet's head size (64), the one the checkpoint
# loader takes
JUCFG = dataclasses.replace(jpu.TINY, block_out_channels=(64, 128), attention_head_dim=64)
TUCFG = dataclasses.replace(tpu.TINY, block_out_channels=(64, 128), attention_head_dim=64)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _scale_err(out, ref):
    return np.abs(out - ref).max() / np.abs(ref).max()


# ---------------------------------------------------------------------------
# the samplers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("schedule", ["scaled_linear", "linear", "squaredcos_cap_v2"])
def test_beta_tables_equal_jax(schedule):
    np.testing.assert_array_equal(tps.make_betas(1000, 0.00085, 0.012, schedule),
                                  jps.make_betas(1000, 0.00085, 0.012, schedule))
    cfg = {"num_train_timesteps": 350, "beta_start": 0.0001, "beta_end": 0.02,
           "beta_schedule": schedule}
    np.testing.assert_array_equal(tps.alphas_cumprod_from_config(cfg),
                                  jps.alphas_cumprod_from_config(cfg))
    betas = jps.make_betas(1000, 0.00085, 0.012, schedule)
    np.testing.assert_array_equal(tps.rescale_zero_terminal_snr(betas),
                                  jps.rescale_zero_terminal_snr(betas))


@pytest.mark.parametrize("spacing", ["trailing", "leading", "linspace"])
@pytest.mark.parametrize("n", [30, 7])
def test_scheduler_tables_equal_jax(spacing, n):
    for rescale in (True, False):
        kw = dict(timestep_spacing=spacing, rescale_betas_zero_snr=rescale, steps_offset=1)
        out = tps.EulerAncestralDiscreteScheduler(**kw).make_tables(n)
        ref = jps.EulerAncestralDiscreteScheduler(**kw).make_tables(n)
        for a, b in zip(out, ref):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    cfg = {"timestep_spacing": spacing, "steps_offset": 1, "beta_schedule": "linear",
           "prediction_type": "epsilon", "unknown_key": 3}
    tddim, jddim = tps.DDIMScheduler.from_config(cfg), jps.DDIMScheduler.from_config(cfg)
    assert dataclasses.asdict(tddim) == dataclasses.asdict(jddim)
    for a, b in zip(tddim.make_tables(n), jddim.make_tables(n)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_standard_table_starts_at_zero_terminal_snr():
    ts, sigmas = tps.EulerAncestralDiscreteScheduler().make_tables(30)
    assert ts[0] == 999 and sigmas[-1] == 0
    # ᾱ_T = 2^-24: σ₀ = √(2^24 − 1)
    assert abs(sigmas[0] - 4096.0) < 1e-3


@pytest.mark.parametrize("prediction", ["v_prediction", "epsilon"])
@pytest.mark.parametrize("i", [0, 14, 29])
def test_euler_ancestral_step_matches_jax(prediction, i):
    tsched = tps.EulerAncestralDiscreteScheduler(prediction_type=prediction)
    jsched = jps.EulerAncestralDiscreteScheduler(prediction_type=prediction)
    _, sigmas = jsched.make_tables(30)
    rs = np.random.RandomState(i)
    model, noise = (rs.randn(2, 6, 8, 8, 4).astype(np.float32) for _ in range(2))
    sample = rs.randn(2, 6, 8, 8, 4).astype(np.float32) * sigmas[i]
    s, sn = jnp.float32(sigmas[i]), jnp.float32(sigmas[i + 1])
    ref, ref_x0 = jax.jit(jsched.step)(jnp.asarray(model), jnp.asarray(sample), s, sn,
                                       jnp.asarray(noise))
    ref_in = jax.jit(jsched.scale_model_input)(jnp.asarray(sample), s)
    out, out_x0 = tsched.step(torch.from_numpy(model), torch.from_numpy(sample), sigmas[i],
                              sigmas[i + 1], torch.from_numpy(noise))
    out_in = tsched.scale_model_input(torch.from_numpy(sample), sigmas[i])
    # fp32 scalar coefficients on both sides; XLA may fuse the elementwise
    # chain differently from PyTorch's one rounding per operation
    for o, r in ((out, ref), (out_x0, ref_x0), (out_in, ref_in)):
        r = np.asarray(r)
        assert o.dtype == torch.float32
        np.testing.assert_allclose(o.numpy(), r, rtol=1e-6, atol=1e-6 * np.abs(r).max())


@pytest.mark.parametrize("prediction", ["v_prediction", "epsilon"])
@pytest.mark.parametrize("t,t_prev", [(901, 801), (1, -1)])
def test_ddim_step_and_add_noise_match_jax(prediction, t, t_prev):
    sched = dict(prediction_type=prediction, timestep_spacing="trailing")
    tsched, jsched = tps.DDIMScheduler(**sched), jps.DDIMScheduler(**sched)
    _, ac = jsched.make_tables(10)
    rs = np.random.RandomState(t)
    model, sample, noise = (rs.randn(2, 8, 8, 4).astype(np.float32) for _ in range(3))
    ref, ref_x0 = jsched.step(jnp.asarray(model), jnp.asarray(sample), jnp.int32(t),
                              jnp.int32(t_prev), jnp.asarray(ac))
    tac = torch.from_numpy(ac)
    out, out_x0 = tsched.step(torch.from_numpy(model), torch.from_numpy(sample), t, t_prev, tac)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(out_x0.numpy(), np.asarray(ref_x0), rtol=1e-6, atol=1e-6)
    noisy = tsched.add_noise(torch.from_numpy(sample), torch.from_numpy(noise), t, tac)
    np.testing.assert_allclose(
        noisy.numpy(), np.asarray(jsched.add_noise(jnp.asarray(sample), jnp.asarray(noise), t,
                                                   jnp.asarray(ac))), rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# the UNet: CFG's per-branch reference scale, the single-stream pass
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dual", [True, False])
def test_unet_cfg_batch_with_branch_ref_scale_matches_jax(dual):
    """[uncond | cond] at batch 2: zero reference latents for uncond, the
    control latents and camera indices doubled, ref_scale [0, 1]. Without
    the dual copy the main UNet runs the 'w' pass itself, with the reference
    camera index."""
    jcfg = dataclasses.replace(jpu.TINY, use_dual_stream=dual)
    tcfg = dataclasses.replace(tpu.TINY, use_dual_stream=dual)
    up = jax.tree_util.tree_map(np.asarray, jpu.init(jax.random.PRNGKey(0), jcfg))
    unet = convert.load_numpy_state_dict(build(tpu.UNet2p5D, tcfg, device="cpu"),
                                         convert.paint_unet_state_dict(up))
    assert hasattr(unet, "unet_dual") == dual
    rs = np.random.RandomState(4)
    n, h = 3, 8
    samp = rs.randn(1, n, h, h, 4).astype(np.float32)
    samp = np.concatenate([samp, samp])
    nl, pl_ = (np.concatenate([a, a]) for a in (rs.randn(1, n, h, h, 4).astype(np.float32)
                                                 for _ in range(2)))
    ref = rs.randn(1, 1, h, h, 4).astype(np.float32)
    ref = np.concatenate([np.zeros_like(ref), ref])
    cam_gen, cam_ref = np.array([[12, 15, 40]] * 2), np.array([[2]] * 2)
    bf = lambda a: jnp.asarray(a, jnp.bfloat16)  # noqa: E731

    def jfwd(params, samp, nl, pl_, ref):
        return jpu.apply(params, jcfg, samp, jnp.float32(999.0), nl, pl_, ref,
                         jnp.asarray(cam_gen), jnp.asarray(cam_ref),
                         ref_scale=jnp.asarray([0.0, 1.0], jnp.float32))

    jout, jcache = jax.jit(jfwd)(up, bf(samp), bf(nl), bf(pl_), bf(ref))
    tb = lambda a: torch.from_numpy(a).bfloat16()  # noqa: E731
    with torch.no_grad():
        cache = unet.write_cache(tb(ref), torch.from_numpy(cam_ref))
        out = unet(tb(samp), 999.0, tb(nl), tb(pl_), torch.from_numpy(cam_gen), cache,
                   ref_scale=torch.tensor([0.0, 1.0]))
        # each branch alone, at its own scale and its own reference row
        alone = [unet(tb(samp[i:i + 1]), 999.0, tb(nl[i:i + 1]), tb(pl_[i:i + 1]),
                      torch.from_numpy(cam_gen[i:i + 1]),
                      {k: v[i:i + 1] for k, v in cache.items()}, ref_scale=float(i))
                 for i in (0, 1)]
    assert sorted(cache) == sorted(jcache)
    for k in cache:
        c, jc = _np(cache[k]).ravel(), _np(jcache[k]).ravel()
        # as test_unet_write_then_read_with_masks_matches_jax: bf16 LayerNorm
        # inputs deep in the 'w' pass
        assert _scale_err(c, jc) < 0.15 and np.corrcoef(c, jc)[0, 1] > 0.995, k
    jout, out = _np(jout), _np(out)
    assert out.shape == jout.shape == (2, n, h, h, 4)
    assert _scale_err(out, jout) < 0.05
    assert np.corrcoef(out.ravel(), jout.ravel())[0, 1] > 0.999
    # batch 1 against batch 2 on the CPU: the same arithmetic up to the
    # matmul kernels' blocking (bf16 outputs within a few ulps)
    for i in (0, 1):
        assert _scale_err(out[i:i + 1], _np(alone[i])) < 1e-2, i
    assert np.abs(out[0] - out[1]).max() > 0.05 * np.abs(out).max()


def _positions(rs, n=4, hw=64):
    pos = rs.randint(0, 256, (1, n, hw, hw, 3)).astype(np.float32) / 255.0
    pos[:, :, :6] = 1.0                       # background rows
    pos[:, 1, 32:, 32:] = (rs.rand(32, 32, 3) * 0.05 + 0.4).astype(np.float32)
    pos[:, 2, 40:, :24] = (rs.rand(24, 24, 3) * 0.2 + 0.6).astype(np.float32)
    return pos


@pytest.mark.parametrize("g,vr", [(8, 128), (16, 256), (4, 64)])
def test_discrete_voxel_indices_equal_jax(g, vr):
    pos = _positions(np.random.RandomState(g))
    ref = np.asarray(jpu.compute_discrete_voxel_indice(jnp.asarray(pos), g, vr))
    out = tpu.compute_discrete_voxel_indice(torch.from_numpy(pos), g, vr)
    assert out.dtype == torch.int32 and out.shape == ref.shape == (1, 4, g, g, 3)
    np.testing.assert_array_equal(out.numpy(), ref)
    assert (ref > 0).any()


def test_multi_resolution_indices_and_masks_equal_jax():
    pos = _positions(np.random.RandomState(11))
    grids, vres = (16, 8, 4), (256, 128, 64)
    ref = jpu.compute_multi_resolution_discrete_voxel_indice(jnp.asarray(pos), grids, vres)
    out = tpu.compute_multi_resolution_discrete_voxel_indice(torch.from_numpy(pos), grids, vres)
    assert sorted(out) == sorted(ref) == sorted(4 * g * g for g in grids)
    for k in ref:
        assert out[k]["voxel_resolution"] == ref[k]["voxel_resolution"]
        np.testing.assert_array_equal(out[k]["voxel_indices"].numpy(),
                                      np.asarray(ref[k]["voxel_indices"]))
    jm = jpu.compute_multi_resolution_mask(jnp.asarray(pos), grids)
    tm = tpu.compute_multi_resolution_mask(torch.from_numpy(pos), grids)
    assert sorted(tm) == sorted(jm)
    for k in jm:
        # as test_voxel_grid_mask_matches_jax: entries may differ only on the
        # distance threshold
        assert (tm[k].numpy() == np.asarray(jm[k])).mean() > 0.999


class _RecordingUNet:
    """Stands in for the UNet: records what the loop hands it and predicts
    v = 0.01·sample + branch, branch 0.5 for uncond and 1.5 for cond."""

    def __init__(self):
        self.cache_ref, self.cache_cam, self.calls = None, None, []

    def step_graphs(self):
        return contextlib.nullcontext()

    def write_cache(self, ref_latents, camera_info_ref=None):
        self.cache_ref, self.cache_cam = ref_latents.clone(), camera_info_ref.clone()
        return {"cache": True}

    def __call__(self, sample, t, normal, position, cam_gen, cache, ref_scale=1.0):
        self.calls.append(dict(sample=sample.clone(), t=t, normal=normal, position=position,
                               cam=cam_gen, ref_scale=ref_scale, cache=cache))
        branch = torch.tensor([0.5, 1.5]).reshape(2, 1, 1, 1, 1)
        return sample.float() * 0.01 + branch


def test_standard_loop_packs_cfg_as_the_jax_loop():
    """[uncond | cond] on the batch axis: zero reference latents for uncond
    in the one cache write, the control latents and cameras doubled, each
    step's input the same latents twice (scaled in fp32, then bf16),
    ref_scale [0, 1], uncond + g·(cond − uncond), then the step with its own
    draw."""
    from hunyuan3d2_tpu_torch.models import sd_vae
    from hunyuan3d2_tpu_torch.pipelines.hunyuanpaint import HunyuanPaintPipeline

    unet = _RecordingUNet()
    pipe = HunyuanPaintPipeline(unet, build(sd_vae.AutoencoderKL, sd_vae.TINY, device="cpu"),
                                view_size=16, device="cpu")
    rs = np.random.RandomState(12)
    n, h = 3, 8
    ref, normal, position = (torch.from_numpy(rs.randn(1, k, h, h, 4)).bfloat16()
                             for k in (1, n, n))
    cam_gen, cam_ref = torch.tensor([[12, 15, 40]]), torch.tensor([[0]])
    init = rs.randn(1, n, h, h, 4).astype(np.float32)
    noises = [rs.randn(1, n, h, h, 4).astype(np.float32) for _ in range(3)]
    sched = tps.EulerAncestralDiscreteScheduler()
    ts, sigmas = sched.make_tables(3)
    views = pipe.denoise(ref, normal, position, cam_gen, cam_ref, ts, sigmas, 2.0, init, noises)
    assert views.dtype == torch.uint8 and views.shape == (n, 2 * h, 2 * h, 3)
    assert torch.equal(unet.cache_ref[0], torch.zeros_like(ref[0]))
    assert torch.equal(unet.cache_ref[1], ref[0])
    assert torch.equal(unet.cache_cam, torch.cat([cam_ref, cam_ref]))
    latents = torch.from_numpy(init) * float(sigmas[0])
    assert len(unet.calls) == 3
    for i, call in enumerate(unet.calls):
        assert call["t"] == float(ts[i]) and call["cache"] == {"cache": True}
        assert torch.equal(call["ref_scale"], torch.tensor([0.0, 1.0]))
        for key, x in (("normal", normal), ("position", position), ("cam", cam_gen)):
            assert torch.equal(call[key], torch.cat([x, x])), key
        lat_in = sched.scale_model_input(torch.cat([latents, latents]), sigmas[i])
        assert torch.equal(call["sample"], lat_in.bfloat16())
        pred = call["sample"].float() * 0.01 + torch.tensor([0.5, 1.5]).reshape(2, 1, 1, 1, 1)
        pred = pred[0:1] + 2.0 * (pred[1:2] - pred[0:1])
        latents, _ = sched.step(pred, latents, sigmas[i], sigmas[i + 1],
                                torch.from_numpy(noises[i]))
    np.testing.assert_array_equal(views.numpy(), pipe._decode_views(latents).numpy())


# ---------------------------------------------------------------------------
# the standard loop, end to end
# ---------------------------------------------------------------------------
def _image():
    img = np.zeros((64, 64, 4), np.uint8)
    img[12:52, 20:44, :3] = [200, 30, 30]
    img[20:40, 24:40, :3] = [30, 160, 220]
    img[12:52, 20:44, 3] = 255
    return Image.fromarray(img)


def _spy(monkeypatch, cls, views, tag):
    orig = cls.__call__

    def call(self, *args, **kwargs):
        out = orig(self, *args, **kwargs)
        views[tag] = np.asarray(out.cpu() if isinstance(out, torch.Tensor) else out)
        return out

    monkeypatch.setattr(cls, "__call__", call)


def _close(name, a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (name, a.shape, b.shape)
    corr = np.corrcoef(a.ravel(), b.ravel())[0, 1]
    mad = np.abs(a - b).mean()
    # bf16 UNet rounding through the CFG-combined loop, the u8 wire the JAX
    # path keeps
    assert corr >= 0.99 and mad <= 3.0, (name, corr, mad)
    return corr, mad


@pytest.fixture(scope="module")
def jax_standard():
    """The JAX package's standard texture call: the tiny paint stack (key 0)
    with the UNet of JUCFG (key 5), 32² views, EulerAncestral 2 steps at CFG
    2.0, render and texture 96², and the views its multiview net returned."""
    from hunyuan3d2_tpu.geometry.mesh import Mesh as JMesh
    from hunyuan3d2_tpu.pipelines import multiview as jmv
    from hunyuan3d2_tpu.pipelines.texgen import Hunyuan3DPaintPipeline as JPipe

    sphere = _sphere()
    views = {}
    mp = pytest.MonkeyPatch()
    try:
        mp.setenv("HY3D_DEVICE_BAKE", "force")
        _spy(mp, jmv.Multiview_Diffusion_Net, views, "jax")
        jpipe = JPipe.init_random(jax.random.PRNGKey(0), size="tiny", view_size=VIEW,
                                  render_size=96, texture_size=96, num_inference_steps=STEPS)
        inner = jpipe.models["multiview_model"].pipeline
        assert not inner.is_turbo
        inner.unet_cfg, inner.unet_params = JUCFG, jpu.init(jax.random.PRNGKey(5), JUCFG)
        mesh = jpipe(JMesh(sphere.vertices, sphere.faces), _image())
    finally:
        mp.undo()
    params = (jax.tree_util.tree_map(np.asarray, inner.unet_params),
              jax.tree_util.tree_map(np.asarray, inner.vae_params))
    return sphere, mesh, views["jax"], params


def _port_check(pipe, jax_standard, monkeypatch):
    from hunyuan3d2_tpu_torch.pipelines import multiview as tmv
    from hunyuan3d2_tpu_torch.utils.timer import LAST_TIMINGS

    sphere, ref, jviews, _ = jax_standard
    views = {}
    _spy(monkeypatch, tmv.Multiview_Diffusion_Net, views, "port")
    init, noises = _jax_loop_noise((1, 6, VIEW // 2, VIEW // 2, 4), STEPS)
    LAST_TIMINGS.pop("Paint Denoising", None)
    out = pipe(sphere, _image(), init_latents=init, step_noises=noises)
    assert "Paint Denoising" in LAST_TIMINGS
    assert out.texture.shape == ref.texture.shape == (96, 96, 3)
    np.testing.assert_array_equal(out.uv, ref.uv)
    np.testing.assert_array_equal(out.faces, ref.faces)
    np.testing.assert_allclose(out.vertices, ref.vertices, atol=1e-6)
    # measured: views corr 0.9988, mean |Δ| 1.50 levels; texture corr 0.9985,
    # mean |Δ| 0.98 levels
    _close("views", views["port"], jviews)
    _close("texture", out.texture, ref.texture)


def test_standard_texgen_end_to_end_matches_jax(jax_standard, monkeypatch):
    """init_random without set_turbo: the standard loop, weights and draws
    from the JAX package."""
    from hunyuan3d2_tpu_torch import Hunyuan3DPaintPipeline

    pipe = Hunyuan3DPaintPipeline.init_random(size="tiny", view_size=VIEW, render_size=96,
                                              texture_size=96, num_inference_steps=STEPS,
                                              device="cpu")
    inner = pipe.models["multiview_model"].pipeline
    assert not inner.is_turbo
    assert isinstance(inner.scheduler, tps.EulerAncestralDiscreteScheduler)
    up, vp = jax_standard[3]
    inner.unet = convert.load_numpy_state_dict(build(tpu.UNet2p5D, TUCFG, device="cpu"),
                                               convert.paint_unet_state_dict(up))
    convert.load_numpy_state_dict(inner.vae, convert.sd_vae_state_dict(vp))
    _port_check(pipe, jax_standard, monkeypatch)
    # set_turbo switches the sampler, and back
    pipe.set_turbo()
    assert isinstance(inner.scheduler, tps.LCMScheduler)
    pipe.set_turbo(False)
    assert isinstance(inner.scheduler, tps.EulerAncestralDiscreteScheduler)


def test_standard_from_pretrained_matches_jax(jax_standard, monkeypatch, tmp_path):
    """unet/ and vae/ of hunyuan3d-paint-v2-0 written with the JAX package's
    diffusers exporters (fp32) load with the standard sampler and texture as
    the JAX package does."""
    from safetensors.numpy import save_file

    from hunyuan3d2_tpu.io import diffusers_maps as dm
    from hunyuan3d2_tpu.models import sd_vae as jvae
    from hunyuan3d2_tpu_torch import Hunyuan3DPaintPipeline
    from hunyuan3d2_tpu_torch.geometry.render import MeshRender

    up, vp = jax_standard[3]
    root = tmp_path / "hunyuan3d-paint-v2-0"
    for part, sd, cfg in (
            ("unet", dm.export_paint_unet(up), {
                "block_out_channels": list(JUCFG.block_out_channels),
                "layers_per_block": JUCFG.layers_per_block, "out_channels": 4,
                "cross_attention_dim": JUCFG.cross_attention_dim,
                "norm_num_groups": JUCFG.norm_num_groups}),
            ("vae", dm.export_sd_vae(vp), {
                "block_out_channels": list(jvae.TINY.block_out_channels),
                "layers_per_block": jvae.TINY.layers_per_block, "latent_channels": 4})):
        os.makedirs(root / part)
        (root / part / "config.json").write_text(json.dumps(cfg))
        save_file({k: np.asarray(v, np.float32) for k, v in sd.items()},
                  str(root / part / "diffusion_pytorch_model.safetensors"))
    pipe = Hunyuan3DPaintPipeline.from_pretrained(str(tmp_path), subfolder="hunyuan3d-paint-v2-0",
                                                  device="cpu")
    net = pipe.models["multiview_model"]
    assert pipe.config.pipe_name == "hunyuanpaint" and not net.pipeline.is_turbo
    assert net.pipeline.unet.cfg == TUCFG
    net.view_size = net.pipeline.view_size = VIEW
    net.num_inference_steps = STEPS
    pipe.render = MeshRender(default_resolution=96, texture_size=96)
    _port_check(pipe, jax_standard, monkeypatch)


def test_multiview_net_takes_pil_control_images(monkeypatch):
    """The reference's control list (N normal then N position PIL images,
    one of them a grey "L" image that becomes two-level) through both
    packages' Multiview_Diffusion_Net on the standard loop."""
    from hunyuan3d2_tpu.pipelines.hunyuanpaint import HunyuanPaintPipeline as JInner
    from hunyuan3d2_tpu.pipelines.multiview import Multiview_Diffusion_Net as JNet
    from hunyuan3d2_tpu_torch.pipelines.multiview import Multiview_Diffusion_Net

    rs = np.random.RandomState(7)
    maps = [Image.fromarray(rs.randint(0, 256, (48, 48, 3)).astype(np.uint8)) for _ in range(12)]
    maps[2] = Image.fromarray((rs.rand(48, 48) * 4).astype(np.uint8), mode="L")
    maps[8] = maps[8].convert("RGBA")
    cams = [12, 15, 18, 21, 40, 36]
    jnet = JNet.__new__(JNet)
    jnet.pipeline = JInner.init_random(jax.random.PRNGKey(3), size="tiny", view_size=VIEW)
    jnet.view_size, jnet.num_inference_steps = VIEW, STEPS
    ref = jnet(_image(), maps, cams, output_type="np")
    net = Multiview_Diffusion_Net.init_random("tiny", VIEW, STEPS, device="cpu")
    convert.load_numpy_state_dict(net.pipeline.unet, convert.paint_unet_state_dict(
        jax.tree_util.tree_map(np.asarray, jnet.pipeline.unet_params)))
    convert.load_numpy_state_dict(net.pipeline.vae, convert.sd_vae_state_dict(
        jax.tree_util.tree_map(np.asarray, jnet.pipeline.vae_params)))
    init, noises = _jax_loop_noise((1, 6, VIEW // 2, VIEW // 2, 4), STEPS)
    out = net(_image(), maps, cams, output_type="np", init_latents=init, step_noises=noises)
    # measured: corr 0.9984, mean |Δ| 1.56 levels
    assert out.dtype == np.float32 and out.shape == ref.shape == (6, VIEW, VIEW, 3)
    _close("views", out * 255.0, np.asarray(ref) * 255.0)
    # the list gives what the same maps give as device tensors
    from hunyuan3d2_tpu_torch.pipelines.hunyuanpaint import _control_array

    control = [im.resize((VIEW, VIEW)) for im in maps]
    control[2] = control[2].point(lambda x: 255 if x > 1 else 0, mode="1")
    stacked = torch.from_numpy(np.stack([_control_array(im, VIEW) for im in control]))
    assert set(np.unique(stacked[2].numpy())) <= {0, 255}
    dev = net(_image(), (stacked[:6], stacked[6:]), cams, output_type="np",
              init_latents=init, step_noises=noises)
    np.testing.assert_array_equal(dev, out)


def test_control_arrays_equal_the_jax_conversion():
    from hunyuan3d2_tpu.pipelines.hunyuanpaint import _pil_to_array_u8
    from hunyuan3d2_tpu_torch.pipelines.hunyuanpaint import _control_array

    rs = np.random.RandomState(9)
    rgba = Image.fromarray(rs.randint(0, 256, (40, 40, 4)).astype(np.uint8))
    for img in (rgba, rgba.convert("RGB"), rgba.convert("L"),
                rgba.convert("L").point(lambda x: 255 if x > 100 else 0, mode="1"),
                rs.rand(32, 32, 3).astype(np.float32), rs.randint(0, 256, (32, 32), np.uint8)):
        ref = np.asarray(_pil_to_array_u8(img, 32))
        if ref.dtype == bool:  # a two-level image: the JAX encode maps True to 1.0
            ref = ref.astype(np.uint8) * 255
        np.testing.assert_array_equal(_control_array(img, 32), ref)


def test_apps_random_paint_stack_samples_like_the_jax_apps(monkeypatch):
    """The apps' random-weight texture stack is Hunyuan3DPaintPipeline.init_random()
    as the JAX apps build it: the standard sampler, not paint-turbo."""
    import argparse

    from hunyuan3d2_tpu_torch.apps import api_server, gradio_app

    monkeypatch.setenv("HY3D_RANDOM_SIZE", "tiny")
    worker = api_server.ModelWorker(enable_tex=True, random_weights=True, device="cpu")
    gworker = gradio_app.GradioWorker(argparse.Namespace(
        model_path="", subfolder="", texgen_model_path="", enable_t23d=False, disable_tex=False,
        enable_flashvdm=False, mc_algo="mc", low_vram_mode=False, random_weights=True,
        device="cpu"))
    for pipe in (worker.pipeline_tex, gworker.tex_pipe):
        inner = pipe.models["multiview_model"].pipeline
        assert not inner.is_turbo
        assert isinstance(inner.scheduler, tps.EulerAncestralDiscreteScheduler)
