"""The port's x4 upscale path (hunyuan3d2_tpu_torch: the plain UNet with
per-block cross-attention flags and both class embeddings, the DDIM and
low-res tables, pipelines/upscale.py, utils/imagesuper.py and its loader)
against the JAX package's, on the CPU at TINY sizes.

Weights are drawn by numpy into the JAX package's trees and carried over by
io/convert.py. The JAX loop splits its key in three (the low-res noise, then
x_T; no per-step noise); the draws are replayed outside its jit and injected
into the port's loop. Tolerances: the UNet within 5 % of the output scale
with correlation ≥ 0.999 in bf16, 1e-4 in fp32; tables equal; images
correlation ≥ 0.99 and mean |Δ| ≤ 3 levels; the LANCZOS default equal to
the JAX bytes.
"""

import dataclasses
import inspect
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from hunyuan3d2_tpu.models import sd_vae as jvae
from hunyuan3d2_tpu.pipelines import paint_schedulers as jps
from hunyuan3d2_tpu.pipelines import upscale as jup
from hunyuan3d2_tpu.utils import imagesuper as jis
from hunyuan3d2_tpu_torch.io import convert
from hunyuan3d2_tpu_torch.models import sd_vae as tvae
from hunyuan3d2_tpu_torch.ops.nn import build
from hunyuan3d2_tpu_torch.pipelines import paint_schedulers as tps
from hunyuan3d2_tpu_torch.pipelines import upscale as tup
from hunyuan3d2_tpu_torch.utils import imagesuper as tis
from tests import torch_sd_ref as ref

STEPS = 2
# the published x4-upscaler's schedulers: the DDIM denoise and the DDPM that
# noises the low-res image, with other betas
X4_SCHEDULER = {"num_train_timesteps": 1000, "beta_start": 0.0001, "beta_end": 0.02,
                "beta_schedule": "scaled_linear", "prediction_type": "v_prediction",
                "timestep_spacing": "leading", "steps_offset": 1}
X4_LOW_RES = {"num_train_timesteps": 1000, "beta_start": 0.0001, "beta_end": 0.02,
              "beta_schedule": "linear"}


@pytest.fixture(autouse=True)
def _one_torch_thread(monkeypatch):
    yield from ref.one_thread(monkeypatch)


TIMESTEP_TINY = dataclasses.replace(jup.X4_UNET_TINY, class_embed_type="timestep")


@pytest.mark.parametrize("dtype", ["bf16", "fp32"])
@pytest.mark.parametrize("cfg", [jup.X4_UNET_TINY, TIMESTEP_TINY], ids=["table", "timestep"])
def test_x4_unet_matches_jax(cfg, dtype):
    """7-channel conv_in, no attention in the first down block (nor the last
    up block), the noise level as class label through a table or a
    timestep MLP."""
    params = ref.jax_unet(cfg, seed=1)
    module = ref.port_unet(params, cfg)
    assert len(module.down_blocks[0].attentions) == 0 and len(module.up_blocks[-1].attentions) == 0
    assert len(module.down_blocks[1].attentions) == 1 and len(module.up_blocks[0].attentions) == 2
    rs = np.random.RandomState(0)
    x = rs.randn(2, 8, 8, 7).astype(np.float32)
    t = np.array([961.0, 41.0], np.float32)
    labels = np.array([20, 350], np.int32)
    ctx = rs.randn(2, 77, cfg.cross_attention_dim).astype(np.float32)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bf16" else (jnp.float32, torch.float32)
    out_j = ref.unet_apply(params, cfg, jnp.asarray(x, jdt), jnp.asarray(t), jnp.asarray(ctx, jdt),
                           jnp.asarray(labels))
    with torch.no_grad():
        out_t = module(torch.from_numpy(x).to(tdt), torch.from_numpy(t),
                       torch.from_numpy(ctx).to(tdt), torch.from_numpy(labels).long(), "r", 1, {})
    assert out_t.dtype == tdt and out_t.shape == (2, 8, 8, 4)
    (ref.assert_bf16_close if dtype == "bf16" else ref.assert_fp32_close)(out_t, out_j)


def test_x4_full_config_takes_head_64():
    cfg = ref.port_cfg(jup.X4_UNET)
    assert [c // cfg.heads(c) for c in cfg.block_out_channels] == [32, 64, 64, 128]
    assert [cfg.is_cross(i, True) for i in range(4)] == [False, True, True, True]
    assert [cfg.is_cross(i, False) for i in range(4)] == [True, True, True, False]
    assert tup.X4_VAE.block_out_channels == (128, 256, 512) and tup.X4_VAE.scaling_factor == 0.08333


@pytest.mark.parametrize("n", [2, 5, 50])
def test_ddim_and_low_res_tables_equal_jax(n):
    for cfg in ({}, X4_SCHEDULER):
        for a, b in zip(tps.DDIMScheduler.from_config(cfg).make_tables(n),
                        jps.DDIMScheduler.from_config(cfg).make_tables(n)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tps.alphas_cumprod_from_config(X4_LOW_RES),
                                  jps.alphas_cumprod_from_config(X4_LOW_RES))


def test_ddim_add_noise_and_step_match_jax():
    rs = np.random.RandomState(2)
    x, noise, out = (rs.randn(1, 4, 4, 4).astype(np.float32) for _ in range(3))
    for pred in ("v_prediction", "epsilon"):
        tsch = tps.DDIMScheduler.from_config({**X4_SCHEDULER, "prediction_type": pred})
        jsch = jps.DDIMScheduler.from_config({**X4_SCHEDULER, "prediction_type": pred})
        ac = tsch.alphas_cumprod().astype(np.float32)
        np.testing.assert_allclose(
            tsch.add_noise(torch.from_numpy(x), torch.from_numpy(noise), 20,
                           torch.from_numpy(ac)).numpy(),
            np.asarray(jsch.add_noise(jnp.asarray(x), jnp.asarray(noise), 20, jnp.asarray(ac))),
            atol=1e-6, rtol=0)
        for t, t_prev in ((801, 601), (1, -1)):
            a = tsch.step(torch.from_numpy(out), torch.from_numpy(x), t, t_prev,
                          torch.from_numpy(ac))[0].numpy()
            b = np.asarray(jsch.step(jnp.asarray(out), jnp.asarray(x), t, t_prev,
                                     jnp.asarray(ac))[0])
            np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)


def _jax_draws(seed, image_shape):
    """The JAX upscale loop's draws: split(key, 3) gives the low-res noise
    and x_T."""
    _, k1, k2 = jax.random.split(jax.random.PRNGKey(seed), 3)
    return ref.normal(k1, image_shape), ref.normal(k2, image_shape[:3] + (4,))


@pytest.fixture(scope="module")
def pipelines():
    """The JAX TINY pipeline with the x4 schedulers (seeded weights) and the
    port's with the same weights."""
    ucfg, vcfg = jup.X4_UNET_TINY, jup.X4_VAE_TINY
    params = ref.jax_unet(ucfg, seed=3)
    vae_params = ref.random_params(jvae.init, vcfg, seed=4)
    text = np.random.RandomState(3).randn(77, ucfg.cross_attention_dim).astype(np.float32) * 0.02
    lr = jps.alphas_cumprod_from_config(X4_LOW_RES)
    jpipe = jup.UpscalePipeline(params, ucfg, vae_params, vcfg, text, num_inference_steps=STEPS,
                                scheduler=jps.DDIMScheduler.from_config(X4_SCHEDULER),
                                low_res_alphas_cumprod=lr)
    vae = build(tvae.AutoencoderKL, tvae.SDVAEConfig(**dataclasses.asdict(vcfg)), device="cpu")
    convert.load_numpy_state_dict(vae, convert.sd_vae_state_dict(vae_params))
    tpipe = tup.UpscalePipeline(ref.port_unet(params, ucfg), vae, text,
                                num_inference_steps=STEPS,
                                scheduler=tps.DDIMScheduler.from_config(X4_SCHEDULER),
                                low_res_alphas_cumprod=lr, device="cpu")
    return jpipe, tpipe


def _image(h=16, w=24, seed=0):
    rs = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([yy * 255 // h, xx * 255 // w, 128 + 0 * xx], -1)
    return Image.fromarray(np.clip(base + rs.randint(-30, 30, (h, w, 3)), 0, 255).astype(np.uint8))


def test_upscale_pipeline_matches_jax(pipelines):
    jpipe, tpipe = pipelines
    img = _image()
    lowres, init = _jax_draws(1, (1, 16, 24, 3))
    out_j = jpipe(img, seed=1)
    out_t = tpipe(img, seed=1, lowres_noise=lowres, init_latents=init)
    assert out_t.size == out_j.size == (96, 64) and out_t.mode == "RGB"
    corr, mad = ref.image_agreement(out_t, out_j)
    assert corr >= 0.99 and mad <= 3.0, (corr, mad)


def test_upscale_low_res_table_is_used(pipelines):
    """The low-res noising reads its own ᾱ table: the same draws with the
    denoise table give another image; the seed decides the draws."""
    _, tpipe = pipelines
    img = _image(16, 16, seed=1)
    lowres, init = _jax_draws(2, (1, 16, 16, 3))
    a = tpipe(img, lowres_noise=lowres, init_latents=init)
    other = tup.UpscalePipeline(tpipe.unet, tpipe.vae, tpipe.text_embed.numpy(),
                                num_inference_steps=STEPS, scheduler=tpipe.scheduler,
                                device="cpu")
    assert not np.array_equal(np.asarray(a), np.asarray(other(img, lowres_noise=lowres,
                                                              init_latents=init)))
    assert np.array_equal(np.asarray(tpipe(img, seed=3)), np.asarray(tpipe(img, seed=3)))
    assert not np.array_equal(np.asarray(tpipe(img, seed=3)), np.asarray(tpipe(img, seed=4)))


@pytest.mark.parametrize("size", [(8, 8), (20, 12)])
def test_lanczos_default_equals_jax_bytes(size):
    img = _image(*size, seed=2)
    a, b = tis.Image_Super_Net()(img), jis.Image_Super_Net()(img)
    assert a.size == (size[1] * 4, size[0] * 4)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_image_super_net_with_pipeline_matches_jax(pipelines):
    jpipe, tpipe = pipelines
    img = _image(seed=3)   # the shape of the test above: the JAX loop is compiled once
    lowres, init = _jax_draws(0, (1, 16, 24, 3))
    out_t = tis.Image_Super_Net(pipeline=lambda im, prompt="": tpipe(
        im, prompt=prompt, lowres_noise=lowres, init_latents=init))(img)
    out_j = jis.Image_Super_Net(pipeline=jpipe)(img)
    corr, mad = ref.image_agreement(out_t, out_j)
    assert corr >= 0.99 and mad <= 3.0, (corr, mad)


def test_use_diffusion_without_a_checkpoint_raises():
    with pytest.raises(ValueError, match="not ported"):
        tis.Image_Super_Net(use_diffusion=True)


# ---------------------------------------------------------------------------
# loading a diffusers x4-upscaler directory
# ---------------------------------------------------------------------------
def _x4_dir(root, head, class_embed_type):
    """unet/ (down_block_types, the class embedding), vae/, scheduler/,
    low_res_scheduler/ and a tiny CLIP text encoder; the UNet at (64, 128)
    channels and 32 groups."""
    jcfg = dataclasses.replace(jup.X4_UNET_TINY, block_out_channels=(64, 128), norm_num_groups=32,
                               num_heads=head if isinstance(head, int) else None,
                               class_embed_type=class_embed_type)
    params = ref.jax_unet(jcfg, seed=5)
    # export_unet_core writes no timestep class MLP: its diffusers keys come
    # from the port's converter
    sd = (convert.unet_core_state_dict(params) if class_embed_type == "timestep"
          else ref.plain_unet_sd(params))
    config = ref.unet_config_json(jcfg, head)
    config["down_block_types"] = ["DownBlock2D", "CrossAttnDownBlock2D"]
    config.update({"class_embed_type": "timestep"} if class_embed_type == "timestep"
                  else {"class_embed_type": None, "num_class_embeds": 1000})
    ref.write_part(root, "unet", sd, config)
    vcfg = jup.X4_VAE_TINY
    ref.write_vae(root, ref.random_params(jvae.init, vcfg, seed=6), vcfg)
    for sub, cfg in (("scheduler", X4_SCHEDULER), ("low_res_scheduler", X4_LOW_RES)):
        os.makedirs(os.path.join(str(root), sub))
        with open(os.path.join(str(root), sub, "scheduler_config.json"), "w") as fh:
            json.dump(cfg, fh)
    ref.write_clip_text(root, jcfg.cross_attention_dim)
    return str(root)


@pytest.mark.parametrize("head,class_embed_type", [(2, "table"), ([1, 2], "timestep")],
                         ids=["int-table", "list-timestep"])
def test_both_packages_load_the_same_upscaler(tmp_path, head, class_embed_type):
    from hunyuan3d2_tpu.io import diffusers_maps as dm

    root = _x4_dir(tmp_path, head, class_embed_type)
    jl = dm.load_upscale_pipeline(jup.UpscalePipeline, root, num_inference_steps=STEPS)
    tl = tis.Image_Super_Net(types.SimpleNamespace(super_res_ckpt_path=root, device="cpu")).pipeline
    assert isinstance(tl, tup.UpscalePipeline) and tl.device.type == "cpu"
    assert ref.port_cfg(jl.ucfg) == tl.unet.cfg
    assert tl.unet.cfg.down_cross == (False, True)
    assert tl.unet.cfg.class_embed_type == class_embed_type
    assert [tl.unet.cfg.heads(c) for c in (64, 128)] == ([2, 2] if head == 2 else [1, 2])
    ref.assert_same_weights(tl.unet, convert.unet_core_state_dict(
        jax.tree.map(np.asarray, jl.unet_params)))
    ref.assert_same_weights(tl.vae, convert.sd_vae_state_dict(
        jax.tree.map(np.asarray, jl.vae_params)))
    assert tl.vae.cfg.scaling_factor == jl.vcfg.scaling_factor == 0.08333
    np.testing.assert_array_equal(tl.text_embed.numpy(), np.asarray(jl.text_embed))
    assert tl.scheduler == tps.DDIMScheduler(**dataclasses.asdict(jl.scheduler))
    np.testing.assert_array_equal(tl.low_res_alphas_cumprod, jl.low_res_alphas_cumprod)
    assert not np.allclose(tl.low_res_alphas_cumprod, tl.scheduler.alphas_cumprod())


def test_image_super_net_raises_on_a_bad_checkpoint(tmp_path):
    with pytest.raises(FileNotFoundError):
        tis.Image_Super_Net(types.SimpleNamespace(super_res_ckpt_path=str(tmp_path / "missing"),
                                                  device="cpu"))


def _names(fn):
    return [n for n, p in inspect.signature(fn).parameters.items()
            if p.kind not in (p.VAR_POSITIONAL, p.VAR_KEYWORD) and n != "key"]


@pytest.mark.parametrize("port,jax_fn", [
    (tup.UpscalePipeline.__call__, jup.UpscalePipeline.__call__),
    (tup.UpscalePipeline.init_random, jup.UpscalePipeline.init_random),
    (tis.Image_Super_Net.__init__, jis.Image_Super_Net.__init__),
    (tis.Image_Super_Net.__call__, jis.Image_Super_Net.__call__),
], ids=lambda f: getattr(f, "__qualname__", ""))
def test_signatures_keep_the_jax_parameter_names(port, jax_fn):
    """Each JAX parameter keeps its name and place (the JAX ``key`` is the
    port's ``seed``); the port may add keywords after them."""
    j = _names(jax_fn)
    assert _names(port)[:len(j)] == j
