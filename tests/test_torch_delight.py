"""The port's delight path (hunyuan3d2_tpu_torch: the plain SD UNet with a
head count, the IP2P sampler, pipelines/delight.py, utils/dehighlight.py and
its loader) against the JAX package's, on the CPU at TINY sizes.

Weights are drawn by the JAX package and carried over by io/convert.py;
inputs are made by numpy from a seed. The JAX loop draws inside its jit (key
split once for x_T, then once a step); the draws are replayed outside it and
injected into the port's loop. Tolerances: the UNet within 5 % of the output
scale with correlation ≥ 0.999 in bf16, 1e-4 in fp32; scheduler tables
equal; images correlation ≥ 0.99 and mean |Δ| ≤ 3 levels; the statistics
stage equal to the JAX bytes.
"""

import inspect
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from hunyuan3d2_tpu.pipelines import delight as jdl
from hunyuan3d2_tpu.utils import dehighlight as jdh
from hunyuan3d2_tpu_torch.io import convert
from hunyuan3d2_tpu_torch.models import paint_unet as tpu
from hunyuan3d2_tpu_torch.models import sd_vae as tvae
from hunyuan3d2_tpu_torch.ops.nn import build
from hunyuan3d2_tpu_torch.pipelines import delight as tdl
from hunyuan3d2_tpu_torch.utils import dehighlight as tdh
from tests import torch_sd_ref as ref

RES, STEPS = 32, 3


@pytest.fixture(autouse=True)
def _one_torch_thread(monkeypatch):
    yield from ref.one_thread(monkeypatch)


@pytest.fixture(scope="module")
def unet_pair():
    params = ref.jax_unet(jdl.IP2P_UNET_TINY, seed=1)
    return params, ref.port_unet(params, jdl.IP2P_UNET_TINY)


@pytest.mark.parametrize("dtype", ["bf16", "fp32"])
def test_ip2p_unet_matches_jax(unet_pair, dtype):
    """8-channel conv_in, 2 heads a block (head sizes 16 and 32), no class
    embedding."""
    params, module = unet_pair
    cfg = jdl.IP2P_UNET_TINY
    rs = np.random.RandomState(0)
    x = rs.randn(3, 8, 8, 8).astype(np.float32)
    t = np.array([981.0, 500.0, 21.0], np.float32)
    ctx = rs.randn(3, 77, cfg.cross_attention_dim).astype(np.float32)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bf16" else (jnp.float32, torch.float32)
    out_j = ref.unet_apply(params, cfg, jnp.asarray(x, jdt), jnp.asarray(t),
                           jnp.asarray(ctx, jdt))
    with torch.no_grad():
        out_t = module(torch.from_numpy(x).to(tdt), torch.from_numpy(t),
                       torch.from_numpy(ctx).to(tdt), None, "r", 1, {})
    assert out_t.dtype == tdt and out_t.shape == (3, 8, 8, 4)
    (ref.assert_bf16_close if dtype == "bf16" else ref.assert_fp32_close)(out_t, out_j)


def test_head_count_sets_the_head_size():
    cfg = ref.port_cfg(jdl.IP2P_UNET)
    assert [cfg.heads(c) for c in cfg.block_out_channels] == [8, 8, 8, 8]
    assert [c // cfg.heads(c) for c in cfg.block_out_channels] == [40, 80, 160, 160]
    with torch.device("meta"):
        module = tpu.plain_unet(cfg)
    n = sum(p.numel() for p in module.parameters())
    assert 0.85e9 < n < 0.87e9, n
    assert not any(k.startswith(("learned_text", "class_embedding")) for k in module.state_dict())


@pytest.mark.parametrize("n", [1, 3, 50])
def test_ip2p_scheduler_tables_equal_jax(n):
    out, jref = tdl.IP2P_SCHEDULER.make_tables(n), jdl.IP2P_SCHEDULER.make_tables(n)
    for a, b in zip(out, jref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert out[0][0] == (n - 1) * (1000 // n) + 1 and out[1][-1] == 0.0


def _jax_draws(seed, shape, steps):
    """The JAX delight loop's draws: split once for x_T, then once a step."""
    key = jax.random.PRNGKey(seed)
    key, nk = jax.random.split(key)
    init = ref.normal(nk, shape)
    noises = []
    for _ in range(steps):
        key, nk = jax.random.split(key)
        noises.append(ref.normal(nk, shape))
    return init, noises


def _port_pipeline(jpipe, **kw):
    params = jax.tree.map(np.asarray, jpipe.unet_params)
    vae = build(tvae.AutoencoderKL, tvae.TINY, device="cpu")
    convert.load_numpy_state_dict(vae, convert.sd_vae_state_dict(
        jax.tree.map(np.asarray, jpipe.vae_params)))
    return tdl.DelightPipeline(ref.port_unet(params, jpipe.ucfg), vae,
                               np.asarray(jpipe.text_embed), num_inference_steps=STEPS,
                               resolution=RES, device="cpu", **kw)


@pytest.fixture(scope="module")
def pipelines():
    """The JAX TINY pipeline (seeded weights) and the port's with the same
    weights."""
    from hunyuan3d2_tpu.models import sd_vae as jvae

    ucfg = jdl.IP2P_UNET_TINY
    text = np.random.RandomState(3).randn(77, ucfg.cross_attention_dim).astype(np.float32) * 0.02
    jpipe = jdl.DelightPipeline(ref.jax_unet(ucfg, seed=3), ucfg,
                                ref.random_params(jvae.init, jvae.TINY, seed=4), jvae.TINY, text,
                                num_inference_steps=STEPS, resolution=RES)
    return jpipe, _port_pipeline(jpipe)


def _rgb(h=48, w=40, seed=0):
    rs = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
    base = np.stack([yy, xx, 1 - yy], -1)
    return np.clip(base + 0.2 * rs.rand(h, w, 3), 0, 1).astype(np.float32)


def test_delight_pipeline_matches_jax(pipelines):
    jpipe, tpipe = pipelines
    rgb = _rgb()
    init, noises = _jax_draws(42, (1, RES // 2, RES // 2, 4), STEPS)
    out_j = jpipe(rgb, seed=42)
    out_t = tpipe(rgb, seed=42, init_latents=init, step_noises=noises)
    assert out_t.shape == rgb.shape and out_t.dtype == np.float32
    corr, mad = ref.image_agreement(out_t, out_j)
    assert corr >= 0.99 and mad <= 3.0, (corr, mad)


def test_delight_pipeline_uses_its_generator(pipelines):
    _, tpipe = pipelines
    rgb = _rgb(RES, RES)
    a, b, c = tpipe(rgb, seed=1), tpipe(rgb, seed=1), tpipe(rgb, seed=2)
    assert np.array_equal(a, b) and not np.array_equal(a, c)


def test_recorrect_rgb_equals_jax():
    rs = np.random.RandomState(4)
    src, tgt = rs.rand(40, 36, 3).astype(np.float32), rs.rand(40, 36, 3).astype(np.float32)
    alpha = (rs.rand(40, 36) > 0.3).astype(np.float32)
    for a in (None, alpha, np.zeros_like(alpha)):
        np.testing.assert_array_equal(tdh.recorrect_rgb(src, tgt, a),
                                      jdh.recorrect_rgb(src, tgt, a))


def _rgba(size=64):
    arr = np.zeros((size, size, 4), np.uint8)
    arr[size // 4:3 * size // 4, size // 4:3 * size // 4] = [180, 90, 60, 255]
    arr[size // 4:size // 2, size // 4:size // 2, 3] = 128
    return Image.fromarray(arr)


def test_light_shadow_remover_without_pipeline_equals_jax():
    a, b = tdh.Light_Shadow_Remover()(_rgba()), jdh.Light_Shadow_Remover()(_rgba())
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert np.asarray(a)[0, 0].tolist() == [255, 255, 255]


def test_light_shadow_remover_with_pipeline_matches_jax(pipelines):
    jpipe, tpipe = pipelines
    init, noises = _jax_draws(42, (1, RES // 2, RES // 2, 4), STEPS)

    def injected(rgb01):
        return tpipe(rgb01, init_latents=init, step_noises=noises)

    out_t = tdh.Light_Shadow_Remover(pipeline=injected)(_rgba())
    out_j = jdh.Light_Shadow_Remover(pipeline=jpipe)(_rgba())
    assert out_t.size == (64, 64) and (np.asarray(out_t)[:8, :8] == 255).all()
    corr, mad = ref.image_agreement(out_t, out_j)
    assert corr >= 0.99 and mad <= 3.0, (corr, mad)


# ---------------------------------------------------------------------------
# loading a diffusers InstructPix2Pix directory
# ---------------------------------------------------------------------------
def _ip2p_dir(root, head):
    """unet/ (a JAX UNet at (64, 128) channels, 32 groups), vae/, a tiny
    CLIP text encoder and tokenizer."""
    import dataclasses

    from hunyuan3d2_tpu.models import sd_vae as jvae

    jcfg = dataclasses.replace(jdl.IP2P_UNET_TINY, block_out_channels=(64, 128),
                               norm_num_groups=32, num_heads=head if isinstance(head, int) else None)
    params = ref.jax_unet(jcfg, seed=5)
    ref.write_part(root, "unet", ref.plain_unet_sd(params), ref.unet_config_json(jcfg, head))
    ref.write_vae(root, ref.random_params(jvae.init, jvae.TINY, seed=6), jvae.TINY)
    ref.write_clip_text(root, jcfg.cross_attention_dim)
    return str(root)


@pytest.mark.parametrize("head", [2, [1, 2]], ids=["int", "list"])
def test_both_packages_load_the_same_delight_model(tmp_path, head):
    root = _ip2p_dir(tmp_path, head)
    jl = jdl.DelightPipeline.from_pretrained(root, num_inference_steps=2, resolution=RES)
    tl = tdl.DelightPipeline.from_pretrained(root, device="cpu", num_inference_steps=2,
                                             resolution=RES)
    assert ref.port_cfg(jl.ucfg) == tl.unet.cfg
    # an int is the head count; a list leaves the head size at 64
    assert [tl.unet.cfg.heads(c) for c in (64, 128)] == ([2, 2] if head == 2 else [1, 2])
    ref.assert_same_weights(tl.unet, convert.unet_core_state_dict(
        jax.tree.map(np.asarray, jl.unet_params)))
    ref.assert_same_weights(tl.vae, convert.sd_vae_state_dict(
        jax.tree.map(np.asarray, jl.vae_params)))
    np.testing.assert_array_equal(tl.text_embed.numpy(), np.asarray(jl.text_embed))
    assert tl.text_embed.shape == (77, 32) and tl.device.type == "cpu"
    lsr = tdh.Light_Shadow_Remover(types.SimpleNamespace(light_remover_ckpt_path=root,
                                                         device="cpu"))
    assert isinstance(lsr.pipeline, tdl.DelightPipeline)


def test_delight_loader_refuses_a_key_mismatch(tmp_path):
    import safetensors.numpy

    root = _ip2p_dir(tmp_path, 2)
    path = str(tmp_path / "unet" / "diffusion_pytorch_model.safetensors")
    sd = safetensors.numpy.load_file(path)
    sd.pop("conv_out.bias")
    safetensors.numpy.save_file(sd, path)
    with pytest.raises(KeyError, match="conv_out.bias"):
        tdl.DelightPipeline.from_pretrained(root, device="cpu")


def test_light_shadow_remover_raises_on_a_bad_checkpoint(tmp_path):
    with pytest.raises(FileNotFoundError):
        tdh.Light_Shadow_Remover(types.SimpleNamespace(
            light_remover_ckpt_path=str(tmp_path / "missing"), device="cpu"))


def _names(fn):
    return [n for n, p in inspect.signature(fn).parameters.items()
            if p.kind not in (p.VAR_POSITIONAL, p.VAR_KEYWORD) and n != "key"]


@pytest.mark.parametrize("port,jax_fn", [
    (tdl.DelightPipeline.__call__, jdl.DelightPipeline.__call__),
    (tdl.DelightPipeline.init_random, jdl.DelightPipeline.init_random),
    (tdl.DelightPipeline.from_pretrained, jdl.DelightPipeline.from_pretrained),
    (tdh.Light_Shadow_Remover.__init__, jdh.Light_Shadow_Remover.__init__),
    (tdh.Light_Shadow_Remover.__call__, jdh.Light_Shadow_Remover.__call__),
    (tdh.recorrect_rgb, jdh.recorrect_rgb),
], ids=lambda f: getattr(f, "__qualname__", ""))
def test_signatures_keep_the_jax_parameter_names(port, jax_fn):
    """Each JAX parameter keeps its name and place (the JAX ``key`` is the
    port's ``seed``); the port may add keywords after them."""
    j = _names(jax_fn)
    assert _names(port)[:len(j)] == j
