"""The port's align path (hunyuan3d2_tpu_torch: models/controlnet.py,
models/ip_adapter.py, the UNet's IP-Adapter and ControlNet hooks,
pipelines/align.py, utils/align_img4tex.py and the loader) against the JAX
package's, on the CPU at TINY sizes.

Weights are drawn by numpy into the JAX package's trees (the ControlNet's
zero convs and the grafted to_k_ip / to_v_ip filled with seeded non-zero
values: zeros would let any bug in those branches through) and carried over
by io/convert.py. The JAX loop draws inside its jit (one split for x_T, then
one a step, the steps img2img skips included); the draws are replayed
outside it and injected into the port's loop. Tolerances: modules within 5 %
of the output scale with correlation ≥ 0.999 in bf16, 1e-4 in fp32;
zero-init identities exact; images correlation ≥ 0.99 and mean |Δ| ≤ 3
levels.
"""

import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from hunyuan3d2_tpu.models import controlnet as jcn
from hunyuan3d2_tpu.models import ip_adapter as jip
from hunyuan3d2_tpu.models import sd_vae as jvae
from hunyuan3d2_tpu.pipelines import align as jal
from hunyuan3d2_tpu.utils import align_img4tex as jai
from hunyuan3d2_tpu_torch.io import convert
from hunyuan3d2_tpu_torch.models import controlnet as tcn
from hunyuan3d2_tpu_torch.models import ip_adapter as tip
from hunyuan3d2_tpu_torch.models import sd_vae as tvae
from hunyuan3d2_tpu_torch.ops.nn import build
from hunyuan3d2_tpu_torch.pipelines import align as tal
from hunyuan3d2_tpu_torch.utils import align_img4tex as tai
from tests import torch_sd_ref as ref

RES, STEPS = 32, 4
UCFG = jcn.TINY


@pytest.fixture(autouse=True)
def _one_torch_thread(monkeypatch):
    yield from ref.one_thread(monkeypatch)


def _unet_with_adapter(seed):
    params = ref.jax_unet(UCFG, seed=seed)
    jip.add_ip_adapter(params, UCFG.cross_attention_dim)
    rs = np.random.RandomState(seed + 100)
    for key in ("to_k_ip", "to_v_ip"):
        ref.fill(params, key, rs)
    return params


def _port_controlnet(params, cfg=UCFG):
    module = build(tcn.ControlNet, ref.port_cfg(cfg), device="cpu")
    return convert.load_numpy_state_dict(module, convert.controlnet_state_dict(params))


@pytest.fixture(scope="module")
def stack():
    """(JAX UNet params with a non-zero adapter, the port's UNet, JAX
    ControlNet params with non-zero zero convs, the port's ControlNet)."""
    up = _unet_with_adapter(1)
    cp = ref.random_params(jcn.init, UCFG, seed=2)
    return up, ref.port_unet(up, UCFG), cp, _port_controlnet(cp)


def _inputs(dtype, seed=0):
    rs = np.random.RandomState(seed)
    sample = rs.randn(2, 8, 8, 4).astype(np.float32)
    t = np.array([981.0, 261.0], np.float32)
    ctx = rs.randn(2, 77, UCFG.cross_attention_dim).astype(np.float32)
    cond = rs.rand(2, 64, 64, 3).astype(np.float32)
    ip = rs.randn(2, 4, UCFG.cross_attention_dim).astype(np.float32)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bf16" else (jnp.float32, torch.float32)
    j = (jnp.asarray(sample, jdt), jnp.asarray(t), jnp.asarray(ctx, jdt), jnp.asarray(cond),
         jnp.asarray(ip, jdt))
    p = (torch.from_numpy(sample).to(tdt), torch.from_numpy(t), torch.from_numpy(ctx).to(tdt),
         torch.from_numpy(cond), torch.from_numpy(ip).to(tdt))
    return j, p, tdt


_jax_controlnet = jax.jit(jcn.apply, static_argnums=1)


@pytest.mark.parametrize("dtype", ["bf16", "fp32"])
def test_controlnet_matches_jax(stack, dtype):
    """The conditioning embedder (stride-2 convs padded (1, 1), stride-1
    SAME), the trunk, and the scaled zero convs: every residual, fp32."""
    _, _, cp, module = stack
    (x, t, ctx, cond, _), (xt, tt, ctxt, condt, _), _ = _inputs(dtype)
    down_j, mid_j = _jax_controlnet(cp, UCFG, x, t, ctx, cond, conditioning_scale=0.7)
    with torch.no_grad():
        down_t, mid_t = module(xt, tt, ctxt, condt, conditioning_scale=0.7)
    assert len(down_t) == len(down_j) == 1 + 2 * UCFG.layers_per_block + 1
    check = ref.assert_bf16_close if dtype == "bf16" else ref.assert_fp32_close
    for a, b in zip(down_t + [mid_t], list(down_j) + [mid_j]):
        assert a.dtype == torch.float32
        check(a, b)
    assert module.controlnet_mid_block.weight.dtype == torch.float32
    assert module.controlnet_cond_embedding.conv_out.weight.dtype == torch.float32


def test_controlnet_zero_init_is_identity():
    """The port's random init zeroes the embedder's conv_out and every zero
    conv: each residual is exactly 0 and the controlled UNet's output is the
    plain one, bit for bit (fp32, where adding a zero residual is exact)."""
    cfg = ref.port_cfg(UCFG)
    ctrl = build(tcn.ControlNet, cfg, device="cpu")
    unet = ref.port_unet(ref.jax_unet(UCFG, seed=3), UCFG)
    _, (x, t, ctx, cond, _), _ = _inputs("fp32")
    with torch.no_grad():
        down, mid = ctrl(x, t, ctx, cond)
        assert all(torch.count_nonzero(d) == 0 for d in down) and torch.count_nonzero(mid) == 0
        plain = unet(x, t, ctx, None, "r", 1, {})
        controlled = unet(x, t, ctx, None, "r", 1, {}, ctrl_down=down, ctrl_mid=mid)
    assert torch.equal(plain, controlled)


@pytest.mark.parametrize("dtype", ["bf16", "fp32"])
@pytest.mark.parametrize("hook", ["ip", "ctrl", "both"])
def test_unet_hooks_match_jax(stack, hook, dtype):
    """The UNet with the IP tokens (the scaled image attention added before
    to_out, in fp32 as the JAX pipeline's fp32 scale makes it) and with the
    ControlNet residuals (the JAX ControlNet's, fed to both)."""
    up, unet, cp, _ = stack
    (x, t, ctx, cond, ip), (xt, tt, ctxt, _, ipt), _ = _inputs(dtype, seed=1)
    kw_j, kw_t = {}, {}
    if hook in ("ip", "both"):
        kw_j.update(ip_context=ip, ip_scale=jnp.float32(0.7))
        kw_t.update(ip_context=ipt, ip_scale=0.7)
    if hook in ("ctrl", "both"):
        down, mid = _jax_controlnet(cp, UCFG, x, t, ctx, cond)
        kw_j.update(ctrl_down=down, ctrl_mid=mid)
        kw_t.update(ctrl_down=[torch.from_numpy(ref.to_np(d)) for d in down],
                    ctrl_mid=torch.from_numpy(ref.to_np(mid)))
    out_j = ref.unet_apply(up, UCFG, x, t, ctx, **kw_j)
    with torch.no_grad():
        out_t = unet(xt, tt, ctxt, None, "r", 1, {}, **kw_t)
        plain = unet(xt, tt, ctxt, None, "r", 1, {})
    # either hook leaves the residual stream in fp32 after it, as in the JAX package
    assert out_t.dtype == torch.float32 and out_j.dtype == jnp.float32
    (ref.assert_bf16_close if dtype == "bf16" else ref.assert_fp32_close)(out_t, out_j)
    assert (out_t.float() - plain.float()).abs().max() > 1e-3 * plain.float().abs().max()


def test_ip_adapter_zero_graft_is_identity():
    """Zero to_k_ip / to_v_ip: the image branch adds exactly 0 (fp32)."""
    params = ref.jax_unet(UCFG, seed=4)
    plain = ref.port_unet(params, UCFG)
    grafted = tip.add_ip_adapter(ref.port_unet(params, UCFG), UCFG.cross_attention_dim)
    assert sum(1 for k in grafted.state_dict() if k.endswith("to_k_ip.weight")) == 4
    _, (x, t, ctx, _, ip), _ = _inputs("fp32", seed=2)
    with torch.no_grad():
        assert torch.equal(plain(x, t, ctx, None, "r", 1, {}),
                           grafted(x, t, ctx, None, "r", 1, {}, ip_context=ip, ip_scale=0.7))


def test_add_ip_adapter_grafts_the_paint_unet_and_its_dual_copy():
    """As the JAX graft recurses into ``dual``: every attn2 of both copies,
    under the keys ``...attn2.to_{k,v}_ip.weight``."""
    from hunyuan3d2_tpu.models import paint_unet as jpu
    from hunyuan3d2_tpu_torch.models import paint_unet as tpu

    params = ref.random_params(jpu.init, jpu.TINY, seed=20)
    jip.add_ip_adapter(params, 32)
    with torch.device("meta"):
        module = tip.add_ip_adapter(tpu.UNet2p5D(tpu.TINY), 32)
    sd = convert.paint_unet_state_dict(params)
    keys = {k for k in module.state_dict() if "_ip." in k}
    assert keys == {k for k in sd if "_ip." in k} and len(keys) == 16
    assert {k.split(".")[0] for k in keys} == {"unet", "unet_dual"}


@pytest.mark.parametrize("dtype", ["bf16", "fp32"])
def test_resampler_matches_jax(dtype):
    cfg = jip.TINY
    params = ref.random_params(jip.init_resampler, cfg, seed=5)
    module = build(tip.Resampler, tip.ResamplerConfig(**dataclasses.asdict(cfg)), device="cpu")
    convert.load_numpy_state_dict(module, convert.resampler_state_dict(params, prefix=""))
    x = np.random.RandomState(6).randn(2, 7, cfg.embedding_dim).astype(np.float32)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bf16" else (jnp.float32, torch.float32)
    out_j = jip.apply_resampler(params, cfg, jnp.asarray(x, jdt))
    with torch.no_grad():
        out_t = module(torch.from_numpy(x).to(tdt))
    assert out_t.shape == (2, cfg.num_queries, cfg.output_dim) and out_t.dtype == tdt
    (ref.assert_bf16_close if dtype == "bf16" else ref.assert_fp32_close)(out_t, out_j)


def test_image_proj_matches_jax():
    params = jip.init_image_proj(jax.random.PRNGKey(0), 16, 8, num_tokens=4)
    rs = np.random.RandomState(7)
    params["norm"] = {"scale": (1 + 0.1 * rs.randn(8)).astype(np.float32),
                      "bias": (0.1 * rs.randn(8)).astype(np.float32)}
    module = build(tip.ImageProjModel, 16, 8, num_tokens=4, device="cpu")
    convert.load_numpy_state_dict(module, convert.image_proj_state_dict(params, prefix=""))
    pooled = rs.randn(3, 16).astype(np.float32)
    out_j = jip.apply_image_proj(params, jnp.asarray(pooled))
    with torch.no_grad():
        out_t = module(torch.from_numpy(pooled))
    assert out_t.shape == (3, 4, 8)
    ref.assert_fp32_close(out_t, out_j)


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------
def _encoder(embedding_dim):
    def encode(image):
        seed = int(np.asarray(image.convert("L")).sum()) % 1000
        return np.random.RandomState(seed).randn(1, 8, embedding_dim).astype(np.float32)
    return encode


@pytest.fixture(scope="module")
def pipelines():
    """The JAX TINY pipeline (seeded weights, non-zero adapter and zero
    convs, a random uncond embedding, a seeded image encoder) and the
    port's with the same weights."""
    vcfg = jvae.TINY
    rcfg = dataclasses.replace(jip.TINY, output_dim=UCFG.cross_attention_dim)
    up = _unet_with_adapter(8)
    cp = ref.random_params(jcn.init, UCFG, seed=9)
    vp = ref.random_params(jvae.init, vcfg, seed=10)
    rp = ref.random_params(jip.init_resampler, rcfg, seed=11)
    rs = np.random.RandomState(12)
    text, uncond = (rs.randn(77, UCFG.cross_attention_dim).astype(np.float32) * 0.02
                    for _ in range(2))
    enc = _encoder(rcfg.embedding_dim)
    jpipe = jal.ControlNetSDPipeline(up, UCFG, cp, UCFG, vp, vcfg, rp, rcfg, text, uncond,
                                     image_encoder=enc, resolution=RES)
    vae = build(tvae.AutoencoderKL, tvae.TINY, device="cpu")
    convert.load_numpy_state_dict(vae, convert.sd_vae_state_dict(vp))
    res = build(tip.Resampler, tip.ResamplerConfig(**dataclasses.asdict(rcfg)), device="cpu")
    convert.load_numpy_state_dict(res, convert.resampler_state_dict(rp, prefix=""))
    tpipe = tal.ControlNetSDPipeline(ref.port_unet(up, UCFG), _port_controlnet(cp), vae, res,
                                     text, uncond, image_encoder=enc, resolution=RES,
                                     device="cpu")
    return jpipe, tpipe


def _jax_draws(seed, steps, hw=RES // 2):
    """The JAX align loop's draws: one split for x_T, then one a step,
    skipped steps included."""
    key = jax.random.PRNGKey(seed)
    key, nk = jax.random.split(key)
    init = ref.normal(nk, (1, hw, hw, 4))
    noises = []
    for _ in range(steps):
        key, nk = jax.random.split(key)
        noises.append(ref.normal(nk, (1, hw, hw, 4)))
    return init, noises


def _picture(seed, size=RES):
    rs = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:size, 0:size] * 255 // size
    base = np.stack([yy, xx, 255 - yy], -1)
    return Image.fromarray(np.clip(base + rs.randint(-40, 40, (size, size, 3)), 0, 255)
                           .astype(np.uint8))


@pytest.mark.parametrize("strength", [1.0, 0.5, 1e-9], ids=["t2i", "img2img", "strength-0"])
def test_align_pipeline_matches_jax(pipelines, strength):
    """Text-to-image, img2img from step N − int(N·0.5), and strength → 0
    (t_start = N: no step runs, the VAE round trip of the init image)."""
    jpipe, tpipe = pipelines
    kw = dict(prompt="a chair", control_image=_picture(1), ip_adapter_image=_picture(2),
              init_image=_picture(3), strength=strength, num_inference_steps=STEPS,
              guidance_scale=8.0, controlnet_conditioning_scale=0.8, seed=5, output_type="np")
    init, noises = _jax_draws(5, STEPS)
    out_j = jpipe(**kw)
    out_t = tpipe(**kw, init_noise=init, step_noises=noises)
    assert out_t.shape == (RES, RES, 3) and out_t.min() >= 0 and out_t.max() <= 1
    corr, mad = ref.image_agreement(out_t, out_j)
    assert corr >= 0.99 and mad <= 3.0, (corr, mad)


def test_reference_contracts_match_jax(pipelines):
    """Img2img_Control_Ip_adapter (text-to-image, seed 42) and HesModel
    (img2img at strength 0.5), each over the same pipeline in both
    packages."""
    jpipe, tpipe = pipelines
    init, noises = _jax_draws(42, STEPS)
    depth, ip_img, init_img = _picture(4), _picture(5), _picture(6)
    a = tai.Img2img_Control_Ip_adapter(pipeline=tpipe)(
        "a chair", depth, ip_img, "", height=RES, width=RES, num_inference_steps=STEPS,
        init_noise=init, step_noises=noises, unused_keyword=1)
    b = jai.Img2img_Control_Ip_adapter(pipeline=jpipe)(
        "a chair", depth, ip_img, "", height=RES, width=RES, num_inference_steps=STEPS)
    corr, mad = ref.image_agreement(a, b)
    assert a.size == (RES, RES) and corr >= 0.99 and mad <= 3.0, (corr, mad)
    a = tal.HesModel(pipeline=tpipe)(init_img, depth, ip_img, strength=0.5,
                                      num_inference_steps=STEPS, init_noise=init,
                                      step_noises=noises)
    b = jal.HesModel(pipeline=jpipe)(init_img, depth, ip_img, strength=0.5,
                                     num_inference_steps=STEPS)
    corr, mad = ref.image_agreement(a, b)
    assert corr >= 0.99 and mad <= 3.0, (corr, mad)


@pytest.mark.parametrize("n", [1, 4, 20, 40])
def test_sd15_scheduler_tables_equal_jax(n):
    out, jref = tal.SD15_SCHEDULER.make_tables(n), jal.SD15_SCHEDULER.make_tables(n)
    for a, b in zip(out, jref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_legacy_backend_keyword():
    calls = []

    def backend(**kw):
        calls.append(kw)
        return "image"

    for mod in (tai, jai):
        assert mod.Img2img_Control_Ip_adapter(backend=backend)("p", "depth", "ip", x=1) == "image"
    assert calls[0] == calls[1] == {"image": "ip", "control": "depth", "prompt": "p", "x": 1}


def test_pipeline_without_an_image_encoder_and_generator():
    """No image encoder: zero hidden states [1, 8, embedding_dim]; the seed
    decides the draws; a missing control image raises."""
    pipe = tal.ControlNetSDPipeline.init_random(resolution=RES, device="cpu")
    assert tip.Resampler is type(pipe.resampler)
    a, b, c = (pipe(control_image=_picture(7), num_inference_steps=2, seed=s) for s in (1, 1, 2))
    assert np.array_equal(np.asarray(a), np.asarray(b))
    assert not np.array_equal(np.asarray(a), np.asarray(c))
    with pytest.raises(ValueError, match="control image"):
        pipe()


# ---------------------------------------------------------------------------
# loading SD1.5 + ControlNet directories and an IP-Adapter file
# ---------------------------------------------------------------------------
RCFG64 = jip.ResamplerConfig(dim=64, depth=1, dim_head=64, heads=1, num_queries=4,
                             embedding_dim=48, output_dim=32, ff_mult=2)


def _align_dirs(root, head, with_adapter=True):
    """sd/ (unet/, vae/, a tiny CLIP text encoder), controlnet/ and
    ip_adapter.safetensors, written through the JAX package's exporters;
    the UNet at (64, 128) channels, 32 groups, a head-64 resampler (the
    head size the JAX loader assumes)."""
    import safetensors.numpy

    from hunyuan3d2_tpu.io import diffusers_maps as dm

    cfg = dataclasses.replace(UCFG, block_out_channels=(64, 128), norm_num_groups=32,
                              num_heads=head if isinstance(head, int) else None)
    up = ref.jax_unet(cfg, seed=13)
    jip.add_ip_adapter(up, cfg.cross_attention_dim)
    rs = np.random.RandomState(14)
    for key in ("to_k_ip", "to_v_ip"):
        ref.fill(up, key, rs)
    cp = ref.random_params(jcn.init, cfg, seed=15)
    rp = ref.random_params(jip.init_resampler, RCFG64, seed=16)
    sd = root / "sd"
    ref.write_part(sd, "unet", ref.plain_unet_sd(_without_adapter(up)),
                   ref.unet_config_json(cfg, head))
    ref.write_vae(sd, ref.random_params(jvae.init, jvae.TINY, seed=17), jvae.TINY)
    ref.write_clip_text(sd, cfg.cross_attention_dim)
    ref.write_part(root, "controlnet", dm.export_controlnet(cp), ref.unet_config_json(cfg, head))
    ip = dm.export_ip_adapter(up, rp)
    safetensors.numpy.save_file({k: np.ascontiguousarray(v, np.float32) for k, v in ip.items()},
                                str(root / "ip_adapter.safetensors"))
    return (str(sd), str(root / "controlnet"),
            str(root / "ip_adapter.safetensors") if with_adapter else None), up, rp


def _without_adapter(tree):
    """The UNet tree without its to_k_ip / to_v_ip (a plain SD checkpoint)."""
    if isinstance(tree, dict):
        return {k: _without_adapter(v) for k, v in tree.items() if k not in ("to_k_ip", "to_v_ip")}
    if isinstance(tree, list):
        return [_without_adapter(v) for v in tree]
    return tree


def test_ip_adapter_layout_equals_jax_export():
    """ip_adapter.{1,3,5,…} in diffusers' processor order (down, up, mid)."""
    from hunyuan3d2_tpu.io import diffusers_maps as dm

    up = _unet_with_adapter(18)
    rp = ref.random_params(jip.init_resampler, jip.TINY, seed=19)
    ours, theirs = convert.ip_adapter_state_dict(up, rp), dm.export_ip_adapter(up, rp)
    assert list(ours) != [] and set(ours) == set(theirs)
    for k in ours:
        np.testing.assert_array_equal(ours[k], theirs[k])
    module = tip.load_ip_adapter(ref.port_unet(_without_adapter(up), UCFG),
                                 {k: torch.from_numpy(v) for k, v in ours.items()})
    ref.assert_same_weights(module, convert.unet_core_state_dict(up))


@pytest.mark.parametrize("head", [2, [1, 2]], ids=["int", "list"])
def test_both_packages_load_the_same_align_stack(tmp_path, head):
    from hunyuan3d2_tpu.io import diffusers_maps as dm

    paths, _, _ = _align_dirs(tmp_path, head)
    jl = dm.load_align_pipeline(jal.ControlNetSDPipeline, *paths)
    tl = tal.ControlNetSDPipeline.from_pretrained(*paths, device="cpu")
    assert ref.port_cfg(jl.ucfg) == tl.unet.cfg == tl.controlnet.cfg
    assert [tl.unet.cfg.heads(c) for c in (64, 128)] == ([2, 2] if head == 2 else [1, 2])
    ref.assert_same_weights(tl.unet, convert.unet_core_state_dict(
        jax.tree.map(np.asarray, jl.unet_params)))
    ref.assert_same_weights(tl.controlnet, convert.controlnet_state_dict(
        jax.tree.map(np.asarray, jl.ctrl_params)))
    ref.assert_same_weights(tl.resampler, convert.resampler_state_dict(
        jax.tree.map(np.asarray, jl.resampler_params), prefix=""))
    assert tl.resampler.cfg.heads == jl.rcfg.heads == 1
    ref.assert_same_weights(tl.vae, convert.sd_vae_state_dict(
        jax.tree.map(np.asarray, jl.vae_params)))
    np.testing.assert_array_equal(tl.text_embed.numpy(), np.asarray(jl.text_embed))
    assert not tl.uncond_embed.any()


def test_align_loader_without_an_adapter_grafts_zeros(tmp_path):
    paths, _, _ = _align_dirs(tmp_path, 2, with_adapter=False)
    tl = tal.ControlNetSDPipeline.from_pretrained(*paths, device="cpu")
    ips = [v for k, v in tl.unet.state_dict().items() if "_ip." in k]
    assert len(ips) == 8 and not any(v.any() for v in ips)
    assert tl.resampler.cfg.output_dim == 32
    with pytest.raises(FileNotFoundError):
        tal.ControlNetSDPipeline.from_pretrained(*paths[:2], str(tmp_path / "missing.bin"),
                                                 device="cpu")


def test_align_loader_refuses_a_key_mismatch(tmp_path):
    import safetensors.numpy

    paths, _, _ = _align_dirs(tmp_path, 2)
    sd = safetensors.numpy.load_file(paths[2])
    sd.pop("ip_adapter.3.to_v_ip.weight")
    safetensors.numpy.save_file(sd, paths[2])
    with pytest.raises(KeyError, match="ip_adapter.3.to_v_ip.weight"):
        tal.ControlNetSDPipeline.from_pretrained(*paths, device="cpu")


def _names(fn):
    return [n for n, p in inspect.signature(fn).parameters.items()
            if p.kind not in (p.VAR_POSITIONAL, p.VAR_KEYWORD) and n != "key"]


@pytest.mark.parametrize("port,jax_fn", [
    (tal.ControlNetSDPipeline.__call__, jal.ControlNetSDPipeline.__call__),
    (tal.ControlNetSDPipeline.init_random, jal.ControlNetSDPipeline.init_random),
    (tal.ControlNetSDPipeline.from_pretrained, jal.ControlNetSDPipeline.from_pretrained),
    (tal.Img2img_Control_Ip_adapter.__init__, jal.Img2img_Control_Ip_adapter.__init__),
    (tal.Img2img_Control_Ip_adapter.__call__, jal.Img2img_Control_Ip_adapter.__call__),
    (tal.HesModel.__init__, jal.HesModel.__init__),
    (tal.HesModel.__call__, jal.HesModel.__call__),
    (tai.Img2img_Control_Ip_adapter.__init__, jai.Img2img_Control_Ip_adapter.__init__),
    (tai.Img2img_Control_Ip_adapter.__call__, jai.Img2img_Control_Ip_adapter.__call__),
], ids=lambda f: getattr(f, "__qualname__", ""))
def test_signatures_keep_the_jax_parameter_names(port, jax_fn):
    """Each JAX parameter keeps its name and place (the JAX ``key`` is the
    port's ``seed``); the port may add keywords after them."""
    j = _names(jax_fn)
    assert _names(port)[:len(j)] == j
