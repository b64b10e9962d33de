"""The port's paint stack (hunyuan3d2_tpu_torch: ops/conv, models/sd_vae,
models/paint_unet, the LCM sampler, the masked flash attention) against the
JAX package's, on the CPU at tiny sizes.

Weights are drawn by the JAX package and carried over by io/convert.py;
inputs are made by numpy from a seed and handed to both frameworks. The
masked Pallas kernel runs in interpret mode, patched as
tests/test_flash_attention.py does.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from hunyuan3d2_tpu.io import diffusers_maps as dm
from hunyuan3d2_tpu.models import paint_unet as jpu
from hunyuan3d2_tpu.models import sd_vae as jvae
from hunyuan3d2_tpu.ops import conv as jconv
from hunyuan3d2_tpu.pipelines.paint_schedulers import LCMScheduler as JLCM
from hunyuan3d2_tpu_torch.io import convert
from hunyuan3d2_tpu_torch.models import paint_unet as tpu
from hunyuan3d2_tpu_torch.models import sd_vae as tvae
from hunyuan3d2_tpu_torch.ops import conv as tconv
from hunyuan3d2_tpu_torch.ops.attention import masked_attention
from hunyuan3d2_tpu_torch.ops.flash_attention import flash_attention_masked_plain
from hunyuan3d2_tpu_torch.ops.nn import build
from hunyuan3d2_tpu_torch.pipelines.paint_schedulers import LCMScheduler as TLCM

# the TINY topology at four levels and two layers per block, the DEFAULT
# UNet's block walk at narrow widths
UNET4 = dict(block_out_channels=(16, 16, 32, 32), layers_per_block=2, cross_attention_dim=16,
             attention_head_dim=8, norm_num_groups=8)
VAE4 = dict(block_out_channels=(8, 16, 32, 32), layers_per_block=2, norm_num_groups=8)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _tree_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _scale_err(out, ref):
    """max |out − ref| over max |ref|."""
    return np.abs(out - ref).max() / np.abs(ref).max()


@pytest.fixture(scope="module")
def tiny_paint():
    up = _tree_np(jpu.init(jax.random.PRNGKey(0), jpu.TINY))
    vp = _tree_np(jvae.init(jax.random.PRNGKey(1), jvae.TINY))
    unet = convert.load_numpy_state_dict(build(tpu.UNet2p5D, tpu.TINY, device="cpu"),
                                         convert.paint_unet_state_dict(up))
    vae = convert.load_numpy_state_dict(build(tvae.AutoencoderKL, tvae.TINY, device="cpu"),
                                        convert.sd_vae_state_dict(vp))
    return up, vp, unet, vae


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
def test_conv_group_norm_resnet_match_jax(dt):
    jdt, tdt = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[dt]
    # fp32: summation order only; bf16: one rounding of each output (ulp
    # 2^-8 at 1) plus the intermediate roundings of the resnet chain
    tol = 2e-5 if dt == "fp32" else 3e-2
    rs = np.random.RandomState(0)
    x = rs.randn(2, 12, 10, 16).astype(np.float32)
    temb = rs.randn(2, 24).astype(np.float32)
    jx, tx = jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)
    cp = _tree_np(jconv.Conv2d.init(jax.random.PRNGKey(1), 16, 8, 3))
    conv = nn.ModuleDict({"c": tconv.Conv2d(16, 8, 3)})
    sd = {}
    convert._conv(sd, "c", cp)
    convert.load_numpy_state_dict(conv, sd)
    for stride, jpad, tpad in ((1, "SAME", "same"), (2, ((1, 1), (1, 1)), 1), (2, "VALID", "valid")):
        ref = _np(jconv.Conv2d.apply(cp, jx, stride=stride, padding=jpad))
        out = _np(conv["c"](tx, stride=stride, padding=tpad))
        assert out.shape == ref.shape
        assert _scale_err(out, ref) < tol, (stride, jpad)
    s, b = rs.rand(16).astype(np.float32) + 0.5, rs.randn(16).astype(np.float32)
    ref = _np(jconv.group_norm(jx, jnp.asarray(s), jnp.asarray(b), 4, 1e-5))
    out = _np(tconv.group_norm(tx, torch.from_numpy(s), torch.from_numpy(b), 4, 1e-5))
    assert _scale_err(out, ref) < tol
    rp = _tree_np(jconv.ResnetBlock.init(jax.random.PRNGKey(2), 16, 24, 24))
    res = nn.ModuleDict({"r": tconv.ResnetBlock(16, 24, 24)})
    sd = {}
    convert._resnet(sd, "r", rp)
    convert.load_numpy_state_dict(res, sd)
    ref = _np(jconv.ResnetBlock.apply(rp, jx, jnp.asarray(temb, jdt), 8, 1e-5))
    out = _np(res["r"](tx, torch.from_numpy(temb).to(tdt), 8, 1e-5))
    assert _scale_err(out, ref) < tol
    up = _np(tconv.upsample_nearest2x(tx))
    np.testing.assert_array_equal(up, _np(jconv.upsample_nearest2x(jx)))


def test_vae_encode_decode_match_jax(tiny_paint):
    _, vp, _, vae = tiny_paint
    rs = np.random.RandomState(3)
    img = rs.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    lat = rs.randn(2, 16, 16, 4).astype(np.float32)
    ref_e = _np(jax.jit(jvae.encode, static_argnums=1)(vp, jvae.TINY, jnp.asarray(img, jnp.bfloat16)))
    ref_d = _np(jax.jit(jvae.decode, static_argnums=1)(vp, jvae.TINY, jnp.asarray(lat, jnp.bfloat16)))
    with torch.no_grad():
        out_e = _np(vae.encode(torch.from_numpy(img).bfloat16()))
        out_d = _np(vae.decode(torch.from_numpy(lat).bfloat16()))
    # bf16 activations through ~20 rounded layers: measured 1.5 % (encode)
    # and 1.3 % (decode) of the output scale
    assert out_e.shape == ref_e.shape and out_d.shape == ref_d.shape
    assert _scale_err(out_e, ref_e) < 0.03
    assert _scale_err(out_d, ref_d) < 0.03
    assert np.corrcoef(out_d.ravel(), ref_d.ravel())[0, 1] > 0.999


def test_unet_write_then_read_with_masks_matches_jax(tiny_paint):
    up, _, unet, _ = tiny_paint
    rs = np.random.RandomState(4)
    b, n, h = 1, 3, 8
    samp, nl, pl_ = (rs.randn(b, n, h, h, 4).astype(np.float32) for _ in range(3))
    ref = rs.randn(b, 1, h, h, 4).astype(np.float32)
    cam_gen, cam_ref = np.array([[12, 15, 40]]), np.array([[0]])
    pos = rs.rand(b, n, 32, 32, 3).astype(np.float32)
    pos[:, :, :4] = 1.0     # some background
    masks = {int(m.shape[1]): m for m in
             (jpu.compute_voxel_grid_mask(jnp.asarray(pos), g) for g in (8, 4))}

    def jfwd(params, samp, nl, pl_, ref, masks):
        out, cache = jpu.apply(params, jpu.TINY, samp, jnp.float32(500.0), nl, pl_, ref,
                               jnp.asarray(cam_gen), jnp.asarray(cam_ref), mva_masks=masks)
        return out, cache

    bf = lambda a: jnp.asarray(a, jnp.bfloat16)  # noqa: E731
    jout, jcache = jax.jit(jfwd)(up, bf(samp), bf(nl), bf(pl_), bf(ref), masks)
    tb = lambda a: torch.from_numpy(a).bfloat16()  # noqa: E731
    with torch.no_grad():
        cache = unet.write_cache(tb(ref))
        out = unet(tb(samp), 500.0, tb(nl), tb(pl_), torch.from_numpy(cam_gen), cache,
                   mva_masks={k: torch.from_numpy(np.array(v)) for k, v in masks.items()})
    # the cached norm1 states: measured up to 7.8 % of the scale at single
    # entries (bf16 LayerNorm inputs deep in the dual UNet), correlation
    # ≥ 0.9976
    assert sorted(cache) == sorted(jcache)
    for k in cache:
        c, jc = _np(cache[k]).ravel(), _np(jcache[k]).ravel()
        assert _scale_err(c, jc) < 0.15 and np.corrcoef(c, jc)[0, 1] > 0.995, k
    jout, out = _np(jout), _np(out)
    assert out.shape == jout.shape == (b, n, h, h, 4)
    # bf16 through two UNets (the 'w' pass feeds every 'r' layer): measured
    # 1.5 % of the output scale
    assert _scale_err(out, jout) < 0.05
    assert np.corrcoef(out.ravel(), jout.ravel())[0, 1] > 0.999


def test_voxel_grid_mask_matches_jax():
    rs = np.random.RandomState(5)
    pos = rs.rand(1, 4, 32, 32, 3).astype(np.float32)
    pos[:, :, :8] = 1.0
    pos[:, 1, 16:, 16:] = rs.rand(16, 16, 3).astype(np.float32) * 0.05 + 0.4
    for g in (16, 8, 4):
        ref = np.asarray(jpu.compute_voxel_grid_mask(jnp.asarray(pos), g))
        out = tpu.compute_voxel_grid_mask(torch.from_numpy(pos), g).numpy()
        assert out.shape == ref.shape == (1, 4 * g * g, 4 * g * g)
        # entries may differ only where the distance sits on the threshold
        valid = (pos != 1.0).all(-1, keepdims=True)
        p = np.where(valid, pos, 0.0).astype(np.float64).reshape(1, 4, g, 32 // g, g, 32 // g, 3)
        cnt = valid.astype(np.float64).reshape(1, 4, g, 32 // g, g, 32 // g, 1).sum((3, 5))
        gp = np.where(cnt < 5, 0.0, p.sum((3, 5)) / np.maximum(cnt, 1.0)).reshape(1, -1, 3)
        d2 = ((gp[:, :, None] - gp[:, None]) ** 2).sum(-1)
        differ = out != ref
        assert np.all(np.abs(d2[differ] - (1.73 / g) ** 2) < 1e-6), g
        assert ref.mean() > 0.0


@pytest.mark.parametrize("t,t_next", [(989, 890), (98, 0)])
def test_lcm_step_matches_jax(t, t_next):
    jt, jac = JLCM().make_tables(10)
    tt, tac = TLCM().make_tables(10)
    np.testing.assert_array_equal(jt, tt)
    np.testing.assert_array_equal(jac, tac)
    rs = np.random.RandomState(t)
    model, sample, noise = (rs.randn(2, 8, 8, 4).astype(np.float32) for _ in range(3))
    ref, ref_x0 = JLCM().step(jnp.asarray(model), jnp.asarray(sample), jnp.int32(t),
                              jnp.int32(t_next), jnp.asarray(jac), jnp.asarray(noise))
    out, out_x0 = TLCM().step(torch.from_numpy(model), torch.from_numpy(sample), t, t_next,
                              torch.from_numpy(tac), torch.from_numpy(noise))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6, rtol=0)
    np.testing.assert_allclose(out_x0.numpy(), np.asarray(ref_x0), atol=1e-6, rtol=0)


@pytest.mark.parametrize("cfg", ["tiny", "four_levels"])
def test_state_dicts_match_diffusers_exporters(cfg):
    jcfg = jpu.TINY if cfg == "tiny" else jpu.PaintUNetConfig(**UNET4)
    tcfg = tpu.TINY if cfg == "tiny" else tpu.PaintUNetConfig(**UNET4)
    jvcfg = jvae.TINY if cfg == "tiny" else jvae.SDVAEConfig(**VAE4)
    if cfg == "tiny":
        up = _tree_np(jpu.init(jax.random.PRNGKey(7), jcfg))
        vp = _tree_np(jvae.init(jax.random.PRNGKey(8), jvcfg))
    else:  # keys and shapes only: zeros of the traced parameter shapes
        zeros = lambda t: jax.tree_util.tree_map(  # noqa: E731
            lambda a: np.zeros(a.shape, np.float32), t)
        up = zeros(jax.eval_shape(lambda k: jpu.init(k, jcfg), jax.random.PRNGKey(7)))
        vp = zeros(jax.eval_shape(lambda k: jvae.init(k, jvcfg), jax.random.PRNGKey(8)))
    for ours, ref in ((convert.paint_unet_state_dict(up), dm.export_paint_unet(up)),
                      (convert.sd_vae_state_dict(vp), dm.export_sd_vae(vp))):
        assert sorted(ours) == sorted(ref)
        for k in ref:
            assert ours[k].shape == ref[k].shape and np.array_equal(ours[k], ref[k]), k
    # and the port's modules take them, strictly
    with torch.device("meta"):
        unet = tpu.UNet2p5D(tcfg)
    sd = convert.paint_unet_state_dict(up)
    assert sorted(unet.state_dict()) == sorted(sd)
    for k, v in unet.state_dict().items():
        assert tuple(v.shape) == sd[k].shape, k
    vcfg = tvae.TINY if cfg == "tiny" else tvae.SDVAEConfig(**VAE4)
    with torch.device("meta"):
        vae = tvae.AutoencoderKL(vcfg)
    sd = convert.sd_vae_state_dict(vp)
    assert sorted(vae.state_dict()) == sorted(sd)
    for k, v in vae.state_dict().items():
        assert tuple(v.shape) == sd[k].shape, k


def _pallas_masked(q, k, v, mask, bq, bk):
    from jax.experimental import pallas as pl

    from hunyuan3d2_tpu.ops import flash_attention as fa

    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    b, h, lq, d = q.shape
    with mock.patch.object(pl, "pallas_call", patched):
        out = fa._flash_masked.__wrapped__(q.reshape(b * h, lq, d), k.reshape(b * h, -1, d),
                                           v.reshape(b * h, -1, d), mask, d ** -0.5, bq, bk, h)
    return out.reshape(b, h, lq, d)


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("lq,lk", [(128, 256), (130, 200)])
def test_masked_plain_matches_pallas_kernel(lq, lk, dt):
    jdt, tdt = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[dt]
    rs = np.random.RandomState(lq + lk)
    q = rs.randn(2, 3, lq, 64).astype(np.float32)
    k, v = (rs.randn(2, 3, lk, 64).astype(np.float32) for _ in range(2))
    mask = rs.rand(2, lq, lk) < 0.4
    mask[:, 0] = False               # a fully masked row → 0
    mask[:, 1, :128] = False         # masked through the first key block only
    mask[:, 2, :] = False
    mask[:, 2, lk - 1] = True        # one allowed key, in the last (ragged) block
    ref = _np(_pallas_masked(*(jnp.asarray(a, jdt) for a in (q, k, v)), jnp.asarray(mask),
                             128, 128))
    tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in (q, k, v))
    out = _np(flash_attention_masked_plain(tq, tk, tv, torch.from_numpy(mask)))
    assert np.all(out[:, :, 0] == 0) and np.all(ref[:, :, 0] == 0)
    # fp32: summation order only; bf16: p rounded before P·V at other block
    # boundaries and one rounding of the output
    tol = dict(atol=2e-5, rtol=2e-5) if dt == "fp32" else dict(atol=2e-2, rtol=2e-2)
    np.testing.assert_allclose(out, ref, **tol)
    np.testing.assert_allclose(out[:, :, 2], _np(tv)[:, :, lk - 1], **tol)
    # masked_attention on CPU tensors is sdpa with the mask, as the JAX
    # package does off the TPU; rows with an allowed key agree with the twin
    sd = _np(masked_attention(tq, tk, tv, torch.from_numpy(mask)))
    np.testing.assert_allclose(sd[:, :, 1:], out[:, :, 1:], **tol)
