"""Port models (hunyuan3d2_tpu_torch.models) against the JAX package's, on
the CPU, with the same weights: each JAX parameter tree is carried into the
port by hunyuan3d2_tpu_torch/io/convert.py, and the round trip back through
hunyuan3d2_tpu/io/checkpoints.py proves the port's names are the Hunyuan3D-2
checkpoint keys.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hunyuan3d2_tpu.io import checkpoints
from hunyuan3d2_tpu.models import conditioner as jcond
from hunyuan3d2_tpu.models import dinov2 as jdino
from hunyuan3d2_tpu.models import dit as jdit
from hunyuan3d2_tpu.models import shapevae as jsv
from hunyuan3d2_tpu_torch.io import convert
from hunyuan3d2_tpu_torch.models import conditioner as tcond
from hunyuan3d2_tpu_torch.models import dinov2 as tdino
from hunyuan3d2_tpu_torch.models import dit as tdit
from hunyuan3d2_tpu_torch.models import shapevae as tsv
from hunyuan3d2_tpu_torch.ops.nn import build

SMALL_DINO = dict(hidden_size=128, num_layers=2, num_heads=2, patch_size=14, image_size=56,
                  swiglu_hidden=64)
DIT_GUIDED = jdit.DiTConfig(**{**jdit.TINY.__dict__, "guidance_embed": True})


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def assert_close(out, ref, frac):
    """max |out - ref| within ``frac`` of the reference's largest value, and
    the two agree in pattern (correlation > 0.999)."""
    out, ref = _np(out), _np(ref)
    assert out.shape == ref.shape
    assert np.isfinite(out).all()
    err = np.abs(out - ref).max()
    assert err <= frac * np.abs(ref).max(), (err, np.abs(ref).max())
    assert np.corrcoef(out.ravel(), ref.ravel())[0, 1] > 0.999


def _tree_equal(a, b):
    la, lb = jax.tree_util.tree_leaves_with_path(a), jax.tree_util.tree_leaves_with_path(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(x, np.float32), np.asarray(y, np.float32),
                                      err_msg=str(path))


def _dit(cfg, seed=0):
    params = jax.device_get(jax.jit(jdit.init, static_argnums=1)(jax.random.PRNGKey(seed), cfg))
    model = build(tdit.Hunyuan3DDiT, tdit.DiTConfig(**cfg.__dict__), device="cpu")
    return params, convert.load_numpy_state_dict(model, convert.dit_state_dict(params, cfg))


def _vae(cfg, seed=0):
    params = jax.device_get(jax.jit(jsv.init, static_argnums=1)(jax.random.PRNGKey(seed), cfg))
    vae = tsv.ShapeVAE.init_random(tsv.ShapeVAEConfig(**cfg.__dict__), device="cpu")
    return params, convert.load_numpy_state_dict(vae, convert.shapevae_state_dict(params, cfg))


def _dino(dcfg, seed=0):
    params = jax.device_get(jax.jit(jdino.init, static_argnums=1)(jax.random.PRNGKey(seed), dcfg))
    enc = build(tcond.DinoImageEncoder,
                tcond.DinoEncoderConfig(dino=tdino.DinoConfig(**SMALL_DINO),
                                        image_size=dcfg.image_size), device="cpu")
    return params, convert.load_numpy_state_dict(enc, convert.dinov2_state_dict(params, dcfg))


@pytest.mark.parametrize("cfg", [jdit.TINY, DIT_GUIDED], ids=["tiny", "guidance"])
def test_dit_state_dict_round_trip(cfg):
    params, model = _dit(cfg)
    sd = {k: v.float().numpy() for k, v in model.state_dict().items()}
    _tree_equal(checkpoints.map_dit(sd, cfg), params)


def test_shapevae_state_dict_round_trip():
    params, vae = _vae(jsv.TINY)
    sd = {k: v.float().numpy() for k, v in vae.state_dict().items()}
    _tree_equal(checkpoints.map_shapevae(sd, jsv.TINY), params)


def test_dinov2_state_dict_round_trip():
    dcfg = jdino.DinoConfig(**SMALL_DINO)
    params, enc = _dino(dcfg)
    sd = {k: v.float().numpy() for k, v in enc.state_dict().items()}
    _tree_equal(checkpoints.map_dinov2(sd, dcfg), params)


def test_dinov2_forward_matches():
    dcfg = jdino.DinoConfig(**SMALL_DINO)
    params, enc = _dino(dcfg)
    pix = np.random.RandomState(0).randn(2, 56, 56, 3).astype(np.float32)
    ref = jdino.apply(params, dcfg, jnp.asarray(pix, jnp.bfloat16))
    out = enc.encode(torch.from_numpy(pix).to(torch.bfloat16))
    assert out.dtype == torch.bfloat16
    # bf16 activations through two layers; rounding happens at other places
    assert_close(out, ref, 0.05)


def test_conditioner_matches():
    """Preprocess (numpy, copied) + encode + the zeros unconditional stream."""
    dcfg = jdino.DinoConfig(**SMALL_DINO)
    params, enc = _dino(dcfg)
    jenc = jcond.SingleImageEncoder(jcond.DinoImageEncoder(
        params, jcond.DinoEncoderConfig(dino=dcfg, image_size=56)))
    tenc = tcond.SingleImageEncoder(enc)
    img = np.random.RandomState(1).uniform(-1, 1, (1, 64, 64, 3)).astype(np.float32)
    np.testing.assert_array_equal(_np(tenc.main.preprocess(img)), _np(jenc.main.preprocess(img)))
    assert_close(tenc.encode_image(img)["main"], jenc.encode_image(img)["main"], 0.05)
    u_t, u_j = tenc.unconditional(2)["main"], jenc.unconditional(2)["main"]
    assert u_t.dtype == torch.bfloat16 and tuple(u_t.shape) == u_j.shape
    assert not u_t.any()


@pytest.mark.parametrize("cfg", [jdit.TINY, DIT_GUIDED], ids=["tiny", "guidance"])
def test_dit_forward_matches(cfg):
    params, model = _dit(cfg)
    rs = np.random.RandomState(2)
    x = rs.randn(2, 64, 64).astype(np.float32)
    cond = rs.randn(2, 37, 1536).astype(np.float32)
    t = np.array([0.25, 0.75], np.float32)
    g = np.array([5.0, 5.0], np.float32) if cfg.guidance_embed else None
    ref = jdit.apply(params, cfg, jnp.asarray(x, jnp.bfloat16), jnp.asarray(t),
                     jnp.asarray(cond, jnp.bfloat16), None if g is None else jnp.asarray(g))
    out = model(torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(t),
                torch.from_numpy(cond).to(torch.bfloat16),
                None if g is None else torch.from_numpy(g))
    assert_close(out, ref, 0.05)


@pytest.mark.parametrize("cfg", [jsv.TINY, jsv.ShapeVAEConfig(
    num_latents=64, width=128, heads=2, num_decoder_layers=2)], ids=["tiny", "fused-gate"])
def test_shapevae_decode_matches(cfg):
    """decode_latents and compute_kv in fp32, decode_queries on bf16 K/V."""
    params, vae = _vae(cfg)
    rs = np.random.RandomState(3)
    lat = rs.randn(1, cfg.num_latents, cfg.embed_dim).astype(np.float32)
    hidden_j = jsv.decode_latents(params, cfg, jnp.asarray(lat))
    hidden_t = vae.decode_latents(torch.from_numpy(lat))
    assert hidden_t.dtype == torch.float32
    assert_close(hidden_t, hidden_j, 1e-4)  # fp32 throughout; bf16 weights in both
    kj, vj = jsv.compute_kv(params, cfg, hidden_j)
    kt, vt = vae.compute_kv(hidden_t)
    assert_close(kt, kj, 1e-4)
    assert_close(vt, vj, 1e-4)
    pts = rs.uniform(-1.01, 1.01, (1, 500, 3)).astype(np.float32)
    ref = jsv.decode_queries(params, cfg, jnp.asarray(pts),
                             (kj.astype(jnp.bfloat16), vj.astype(jnp.bfloat16)))
    out = vae.query_decoder(kt, vt)(torch.from_numpy(pts))
    assert out.dtype == torch.float32
    assert_close(out, ref, 0.05)
