"""The geo decoder's kernel chain (hunyuan3d2_tpu_torch/ops/geo_decoder.py)
against the JAX package, on the CPU.

Each kernel of the chain (LN rows, the GEMM's three epilogues, ln_post with
the output dot) has a plain twin; here every twin is held against the
arithmetic of the Pallas kernels it was cut from
(hunyuan3d2_tpu/ops/geo_decoder_pallas.py ``_kernel`` and
``_geo_mlp_kernel``), and the twins composed as the card composes the
kernels are held against the JAX fused decoder (its Pallas kernel in
interpret mode). Inputs are made by numpy from a seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hunyuan3d2_tpu.models import shapevae as jsv
from hunyuan3d2_tpu.ops import geo_decoder_pallas as jgp
from hunyuan3d2_tpu.ops import nn as jnn
from hunyuan3d2_tpu.ops.geo_decoder_pallas import fused_geo_decode as jfused
from hunyuan3d2_tpu_torch.io.convert import load_numpy_state_dict, shapevae_state_dict
from hunyuan3d2_tpu_torch.models import shapevae as tsv
from hunyuan3d2_tpu_torch.ops import geo_decoder as tg

BF = jnp.bfloat16


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _inputs(seed, rows, k, n):
    """bf16 rows [rows, k], bf16 weights [n, k] (torch layout), fp32 bias."""
    rs = np.random.RandomState(seed)
    a = rs.randn(rows, k).astype(np.float32)
    w = (rs.randn(n, k) * k ** -0.5).astype(np.float32)
    b = (rs.randn(n) * 0.1).astype(np.float32)
    ta, tw = (torch.from_numpy(x).to(torch.bfloat16) for x in (a, w))
    return (jnp.asarray(a, BF), jnp.asarray(w, BF), jnp.asarray(b)), (ta, tw, torch.from_numpy(b))


def _bf16_close(out, ref):
    """bf16 results of one fp32 value summed in another order: equal or one
    bf16 ulp apart (at most 2^-7 of the value)."""
    np.testing.assert_allclose(_np(out), _np(ref), atol=1e-5, rtol=2.0 ** -7 + 1e-6)


def _vae(cfg, seed=0):
    params = jax.device_get(jax.jit(jsv.init, static_argnums=1)(jax.random.PRNGKey(seed), cfg))
    vae = tsv.ShapeVAE.init_random(tsv.ShapeVAEConfig(**cfg.__dict__), device="cpu")
    return params, load_numpy_state_dict(vae, shapevae_state_dict(params, cfg))


@pytest.mark.parametrize("rows,k,n", [(37, 64, 128), (130, 256, 512)])
def test_gemm_epilogue_twins_match_pallas_arithmetic(rows, k, n):
    """E1 and E2 against the Pallas kernels' own lines: t = dot + b, A&S
    gelu, rounded to bf16 (geo_decoder_pallas.py:126-128); acc = x2 + b +
    dot (:120, :124)."""
    (ja, jw, jb), (ta, tw, tb) = _inputs(rows + k, rows, k, n)
    t = jgp._dot(ja, jw.T) + jb
    t = 0.5 * t * (1.0 + jgp._erf(t * (2.0 ** -0.5)))
    _bf16_close(tg.gemm_gelu_plain(ta, tw, tb), t.astype(BF))
    resid = np.random.RandomState(k).randn(rows, n).astype(np.float32)
    ref = jnp.asarray(resid) + jgp._dot(ja, jw.T) + jb
    np.testing.assert_allclose(_np(tg.gemm_residual_plain(ta, tw, tb, torch.from_numpy(resid))),
                               _np(ref), atol=1e-5, rtol=1e-5)
    ref16 = jnp.asarray(resid, BF).astype(jnp.float32) + jb + jgp._dot(ja, jw.T)
    out16 = tg.gemm_residual_plain(ta, tw, tb, torch.from_numpy(resid).to(torch.bfloat16))
    np.testing.assert_allclose(_np(out16), _np(ref16), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("d", [64, 128])
def test_head_ln_twin_matches_jax_q_norm(d):
    """E3 (c_q and the per-head q LayerNorm) against the JAX stream's
    projection and q-norm (geo_decoder_pallas.py:346-356), laid out
    [H, P, D] bf16 as kernel 1 takes q."""
    rows, k, n = 77, 256, 512
    (ja, jw, jb), (ta, tw, tb) = _inputs(d, rows, k, n)
    rs = np.random.RandomState(d + 1)
    s, b = (rs.rand(d) + 0.5).astype(np.float32), (rs.randn(d) * 0.1).astype(np.float32)
    qm = jnp.einsum("pw,uw->pu", ja, jw, preferred_element_type=jnp.float32) + jb
    ref = jnn.layer_norm(qm.reshape(rows, n // d, d), jnp.asarray(s), jnp.asarray(b), 1e-6)
    ref = ref.transpose(1, 0, 2).astype(BF)
    out = tg.gemm_head_ln_plain(ta, tw, tb, torch.from_numpy(s), torch.from_numpy(b), d, 1e-6)
    assert tuple(out.shape) == (n // d, rows, d) and out.dtype == torch.bfloat16
    _bf16_close(out, ref)
    # the wrapper takes its twin on a CPU tensor and launches nothing
    before = tg.gemm_head_ln.launches
    wrapped = tg.gemm_head_ln(ta, tw, tb, torch.from_numpy(s), torch.from_numpy(b), d, 1e-6)
    assert tg.gemm_head_ln.launches == before
    assert torch.equal(wrapped, out)


@pytest.mark.parametrize("dt", ["bf16", "fp32"])
def test_row_twins_match_pallas_arithmetic(dt):
    """LN rows and ln_post + the output dot against _ln_f32 and the output
    matvec of the Pallas kernels (geo_decoder_pallas.py:284-285, :294-296)."""
    rs = np.random.RandomState(7)
    x = (rs.randn(50, 256) * 3.0 + 1.0).astype(np.float32)
    s, b = (rs.rand(256) + 0.5).astype(np.float32), (rs.randn(256) * 0.1).astype(np.float32)
    wout = (rs.randn(256) * 0.06).astype(np.float32)
    jx = jnp.asarray(x, BF if dt == "bf16" else jnp.float32)
    tx = torch.from_numpy(x).to(torch.bfloat16 if dt == "bf16" else torch.float32)
    js, jb = jnp.asarray(s)[None], jnp.asarray(b)[None]
    ts, tb = torch.from_numpy(s), torch.from_numpy(b)
    h = jgp._ln_f32(jx.astype(jnp.float32), js, jb, 1e-6).astype(BF)
    _bf16_close(tg.ln_rows_plain(tx, ts, tb, 1e-6), h)
    assert torch.equal(tg.ln_rows(tx, ts, tb, 1e-6), tg.ln_rows_plain(tx, ts, tb, 1e-6))
    if dt == "fp32":
        ref = jgp._dot_t(jnp.asarray(wout, BF)[None], h)[0] + 0.25
        tw = torch.from_numpy(wout).to(torch.bfloat16)
        out = tg.ln_dot_rows_plain(tx, ts, tb, tw, torch.tensor([0.25]), 1e-6)
        np.testing.assert_allclose(_np(out), _np(ref), atol=2e-2, rtol=1e-3)


@pytest.mark.parametrize("heads,bound,corr_gap", [
    # D = 64: kernel 1's scale (1/8) is exact, so its q equals the Pallas
    # kernel's: 1.0e-3 of the scale and 1 - corr = 1.5e-8 measured
    (2, 3e-3, 1e-7),
    # D = 128: kernel 1 rounds q * 128^-0.5 to bf16 where the Pallas kernel
    # scales the fp32 scores: 4.3e-3 and 1 - corr = 8.1e-6 measured
    (1, 1e-2, 2e-5)])
def test_staged_chain_matches_fused_pallas_kernel(heads, bound, corr_gap):
    """The card's chain (the kernel wrappers, each taking its plain twin on
    these CPU tensors, and kernel 1's twin for the attention) against the
    JAX fused decoder's Pallas kernel in interpret mode; P = 300 is ragged
    against every tile."""
    cfg = jsv.ShapeVAEConfig(num_latents=64, width=128, heads=heads, num_decoder_layers=2)
    params, vae = _vae(cfg)
    rs = np.random.RandomState(3)
    d = 128 // heads
    k = rs.randn(1, heads, 64, d).astype(np.float32)
    v = rs.randn(1, heads, 64, d).astype(np.float32)
    pts = rs.uniform(-1.0, 1.0, (1, 300, 3)).astype(np.float32)
    ref = np.asarray(jfused(params, cfg, jnp.asarray(pts),
                            (jnp.asarray(k, BF), jnp.asarray(v, BF))), np.float32)
    tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (k, v))
    counts = {n: getattr(tg, n).launches for n in ("ln_rows", "gemm_residual", "gemm_gelu")}
    x2 = tg._front(vae, torch.from_numpy(pts), tk, tv, torch.float32, plain=False)
    out = tg._tail(vae, x2, plain=False).numpy()
    assert counts == {n: getattr(tg, n).launches for n in counts}   # no kernel on the CPU
    assert x2.dtype == torch.float32 and out.shape == ref.shape == (1, 300)
    assert np.abs(out - ref).max() <= bound * max(1.0, np.abs(ref).max())
    assert 1.0 - np.corrcoef(out.ravel(), ref.ravel())[0, 1] < corr_gap


def test_kernel_operands_are_cached_until_a_weight_changes():
    """_operands builds the kernels' operands once per VAE; a load_state_dict
    (an in-place copy into every parameter) makes it build them again, with
    the new values."""
    cfg = tsv.ShapeVAEConfig(num_latents=64, width=128, heads=2, num_decoder_layers=1)
    vae = tsv.ShapeVAE.init_random(cfg, device="cpu")
    first = tg._operands(vae, torch.device("cpu"))
    second = tg._operands(vae, torch.device("cpu"))
    assert second is first and all(second[n] is first[n] for n in first)
    state = {n: t.clone() for n, t in vae.state_dict().items()}
    state["geo_decoder.cross_attn_decoder.mlp.c_fc.bias"] += 1.0
    state["geo_decoder.output_proj.bias"] += 2.0
    vae.load_state_dict(state)
    third = tg._operands(vae, torch.device("cpu"))
    assert third is not first
    torch.testing.assert_close(third["bfc"],
                               state["geo_decoder.cross_attn_decoder.mlp.c_fc.bias"].float())
    torch.testing.assert_close(third["bout"], state["geo_decoder.output_proj.bias"].float())
    assert not torch.equal(third["bout"], first["bout"])
    assert tg._operands(vae, torch.device("cpu")) is third


def test_chain_wrappers_refuse_what_the_kernels_do_not_take():
    a = torch.zeros(10, 128, dtype=torch.bfloat16)
    w = torch.zeros(256, 128, dtype=torch.bfloat16)
    bias = torch.zeros(256)
    assert tg.gemm_gelu(a, w, bias).shape == (10, 256)
    with pytest.raises(ValueError):       # K % 64
        tg.gemm_gelu(torch.zeros(10, 96, dtype=torch.bfloat16),
                     torch.zeros(256, 96, dtype=torch.bfloat16), bias)
    with pytest.raises(ValueError):       # fp32 A
        tg.gemm_gelu(a.float(), w, bias)
    with pytest.raises(ValueError):       # bias of the wrong length
        tg.gemm_residual(a, w, torch.zeros(128))
    with pytest.raises(ValueError):       # a bf16 output over a bf16 residual
        tg.gemm_residual(a, w, bias, torch.zeros(10, 256, dtype=torch.bfloat16), torch.bfloat16)
    with pytest.raises(ValueError):       # head size 32
        tg.gemm_head_ln(a, w, bias, torch.ones(32), torch.zeros(32), 32, 1e-6)
    with pytest.raises(ValueError):       # W % 128
        tg.ln_rows(torch.zeros(4, 96), torch.ones(96), torch.zeros(96), 1e-6)
    with pytest.raises(ValueError):       # ln_post takes fp32 rows
        tg.ln_dot_rows(torch.zeros(4, 128, dtype=torch.bfloat16), torch.ones(128),
                       torch.zeros(128), torch.zeros(128, dtype=torch.bfloat16),
                       torch.zeros(1), 1e-6)
