"""Port ops (hunyuan3d2_tpu_torch.ops) against the JAX package's, on the CPU.

Inputs are made by numpy from a seed and handed to both frameworks. The
Pallas kernels run as the JAX package's own tests run them here: flash
attention in interpret mode (tests/test_flash_attention.py patches
pallas_call the same way), the fused geo decoder through its own
interpret-on-CPU switch.
"""

import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hunyuan3d2_tpu.ops import attention as jattn
from hunyuan3d2_tpu.ops import embeddings as jemb
from hunyuan3d2_tpu.ops import nn as jnn
from hunyuan3d2_tpu_torch.ops import attention as tattn
from hunyuan3d2_tpu_torch.ops import embeddings as temb
from hunyuan3d2_tpu_torch.ops import nn as tnn
from hunyuan3d2_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain

DT = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
# fp32: only the summation order differs; bf16: one rounding of the output
# (ulp 2^-8 at 1) plus rounding of intermediates at other places
TOL = {"fp32": dict(atol=2e-5, rtol=2e-5), "bf16": dict(atol=2e-2, rtol=2e-2)}


def _pair(a: np.ndarray, dt: str):
    jdt, tdt = DT[dt]
    a = np.asarray(a, np.float32)
    return jnp.asarray(a, jdt), torch.from_numpy(a).to(tdt)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
def test_dense_and_norms(dt):
    rs = np.random.RandomState(0)
    x, w, b, s = rs.randn(3, 5, 96), rs.randn(96, 48) * 0.1, rs.randn(48), rs.rand(96) + 0.5
    jx, tx = _pair(x, dt)
    jw, tw = _pair(w, "bf16")
    jb, tb = _pair(b, "bf16")
    np.testing.assert_allclose(_np(tnn.dense(tx, tw.T.contiguous(), tb)),
                               _np(jnn.dense(jx, jw, jb)), **TOL[dt])
    js, ts = _pair(s, "fp32")
    np.testing.assert_allclose(_np(tnn.layer_norm(tx, ts, ts)),
                               _np(jnn.layer_norm(jx, js, js)), **TOL[dt])
    np.testing.assert_allclose(_np(tnn.layer_norm(tx)), _np(jnn.layer_norm(jx)), **TOL[dt])
    np.testing.assert_allclose(_np(tnn.rms_norm(tx, ts)), _np(jnn.rms_norm(jx, js)), **TOL[dt])
    for tf, jf in ((tnn.gelu_tanh, jnn.gelu_tanh), (tnn.gelu_exact, jnn.gelu_exact),
                   (tnn.silu, jnn.silu)):
        np.testing.assert_allclose(_np(tf(tx)), _np(jf(jx)), **TOL[dt])


def test_embeddings():
    rs = np.random.RandomState(1)
    t = rs.rand(4).astype(np.float32)
    ref = jemb.timestep_embedding(jnp.asarray(t), 256, max_period=1000, time_factor=1000.0)
    out = temb.timestep_embedding(torch.from_numpy(t), 256, max_period=1000, time_factor=1000.0)
    # args up to 1000 rad: fp32 sin/cos of large arguments differ by ~1e-4
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-4)
    x = rs.uniform(-1.01, 1.01, (2, 7, 3)).astype(np.float32)
    for include_pi in (False, True):
        ref = jemb.fourier_embed(jnp.asarray(x), 8, include_pi)
        out = temb.fourier_embed(torch.from_numpy(x), 8, include_pi)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)
    assert temb.fourier_out_dim(3, 8) == jemb.fourier_out_dim(3, 8) == 51


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
def test_sdpa_and_head_layouts(dt):
    rs = np.random.RandomState(2)
    q, k, v = rs.randn(2, 3, 20, 32), rs.randn(2, 3, 28, 32), rs.randn(2, 3, 28, 32)
    (jq, tq), (jk, tk), (jv, tv) = _pair(q, dt), _pair(k, dt), _pair(v, dt)
    np.testing.assert_allclose(_np(tattn.sdpa(tq, tk, tv)), _np(jattn.sdpa(jq, jk, jv)),
                               **TOL[dt])
    # attention() on CPU tensors is sdpa, as the JAX dispatcher is off-TPU
    np.testing.assert_allclose(_np(tattn.attention(tq, tk, tv)), _np(jattn.sdpa(jq, jk, jv)),
                               **TOL[dt])
    x = rs.randn(2, 20, 3 * 4 * 8)
    jx, tx = _pair(x, "fp32")
    for a, b in zip(tattn.split_qkv_fused(tx, 4), jattn.split_qkv_fused(jx, 4)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(tattn.split_heads(tx, 6).numpy(),
                                  np.asarray(jattn.split_heads(jx, 6)))
    h = rs.randn(2, 4, 20, 8).astype(np.float32)
    np.testing.assert_array_equal(tattn.merge_heads(torch.from_numpy(h)).numpy(),
                                  np.asarray(jattn.merge_heads(jnp.asarray(h))))


def _jax_flash_interpret(q, k, v, bq=128, bk=128):
    from jax.experimental import pallas as pl

    from hunyuan3d2_tpu.ops import flash_attention as fa

    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    with mock.patch.object(pl, "pallas_call", patched):
        out = fa._flash.__wrapped__(q.reshape(-1, *q.shape[2:]), k.reshape(-1, *k.shape[2:]),
                                    v.reshape(-1, *v.shape[2:]), q.shape[-1] ** -0.5, bq, bk)
    return out.reshape(q.shape[0], q.shape[1], q.shape[2], -1)


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("lq,lk", [(128, 128), (130, 200)])
def test_plain_flash_matches_pallas_kernel(lq, lk, d, dt):
    rs = np.random.RandomState(lq + lk + d)
    q, k, v = rs.randn(1, 2, lq, d), rs.randn(1, 2, lk, d), rs.randn(1, 2, lk, d)
    (jq, tq), (jk, tk), (jv, tv) = _pair(q, dt), _pair(k, dt), _pair(v, dt)
    ref = _np(_jax_flash_interpret(jq, jk, jv))
    # the wrapper takes the plain version for CPU tensors
    out = _np(flash_attention(tq, tk, tv))
    np.testing.assert_array_equal(out, _np(flash_attention_plain(tq, tk, tv)))
    np.testing.assert_allclose(out, ref, **TOL[dt])


def test_plain_flash_fp32_error_within_the_analysed_bound():
    """The plain twin's fp32 result against an fp64 evaluation of the same
    function at the v2-0 VAE's shape [1, 16, 3072, 64]: every element within
    the bound of tools/flash_fp32_error.py (its fp32 GEMMs sum in another
    order than the kernel, within the same analysis). The bound is tight
    enough to refuse products in TF32: a logit error of 2^-11 per product
    exceeds it."""
    from hunyuan3d2_tpu_torch.ops.flash_attention import flash_attention_plain
    from hunyuan3d2_tpu_torch.tools.flash_fp32_error import check_against_fp64, fp32_error_bound

    gen = torch.Generator().manual_seed(3072)
    q, k, v = (torch.randn(1, 16, 3072, 64, generator=gen) for _ in range(3))
    ref, bound = fp32_error_bound(q, k, v)
    res = check_against_fp64(flash_attention_plain(q, k, v), ref, bound)
    assert res["within"] and res["max_share_of_bound"] < 0.1, res
    # the same products with each operand rounded to TF32 (10 mantissa bits)
    tf32 = [(x.view(torch.int32) + 0x1000 & ~0x1FFF).view(torch.float32) for x in (q, k)]
    res = check_against_fp64(flash_attention_plain(*tf32, v), ref, bound)
    assert not res["within"], res


def test_flash_wrapper_rejects_what_the_kernel_does_not_take():
    x = torch.zeros(1, 2, 16, 64)
    with pytest.raises(ValueError):
        flash_attention(torch.zeros(1, 2, 16, 32), torch.zeros(1, 2, 16, 32),
                        torch.zeros(1, 2, 16, 32))
    with pytest.raises(TypeError):
        flash_attention(x.half(), x.half(), x.half())
    with pytest.raises(ValueError):
        flash_attention(x, torch.zeros(1, 2, 8, 32), torch.zeros(1, 2, 8, 32))
    with pytest.raises(ValueError):
        flash_attention(x.transpose(2, 3), x.transpose(2, 3), x.transpose(2, 3))


def test_plain_geo_decode_matches_fused_pallas_kernel():
    """The port's plain geo decode (kernel 3's twin, geo_decode_plain, which
    the wrapper takes on a CPU tensor) against the JAX fused Pallas kernel,
    which interprets on the CPU; P=300 leaves a ragged tile."""
    from hunyuan3d2_tpu.models import shapevae as jsv
    from hunyuan3d2_tpu.ops.geo_decoder_pallas import fused_geo_decode as jfused
    from hunyuan3d2_tpu_torch.io.convert import load_numpy_state_dict, shapevae_state_dict
    from hunyuan3d2_tpu_torch.models import shapevae as tsv
    from hunyuan3d2_tpu_torch.ops.geo_decoder import fused_geo_decode, fused_geo_supported

    cfg = jsv.ShapeVAEConfig(num_latents=64, width=128, heads=2, num_decoder_layers=2)
    tcfg = tsv.ShapeVAEConfig(**cfg.__dict__)
    assert fused_geo_supported(tcfg)
    params = jax.jit(jsv.init, static_argnums=1)(jax.random.PRNGKey(0), cfg)
    vae = tsv.ShapeVAE.init_random(tcfg, device="cpu")
    load_numpy_state_dict(vae, shapevae_state_dict(jax.device_get(params), cfg))

    rs = np.random.RandomState(3)
    k = rs.randn(1, 2, 64, 64).astype(np.float32)
    v = rs.randn(1, 2, 64, 64).astype(np.float32)
    pts = rs.uniform(-1.0, 1.0, (1, 300, 3)).astype(np.float32)
    kv16 = (jnp.asarray(k, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16))
    ref = np.asarray(jfused(params, cfg, jnp.asarray(pts), kv16), np.float32)
    tk = torch.from_numpy(k).to(torch.bfloat16)
    tv = torch.from_numpy(v).to(torch.bfloat16)
    out = fused_geo_decode(vae, torch.from_numpy(pts), tk, tv).numpy()
    assert out.shape == ref.shape == (1, 300)
    # the twin keeps the fp32 residual and rounds where the Pallas kernel
    # rounds; only the order of fp32 sums and erf (torch's against A&S 7.1.26)
    # differ, so a bf16 rounding may flip by one ulp: measured 1.0e-3 of the
    # scale and 1 - corr = 1.5e-8 (the bf16-residual dense decode: 9.1e-3
    # and 3.2e-5)
    assert 1.0 - np.corrcoef(ref.ravel(), out.ravel())[0, 1] < 1e-7
    assert np.abs(ref - out).max() <= 3e-3 * max(1.0, np.abs(ref).max())


@pytest.mark.parametrize("seed", range(4))
def test_stable_topk_breaks_ties_as_jax(seed):
    from hunyuan3d2_tpu_torch.volume.decoders import stable_topk

    rs = np.random.RandomState(seed)
    scores = rs.randint(0, 4, size=300).astype(np.float32)
    for k in (1, 5, 37, 150):
        _, ref = jax.lax.top_k(jnp.asarray(scores), k)
        out = stable_topk(torch.from_numpy(scores), k)
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    # the case that tells the two apart: torch.topk gives [1, 6, 3, 0, 7]
    s = np.array([0, 1, 0, 1, 0, 0, 1, 0], np.float32)
    np.testing.assert_array_equal(stable_topk(torch.from_numpy(s), 5).numpy(), [1, 3, 6, 0, 2])



def test_geo_wrapper_rejects_what_the_kernel_does_not_take():
    from hunyuan3d2_tpu_torch.models import shapevae as tsv
    from hunyuan3d2_tpu_torch.ops.geo_decoder import fused_geo_decode, fused_geo_supported

    cfg = tsv.ShapeVAEConfig(num_latents=64, width=128, heads=2, num_decoder_layers=1)
    vae = tsv.ShapeVAE.init_random(cfg, device="cpu")
    pts = torch.zeros(1, 10, 3)
    kv = torch.zeros(1, 2, 64, 64, dtype=torch.bfloat16)
    assert fused_geo_decode(vae, pts, kv, kv).shape == (1, 10)
    assert not fused_geo_supported(tsv.TINY)              # head_dim 32
    with pytest.raises(ValueError):
        fused_geo_decode(tsv.ShapeVAE.init_random(tsv.TINY, device="cpu"), pts, kv, kv)
    odd = torch.zeros(1, 2, 60, 64, dtype=torch.bfloat16)  # kernel 1 takes any L
    assert fused_geo_decode(vae, pts, odd, odd).shape == (1, 10)
    with pytest.raises(ValueError):                       # head size 32
        narrow = torch.zeros(1, 2, 64, 32, dtype=torch.bfloat16)
        fused_geo_decode(vae, pts, narrow, narrow)
    with pytest.raises(TypeError):
        fused_geo_decode(vae, pts, kv.float(), kv.float())
    with pytest.raises(ValueError):
        fused_geo_decode(vae, torch.zeros(2, 10, 3), kv, kv)


def test_kernel_library_path_follows_headers(monkeypatch, tmp_path):
    """A changed header under csrc/ gives a new library path, so a stale
    build is never loaded; so does a changed source or a new header."""
    from hunyuan3d2_tpu_torch.utils import cuda_build

    monkeypatch.setattr(cuda_build, "CSRC", str(tmp_path))
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// v1\n")
    first = cuda_build.library_path("k")
    assert cuda_build.library_path("k") == first
    (tmp_path / "h.cuh").write_text("// v2\n")
    second = cuda_build.library_path("k")
    assert second != first
    (tmp_path / "other.cuh").write_text("// new\n")
    third = cuda_build.library_path("k")
    assert third not in (first, second)
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n// edited\n')
    fourth = cuda_build.library_path("k")
    assert fourth not in (first, second, third)
    assert os.path.basename(fourth).startswith("libk-") and fourth.endswith(".so")


def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    """No compiler, no silent fallback: building a kernel raises."""
    from hunyuan3d2_tpu_torch.utils import cuda_build

    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.build(["flash_attention"])
