"""Gradients around the port's kernels, on the CPU.

* Kernel 1's autograd wrapper (ops/flash_attention._FlashAttentionFn): its
  CUDA branch, with the launch replaced by the plain twin, gives
  ``ops.attention.attention`` the plain autograd's gradients (fp32, 1e-5:
  the backward is the plain twin's own gradient, recomputed).
* The kernels without a gradient (the masked flash attention, the geo
  decoder's chain, the streamed decode's tail, the rasterizer and the
  tile-sweep variants) refuse inputs that require one while grad mode is
  on, on either device, and run as before otherwise.
* The VAE's dense decode (``ShapeVAE.decode_queries``, the vanilla and
  hierarchical decoders' decode) attends through ``ops.attention.attention``
  (JAX models/shapevae.py:179), and its grids still match the JAX package's
  (tests/test_torch_surface.py's tolerance).

The kernels' own gradients and refusals on the card are in
tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hunyuan3d2_tpu.models import shapevae as jsv
from hunyuan3d2_tpu_torch.io import convert
from hunyuan3d2_tpu_torch.models import shapevae as tsv
from hunyuan3d2_tpu_torch.ops import attention as att
from hunyuan3d2_tpu_torch.ops import flash_attention as fa
from hunyuan3d2_tpu_torch.ops import geo_decoder, rasterize
from hunyuan3d2_tpu_torch.tools import profile_flash_variants


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def kernel_branch(monkeypatch):
    """``attention`` takes kernel 1's CUDA branch on CPU tensors: the gate
    passes, and the launch computes the plain twin. Returns the launches."""
    launches = []

    def launch(q, k, v, mask, scale):
        assert mask is None
        launches.append(tuple(q.shape))
        return fa.flash_attention_plain(q, k, v, scale)

    def cuda_branch(q, k, v, scale=None):   # flash_attention's branch for CUDA tensors
        fa._check(q, k, v)
        return fa._FlashAttentionFn.apply(q, k, v, q.shape[-1] ** -0.5 if scale is None
                                          else scale)

    monkeypatch.setattr(fa, "_launch", launch)
    monkeypatch.setattr(att, "use_flash", lambda q: True)
    monkeypatch.setattr(att, "flash_attention", cuda_branch)
    return launches


def _qkv(dtype, lq=40, lk=56, d=64, seed=0):
    g = torch.Generator().manual_seed(seed)
    return tuple(torch.randn(2, 3, n, d, generator=g).to(dtype) for n in (lq, lk, lk))


@pytest.mark.parametrize("needs", [(True, True, True), (True, False, False),
                                   (False, True, True)], ids=["qkv", "q", "kv"])
def test_attention_gradients_through_the_autograd_function(kernel_branch, needs):
    q, k, v = (t.requires_grad_(n) for t, n in zip(_qkv(torch.float32), needs))
    w = torch.randn(2, 3, 40, 64, generator=torch.Generator().manual_seed(1))
    before = fa.flash_attention.launches
    out = att.attention(q, k, v)
    assert kernel_branch == [(2, 3, 40, 64)] and fa.flash_attention.launches == before + 1
    assert out.grad_fn is not None and type(out.grad_fn).__name__.startswith("_FlashAttention")
    wanted = [t for t, n in zip((q, k, v), needs) if n]
    grads = torch.autograd.grad((out * w).sum(), wanted)
    ref_in = [t.detach().clone().requires_grad_(n) for t, n in zip((q, k, v), needs)]
    ref_out = fa.flash_attention_plain(*ref_in)
    refs = torch.autograd.grad((ref_out * w).sum(), [t for t in ref_in if t.requires_grad])
    torch.testing.assert_close(out, ref_out, atol=0, rtol=0)
    for g, r in zip(grads, refs):
        torch.testing.assert_close(g, r, atol=1e-5, rtol=1e-5)
    # the backward recomputes on the plain twin: no second launch
    assert len(kernel_branch) == 1


def test_bf16_gradients_keep_the_inputs_dtype(kernel_branch):
    q, k, v = (t.requires_grad_(True) for t in _qkv(torch.bfloat16))
    att.attention(q, k, v).float().square().sum().backward()
    assert all(t.grad is not None and t.grad.dtype == torch.bfloat16 for t in (q, k, v))
    assert all(torch.isfinite(t.grad.float()).all() for t in (q, k, v))


def test_no_graph_without_grad(kernel_branch):
    q, k, v = _qkv(torch.float32)
    with torch.no_grad():
        out = att.attention(q.requires_grad_(True), k, v)
    assert out.grad_fn is None and not out.requires_grad


def test_refuse_grad_logic():
    x = torch.zeros(2, requires_grad=True)
    fa.refuse_grad("k", None, torch.zeros(2))
    with torch.no_grad():
        fa.refuse_grad("k", x)
    with pytest.raises(RuntimeError, match="k has no gradient"):
        fa.refuse_grad("k", None, x)


def _geo_vae(num_latents):
    cfg = tsv.ShapeVAEConfig(num_latents=num_latents, width=128, heads=2, num_decoder_layers=1)
    return tsv.ShapeVAE.init_random(cfg, device="cpu")


def test_masked_flash_attention_refuses_gradients():
    q, k, v = _qkv(torch.float32)
    mask = torch.rand(2, 40, 56, generator=torch.Generator().manual_seed(2)) > 0.3
    out = fa.flash_attention_masked(q, k, v, mask)
    torch.testing.assert_close(out, fa.flash_attention_masked_plain(q, k, v, mask))
    with pytest.raises(RuntimeError, match="flash_attention_masked has no gradient"):
        fa.flash_attention_masked(q.requires_grad_(True), k, v, mask)
    with torch.no_grad():
        fa.flash_attention_masked(q, k, v, mask)


def test_flash_variant_refuses_gradients():
    q, k, v = _qkv(torch.bfloat16)
    with pytest.raises(RuntimeError, match="flash_attention_variant has no gradient"):
        profile_flash_variants.flash_attention_variant(q, k, v.requires_grad_(True), 0.125,
                                                       128, 128, 3)


@pytest.mark.parametrize("what", ["queries", "weights"])
def test_fused_geo_decode_refuses_gradients(what):
    vae = _geo_vae(64)
    g = torch.Generator().manual_seed(3)
    pts = torch.rand(1, 16, 3, generator=g) * 2 - 1
    k, v = (torch.randn(1, 2, 64, 64, generator=g).bfloat16() for _ in range(2))
    ref = geo_decoder.fused_geo_decode(vae, pts, k, v)
    if what == "queries":
        pts.requires_grad_(True)
    else:
        vae.geo_decoder.requires_grad_(True)
    with pytest.raises(RuntimeError, match="fused_geo_decode has no gradient"):
        geo_decoder.fused_geo_decode(vae, pts, k, v)
    with torch.no_grad():
        torch.testing.assert_close(geo_decoder.fused_geo_decode(vae, pts, k, v), ref)


def test_streamed_decode_and_its_tail_refuse_gradients():
    vae = _geo_vae(1280)
    g = torch.Generator().manual_seed(4)
    pts = torch.rand(1, 16, 3, generator=g) * 2 - 1
    k, v = (torch.randn(1, 2, 1280, 64, generator=g).bfloat16() for _ in range(2))
    x2 = torch.randn(1, 16, 128, generator=g).bfloat16()
    vae.geo_decoder.requires_grad_(True)
    with pytest.raises(RuntimeError, match="fused_geo_decode_stream has no gradient"):
        geo_decoder.fused_geo_decode_stream(vae, pts, k, v)
    with pytest.raises(RuntimeError, match="geo_mlp_tail has no gradient"):
        geo_decoder.geo_mlp_tail(vae, x2)
    vae.geo_decoder.requires_grad_(False)
    with pytest.raises(RuntimeError, match="geo_mlp_tail has no gradient"):
        geo_decoder.geo_mlp_tail(vae, x2.requires_grad_(True))
    assert geo_decoder.fused_geo_decode_stream(vae, pts, k, v).shape == (1, 16)


def test_rasterize_refuses_gradients():
    verts = torch.tensor([[-0.5, -0.5, 0.1, 1.0], [0.5, -0.5, 0.1, 1.0], [0.0, 0.5, 0.1, 1.0]])
    faces = torch.tensor([[0, 1, 2]], dtype=torch.int32)
    assert (rasterize.rasterize(verts, faces, 8, 8).face_id == 0).any()
    with pytest.raises(RuntimeError, match="rasterize has no gradient"):
        rasterize.rasterize(verts.requires_grad_(True), faces, 8, 8)


@pytest.fixture(scope="module")
def vaes():
    """tests/test_torch_surface.py's tiny VAE pair."""
    jvae = jsv.ShapeVAE.init_random(jax.random.PRNGKey(1), jsv.TINY)
    tvae = tsv.ShapeVAE.init_random(tsv.TINY, device="cpu")
    convert.load_numpy_state_dict(
        tvae, convert.shapevae_state_dict(jax.device_get(jvae.params), jvae.cfg))
    lat = np.random.RandomState(7).randn(1, 64, 64).astype(np.float32)
    return jvae, tvae, lat


@pytest.mark.parametrize("kind", ["vanilla", "hierarchical"])
def test_dense_decode_attends_through_the_dispatcher(vaes, monkeypatch, kind):
    jvae, tvae, lat = vaes
    calls = []

    def recording(q, k, v, scale=None):
        calls.append((tuple(q.shape), q.dtype))
        return att.attention(q, k, v, scale)

    monkeypatch.setattr(tsv, "attention", recording)
    for vae in (jvae, tvae):
        if kind == "vanilla":
            vae.enable_flashvdm_decoder(enabled=False)
        else:
            vae.enable_flashvdm_decoder(mc_algo="mc", adaptive_kv_selection=False)
    ref = np.asarray(jvae.decode_grid(jnp.asarray(lat), 24, 4096))
    with torch.no_grad():
        out = tvae.decode_grid(torch.from_numpy(lat), 24, 4096).numpy()
    # the dense decode's chunks (4096 queries) and, for the vanilla decoder,
    # nothing else: the latent transformer's self-attention does not reach it
    assert calls and all(s[0] == 1 and s[1] == tsv.TINY.heads and s[3] == tsv.TINY.head_dim
                         and dt == torch.float32 for s, dt in calls)
    assert any(s[2] == 4096 for s, _ in calls)
    np.testing.assert_allclose(out, ref, atol=1e-3)
