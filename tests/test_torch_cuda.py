"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Marked ``cuda``: without a CUDA device each test skips with its reason (a
kernel written in CUDA has no CPU mode). On the card:
``python -m pytest -m cuda tests/test_torch_cuda.py``. This file imports no
JAX, so it also runs where only PyTorch is installed.
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.Generator(device="cuda").manual_seed(0)


# bf16: the output is rounded once (ulp 2^-8 at 1) and P before P.V in both,
# at other block boundaries; fp32: summation order only
@pytest.mark.parametrize("dt,tol", [(torch.bfloat16, 2e-2), (torch.float32, 1e-4)])
@pytest.mark.parametrize("lq,lk,d", [(130, 200, 64), (700, 333, 128), (512, 512, 64)])
def test_flash_attention_kernel_matches_plain(gen, lq, lk, d, dt, tol):
    from hunyuan3d2_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain

    q = torch.randn(2, 3, lq, d, generator=gen, device="cuda").to(dt)
    k = torch.randn(2, 3, lk, d, generator=gen, device="cuda").to(dt)
    v = torch.randn(2, 3, lk, d, generator=gen, device="cuda").to(dt)
    before = flash_attention.launches
    out = flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert out.dtype == dt and out.shape == q.shape
    torch.testing.assert_close(out.float(), flash_attention_plain(q, k, v).float(),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("width,heads,latents,p", [(128, 2, 64, 300), (1024, 16, 512, 1000)])
def test_geo_decode_kernel_matches_plain(gen, width, heads, latents, p):
    from hunyuan3d2_tpu_torch.models import shapevae as sv
    from hunyuan3d2_tpu_torch.ops.geo_decoder import decode_queries_plain, fused_geo_decode

    cfg = sv.ShapeVAEConfig(num_latents=latents, width=width, heads=heads, num_decoder_layers=2)
    vae = sv.ShapeVAE.init_random(cfg, device="cuda", generator=gen)
    with torch.no_grad():
        lat = torch.randn(1, latents, cfg.embed_dim, generator=gen, device="cuda")
        k, v = vae.compute_kv(vae.decode_latents(lat))
        k, v = k.to(torch.bfloat16).contiguous(), v.to(torch.bfloat16).contiguous()
        pts = (torch.rand(1, p, 3, generator=gen, device="cuda") * 2.02 - 1.01).contiguous()
        out = fused_geo_decode(vae, pts, k, v)
        ref = decode_queries_plain(vae, pts, k, v).float()
    torch.cuda.synchronize()
    out, ref = out.cpu().numpy(), ref.cpu().numpy()
    # the plain decode keeps the residual in bf16 where the kernel keeps fp32
    assert np.corrcoef(out.ravel(), ref.ravel())[0, 1] > 0.9999
    assert np.abs(out - ref).max() < 0.05 * max(1.0, np.abs(ref).max())


def test_kernel_wrappers_raise_on_bad_input(gen):
    from hunyuan3d2_tpu_torch.ops.flash_attention import flash_attention

    q = torch.zeros(1, 2, 64, 64, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        flash_attention(q, q.cpu(), q.cpu())
    with pytest.raises(ValueError):
        flash_attention(q.transpose(2, 3), q.transpose(2, 3), q.transpose(2, 3))
