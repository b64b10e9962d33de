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


# every compiled tile configuration of the sweep at a ragged shape; the
# fp32 kernel (3xTF32) at fp32-grade error; D = 128 over several q tiles
VARIANT_CFGS = [(64, 128, 2), (64, 128, 3), (128, 64, 3), (128, 128, 2), (128, 128, 3)]


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("cfg", VARIANT_CFGS)
def test_flash_variant_kernel_matches_plain(gen, cfg, d):
    from hunyuan3d2_tpu_torch.ops.flash_attention import flash_attention_plain
    from hunyuan3d2_tpu_torch.tools.profile_flash_variants import VARIANTS, flash_attention_variant

    assert tuple(VARIANTS) == tuple(VARIANT_CFGS)
    q = torch.randn(2, 3, 130, d, generator=gen, device="cuda").to(torch.bfloat16)
    k = torch.randn(2, 3, 200, d, generator=gen, device="cuda").to(torch.bfloat16)
    v = torch.randn(2, 3, 200, d, generator=gen, device="cuda").to(torch.bfloat16)
    before = flash_attention_variant.launches
    out = flash_attention_variant(q, k, v, d ** -0.5, *cfg)
    torch.cuda.synchronize()
    assert flash_attention_variant.launches == before + 1
    torch.testing.assert_close(out.float(), flash_attention_plain(q, k, v).float(),
                               atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("lk", [77, 200, 333, 1370, 4442])
def test_flash_attention_ragged_key_lengths(gen, lk):
    from hunyuan3d2_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain

    q = torch.randn(1, 4, 300, 64, generator=gen, device="cuda").to(torch.bfloat16)
    k = torch.randn(1, 4, lk, 64, generator=gen, device="cuda").to(torch.bfloat16)
    v = torch.randn(1, 4, lk, 64, generator=gen, device="cuda").to(torch.bfloat16)
    out = flash_attention(q, k, v)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), flash_attention_plain(q, k, v).float(),
                               atol=2e-2, rtol=2e-2)


def test_flash_attention_d128_bf16_many_q_tiles(gen):
    from hunyuan3d2_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain

    q = torch.randn(1, 8, 1500, 128, generator=gen, device="cuda").to(torch.bfloat16)
    k = torch.randn(1, 8, 1100, 128, generator=gen, device="cuda").to(torch.bfloat16)
    v = torch.randn(1, 8, 1100, 128, generator=gen, device="cuda").to(torch.bfloat16)
    out = flash_attention(q, k, v)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), flash_attention_plain(q, k, v).float(),
                               atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("lq,lk,d", [(512, 512, 64), (1000, 333, 128), (3072, 3072, 64)])
def test_flash_attention_fp32_error(gen, lq, lk, d):
    """3xTF32 keeps fp32-grade error: max abs err <= 1e-5 (plain TF32 would
    give ~1e-3)."""
    from hunyuan3d2_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain

    q, k, v = (torch.randn(1, 4, n, d, generator=gen, device="cuda") for n in (lq, lk, lk))
    out = flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert (out - flash_attention_plain(q, k, v)).abs().max().item() <= 1e-5


@pytest.mark.parametrize("dt,tol", [(torch.bfloat16, 2e-2), (torch.float32, 1e-4)])
def test_masked_flash_attention_skips_empty_tiles(gen, dt, tol):
    """A mask with whole empty 128 x 128 tiles (a block-diagonal voxel-like
    pattern) and fully masked rows: the output equals the twin and the
    fully masked rows are 0."""
    from hunyuan3d2_tpu_torch.ops.flash_attention import (
        flash_attention_masked,
        flash_attention_masked_plain,
        tile_map,
    )

    lq = lk = 1024
    blk = torch.arange(lq, device="cuda") // 256
    mask = (blk[:, None] == blk[None, :])[None].repeat(2, 1, 1)
    mask &= torch.rand(2, lq, lk, generator=gen, device="cuda") < 0.5
    mask[:, 5] = False
    mask[1, 700:830] = False          # a whole q tile's rows empty in part
    occ = tile_map(mask, 128, 128)
    assert 0 < occ.float().mean().item() < 0.5
    q, k, v = (torch.randn(2, 4, lq, 64, generator=gen, device="cuda").to(dt) for _ in range(3))
    out = flash_attention_masked(q, k, v, mask)
    torch.cuda.synchronize()
    assert (out[:, :, 5] == 0).all() and (out[1, :, 700:830] == 0).all()
    torch.testing.assert_close(out.float(), flash_attention_masked_plain(q, k, v, mask).float(),
                               atol=tol, rtol=tol)


def test_flash_kernels_refuse_what_they_do_not_take(gen):
    from hunyuan3d2_tpu_torch.ops.flash_attention import flash_attention
    from hunyuan3d2_tpu_torch.tools.profile_flash_variants import flash_attention_variant

    x96 = torch.zeros(1, 2, 64, 96, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        flash_attention(x96, x96, x96)
    q = torch.zeros(1, 2, 64, 64, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        flash_attention(q, q.float(), q)
    with pytest.raises(ValueError):
        flash_attention_variant(q, q, q, 0.125, 256, 128, 2)
    with pytest.raises(TypeError):
        flash_attention_variant(q.float(), q.float(), q.float(), 0.125, 128, 128, 2)
    misaligned = torch.zeros(2 * 64 * 64 + 4, device="cuda", dtype=torch.bfloat16)[4:]
    with pytest.raises(ValueError):
        flash_attention(misaligned.view(1, 2, 64, 64), q, q)


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


@pytest.mark.parametrize("dt,tol", [(torch.bfloat16, 2e-2), (torch.float32, 1e-4)])
@pytest.mark.parametrize("b,h,lq,lk,d", [(1, 10, 6144, 6144, 64), (2, 3, 130, 200, 64),
                                         (1, 4, 700, 333, 128), (2, 2, 512, 1040, 64)])
def test_masked_flash_attention_kernel_matches_plain(gen, b, h, lq, lk, d, dt, tol):
    from hunyuan3d2_tpu_torch.ops.flash_attention import (
        flash_attention_masked,
        flash_attention_masked_plain,
    )

    q = torch.randn(b, h, lq, d, generator=gen, device="cuda").to(dt)
    k = torch.randn(b, h, lk, d, generator=gen, device="cuda").to(dt)
    v = torch.randn(b, h, lk, d, generator=gen, device="cuda").to(dt)
    mask = torch.rand(b, lq, lk, generator=gen, device="cuda") < 0.3
    mask[:, 0] = False                  # fully masked → 0
    mask[:, 1, :64] = False             # the first key tile masked
    mask[:, 2] = False
    mask[:, 2, lk - 1] = True           # one key, in the ragged last tile
    before = flash_attention_masked.launches
    out = flash_attention_masked(q, k, v, mask)
    torch.cuda.synchronize()
    assert flash_attention_masked.launches == before + 1
    assert out.dtype == dt and out.shape == q.shape
    assert (out[:, :, 0] == 0).all()
    torch.testing.assert_close(out.float(), flash_attention_masked_plain(q, k, v, mask).float(),
                               atol=tol, rtol=tol)
    torch.testing.assert_close(out[:, :, 2].float(), v[:, :, lk - 1].float(), atol=tol, rtol=tol)


def _raster_case(gen, n_faces):
    """Random clip-space triangles of both windings, plus a degenerate face,
    exact depth ties (copies of earlier faces at higher ids) and one face
    bigger than the screen."""
    nv = 3 * n_faces
    v = torch.rand(nv, 4, generator=gen, device="cuda") * 1.8 - 0.9
    v[:, 3] = 1.0
    f = torch.randint(0, nv, (n_faces, 3), generator=gen, device="cuda", dtype=torch.int32)
    f[1::2] = f[1::2].flip(1)
    big = torch.tensor([[-3.0, -3.0, 0.9, 1.0], [3.0, -3.0, 0.9, 1.0], [0.0, 3.0, 0.9, 1.0]],
                       device="cuda")
    v = torch.cat([v, big])
    extra = torch.tensor([[0, 0, 1], [nv, nv + 1, nv + 2]], device="cuda", dtype=torch.int32)
    return v, torch.cat([f, f[:50], extra])


@pytest.mark.parametrize("n_faces,h,w", [(2000, 512, 512), (300, 97, 131), (40000, 2048, 2048)])
def test_rasterize_kernel_matches_plain(gen, n_faces, h, w):
    from hunyuan3d2_tpu_torch.ops.rasterize import (
        face_setup,
        rasterize,
        rasterize_plain,
        rasterize_records,
    )

    v, f = _raster_case(gen, n_faces)
    before = rasterize.launches
    out = rasterize(v, f, h, w)
    ref = rasterize_plain(*face_setup(v, f, h, w), h, w)
    passes = rasterize_records(*face_setup(v, f, h, w), h, w)
    torch.cuda.synchronize()
    assert rasterize.launches == before + 2
    torch.testing.assert_close(passes.face_id, out.face_id, atol=0, rtol=0)
    # the same records and the same rounding (no FMA contraction) in both
    torch.testing.assert_close(out.face_id, ref.face_id, atol=0, rtol=0)
    torch.testing.assert_close(out.bary, ref.bary, atol=0, rtol=0)
    torch.testing.assert_close(out.depth, ref.depth, atol=0, rtol=0)
    fid = out.face_id
    assert not ((fid >= n_faces) & (fid < n_faces + 50)).any()   # ties go to the lower id
    assert not (fid == n_faces + 50).any()                        # the degenerate face
    assert (fid == n_faces + 51).any()                            # the big face


def test_kernel_wrappers_raise_on_bad_input(gen):
    from hunyuan3d2_tpu_torch.ops.flash_attention import flash_attention

    q = torch.zeros(1, 2, 64, 64, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        flash_attention(q, q.cpu(), q.cpu())
    with pytest.raises(ValueError):
        flash_attention(q.transpose(2, 3), q.transpose(2, 3), q.transpose(2, 3))
    from hunyuan3d2_tpu_torch.ops.flash_attention import flash_attention_masked
    from hunyuan3d2_tpu_torch.ops.rasterize import rasterize

    with pytest.raises(ValueError):
        flash_attention_masked(q, q, q, torch.ones(1, 64, 32, dtype=torch.bool, device="cuda"))
    with pytest.raises(ValueError):
        rasterize(torch.zeros(3, 3, device="cuda"), torch.zeros(1, 3, dtype=torch.int32,
                                                                device="cuda"), 8, 8)


# kernel 4 keeps the fp32 residual as its twin does: only the order of fp32
# sums and erff against torch's erf differ, so a bf16 rounding of an LN or
# GELU output may flip by one ulp
@pytest.mark.parametrize("width,heads,p", [(128, 2, 1000), (1024, 16, 1037)])
def test_geo_mlp_tail_kernel_matches_plain(gen, width, heads, p):
    from hunyuan3d2_tpu_torch.models import shapevae as sv
    from hunyuan3d2_tpu_torch.ops.geo_decoder import geo_mlp_tail, geo_mlp_tail_plain

    cfg = sv.ShapeVAEConfig(num_latents=1280, width=width, heads=heads, num_decoder_layers=1)
    vae = sv.ShapeVAE.init_random(cfg, device="cuda", generator=gen)
    x2 = (torch.randn(1, p, width, generator=gen, device="cuda") * 2.0).to(torch.bfloat16)
    before = geo_mlp_tail.launches
    with torch.no_grad():
        out = geo_mlp_tail(vae, x2)
        ref = geo_mlp_tail_plain(vae, x2)
    torch.cuda.synchronize()
    assert geo_mlp_tail.launches == before + 1
    assert out.dtype == torch.float32 and out.shape == (1, p)
    out, ref = out.cpu().numpy(), ref.cpu().numpy()
    assert np.corrcoef(out.ravel(), ref.ravel())[0, 1] >= 0.9999
    assert np.abs(out - ref).max() <= 1e-2 * max(1.0, np.abs(ref).max())
    with pytest.raises(ValueError):    # a view that is not 16-byte aligned
        geo_mlp_tail(vae, x2.reshape(-1)[1:1 + 7 * width].reshape(1, 7, width))


def test_geo_stream_decode_matches_plain(gen):
    """The streamed decode (cuBLAS projections, flash attention over 2048
    latents, the MLP-tail kernel) against the plain decode."""
    from hunyuan3d2_tpu_torch.models import shapevae as sv
    from hunyuan3d2_tpu_torch.ops.flash_attention import flash_attention
    from hunyuan3d2_tpu_torch.ops.geo_decoder import (
        decode_queries_plain,
        fused_geo_decode_stream,
        geo_mlp_tail,
    )

    cfg = sv.ShapeVAEConfig(num_latents=2048, width=1024, heads=16, num_decoder_layers=1)
    vae = sv.ShapeVAE.init_random(cfg, device="cuda", generator=gen)
    before = (flash_attention.launches, geo_mlp_tail.launches)
    with torch.no_grad():
        lat = torch.randn(1, 2048, cfg.embed_dim, generator=gen, device="cuda")
        k, v = vae.compute_kv(vae.decode_latents(lat))
        k, v = k.to(torch.bfloat16).contiguous(), v.to(torch.bfloat16).contiguous()
        pts = (torch.rand(1, 3001, 3, generator=gen, device="cuda") * 2.02 - 1.01).contiguous()
        out = fused_geo_decode_stream(vae, pts, k, v)
        ref = decode_queries_plain(vae, pts, k, v).float()
    torch.cuda.synchronize()
    assert geo_mlp_tail.launches == before[1] + 1 and flash_attention.launches > before[0]
    out, ref = out.cpu().numpy(), ref.cpu().numpy()
    # the plain decode keeps the residual in bf16 where the stream keeps fp32
    assert np.corrcoef(out.ravel(), ref.ravel())[0, 1] > 0.9999
    assert np.abs(out - ref).max() < 0.05 * max(1.0, np.abs(ref).max())
