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


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("b,h,lq,lk,d", [(1, 16, 512, 512, 64), (1, 4, 1000, 333, 128),
                                         (1, 16, 3072, 3072, 64), (1, 8, 1024, 1024, 128)])
def test_flash_attention_fp32_error(gen, b, h, lq, lk, d, seed):
    """The fp32 kernel (3xTF32, each key tile summed apart) against an fp64
    evaluation of its function: every element within the bound that its
    arithmetic allows (tools/flash_fp32_error.py), a max abs error within 8x
    the plain twin's (fp32 GEMMs), which a few bad elements would exceed
    (measured 0.37-4.1x; a tensor-core sum carried across all key tiles gave
    9.5-14x at 3072 keys), and a relative RMS error within 4x the twin's
    (measured 0.5-2.2x; the carried sum gave 8x at 512 keys, 21x at 3072)."""
    from hunyuan3d2_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain
    from hunyuan3d2_tpu_torch.tools.flash_fp32_error import check_against_fp64, fp32_error_bound

    gen.manual_seed(seed)
    q, k, v = (torch.randn(b, h, n, d, generator=gen, device="cuda") for n in (lq, lk, lk))
    out = flash_attention(q, k, v)
    ref, bound = fp32_error_bound(q, k, v)
    torch.backends.cuda.matmul.allow_tf32 = False
    twin = flash_attention_plain(q, k, v)
    torch.cuda.synchronize()
    c = check_against_fp64(out, ref, bound)
    assert c["within"]
    assert c["max_abs_err"] <= 8 * (twin.double() - ref).abs().max().item()
    rms = (out.double() - ref).norm() / ref.norm()
    assert rms <= 4 * (twin.double() - ref).norm() / ref.norm()


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


def _geo_launches():
    from hunyuan3d2_tpu_torch.ops import geo_decoder as g

    return {n: getattr(g, n).launches for n in (
        "fused_geo_decode", "geo_mlp_tail", "ln_rows", "ln_dot_rows", "gemm_gelu",
        "gemm_residual", "gemm_head_ln")}


# kernel 3 against its plain twin, which keeps the fp32 residual as the
# kernels do: they differ in the order of fp32 sums, erff, and kernel 1's
# online softmax (p rounded to bf16 before it is normalised, where the twin
# rounds the normalised p), so a bf16 rounding of an LN, q, p or GELU value
# may flip by one ulp
@pytest.mark.parametrize("width,heads,latents,p", [(128, 2, 64, 300), (1024, 16, 512, 1000),
                                                   (256, 2, 512, 4097)])
def test_geo_decode_kernel_matches_plain(gen, width, heads, latents, p):
    from hunyuan3d2_tpu_torch.models import shapevae as sv
    from hunyuan3d2_tpu_torch.ops.flash_attention import flash_attention
    from hunyuan3d2_tpu_torch.ops.geo_decoder import fused_geo_decode, geo_decode_plain

    cfg = sv.ShapeVAEConfig(num_latents=latents, width=width, heads=heads, num_decoder_layers=2)
    vae = sv.ShapeVAE.init_random(cfg, device="cuda", generator=gen)
    with torch.no_grad():
        lat = torch.randn(1, latents, cfg.embed_dim, generator=gen, device="cuda")
        k, v = vae.compute_kv(vae.decode_latents(lat))
        k, v = k.to(torch.bfloat16).contiguous(), v.to(torch.bfloat16).contiguous()
        pts = (torch.rand(1, p, 3, generator=gen, device="cuda") * 2.02 - 1.01).contiguous()
        before, flash_before = _geo_launches(), flash_attention.launches
        out = fused_geo_decode(vae, pts, k, v)
        ref = geo_decode_plain(vae, pts, k, v)
    torch.cuda.synchronize()
    after = _geo_launches()
    assert {n: after[n] - before[n] for n in after} == dict(
        fused_geo_decode=1, geo_mlp_tail=0, ln_rows=2, ln_dot_rows=1, gemm_gelu=1,
        gemm_residual=3, gemm_head_ln=1)
    assert flash_attention.launches == flash_before + 1
    assert out.dtype == torch.float32 and out.shape == (1, p)
    out, ref = out.cpu().numpy(), ref.cpu().numpy()
    assert np.corrcoef(out.ravel(), ref.ravel())[0, 1] >= 0.9999
    assert np.abs(out - ref).max() <= 1e-2 * max(1.0, np.abs(ref).max())


def _bf16_close(out, ref):
    """bf16 outputs of the same fp32 value in another order of sums: equal
    or one bf16 ulp apart (at most 2^-7 of the value), plus the fp32 order
    error where a sum cancels to near 0 (1e-4, the fp32 outputs' bound)."""
    torch.testing.assert_close(out.float(), ref.float(), atol=1e-4, rtol=2.0 ** -7 + 1e-6)


# the GEMM template against its plain twins: both take exact products of the
# bf16 values and fp32 sums, in another order; fp32 outputs agree to 1e-4,
# bf16 outputs to one ulp
GEMM_EPILOGUES = ["gelu", "plain", "resid fp32", "resid fp32 -> bf16", "resid bf16"]


@pytest.mark.parametrize("n", [128, 1024, 4096])
@pytest.mark.parametrize("k", [64, 1024, 4096])
@pytest.mark.parametrize("rows", [1, 127, 4097])
@pytest.mark.parametrize("epi", GEMM_EPILOGUES)
def test_geo_gemm_kernel_matches_plain(gen, epi, rows, k, n):
    from hunyuan3d2_tpu_torch.ops import geo_decoder as g

    a = torch.randn(rows, k, generator=gen, device="cuda").to(torch.bfloat16)
    w = (torch.randn(n, k, generator=gen, device="cuda") * k ** -0.5).to(torch.bfloat16)
    bias = torch.randn(n, generator=gen, device="cuda") * 0.1
    if epi == "gelu":
        before = g.gemm_gelu.launches
        out, ref = g.gemm_gelu(a, w, bias), g.gemm_gelu_plain(a, w, bias)
        torch.cuda.synchronize()
        assert g.gemm_gelu.launches == before + 1
        _bf16_close(out, ref)
        return
    res_dtype, out_dtype = {"plain": (None, torch.float32),
                            "resid fp32": (torch.float32, torch.float32),
                            "resid fp32 -> bf16": (torch.float32, torch.bfloat16),
                            "resid bf16": (torch.bfloat16, torch.float32)}[epi]
    resid = (None if res_dtype is None else
             (torch.randn(rows, n, generator=gen, device="cuda") * 2.0).to(res_dtype))
    before = g.gemm_residual.launches
    out = g.gemm_residual(a, w, bias, resid, out_dtype)
    ref = g.gemm_residual_plain(a, w, bias, resid, out_dtype)
    torch.cuda.synchronize()
    assert g.gemm_residual.launches == before + 1
    assert out.dtype == out_dtype and out.shape == (rows, n)
    if out_dtype == torch.bfloat16:
        _bf16_close(out, ref)
    else:
        torch.testing.assert_close(out, ref, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("rows,k,n", [(1, 64, 128), (127, 1024, 1024), (4097, 1024, 4096),
                                      (4097, 64, 1024)])
@pytest.mark.parametrize("d", [64, 128])
def test_geo_gemm_head_ln_kernel_matches_plain(gen, d, rows, k, n):
    """E3: c_q with the per-head q LayerNorm, stored as [H, P, D]."""
    from hunyuan3d2_tpu_torch.ops import geo_decoder as g

    a = torch.randn(rows, k, generator=gen, device="cuda").to(torch.bfloat16)
    w = (torch.randn(n, k, generator=gen, device="cuda") * k ** -0.5).to(torch.bfloat16)
    bias = torch.randn(n, generator=gen, device="cuda") * 0.5
    s = torch.rand(d, generator=gen, device="cuda") + 0.5
    b = torch.randn(d, generator=gen, device="cuda") * 0.1
    before = g.gemm_head_ln.launches
    out = g.gemm_head_ln(a, w, bias, s, b, d, 1e-6)
    ref = g.gemm_head_ln_plain(a, w, bias, s, b, d, 1e-6)
    torch.cuda.synchronize()
    assert g.gemm_head_ln.launches == before + 1
    assert out.shape == (n // d, rows, d) and out.dtype == torch.bfloat16
    _bf16_close(out, ref)


@pytest.mark.parametrize("d", [64, 128])
def test_geo_gemm_reads_per_head_a(gen, d):
    """E2 with A read as kernel 1's [H, P, D] output (one head per 64-wide
    K tile), against the plain twin on the merged heads."""
    from hunyuan3d2_tpu_torch.ops import geo_decoder as g

    h, rows, n = 1024 // d, 1000, 1024
    a = torch.randn(h, rows, d, generator=gen, device="cuda").to(torch.bfloat16)
    w = (torch.randn(n, h * d, generator=gen, device="cuda") * 0.03).to(torch.bfloat16)
    bias = torch.randn(n, generator=gen, device="cuda") * 0.1
    resid = torch.randn(rows, n, generator=gen, device="cuda")
    out = g.gemm_residual(a, w, bias, resid)
    ref = g.gemm_residual_plain(a.transpose(0, 1).reshape(rows, -1), w, bias, resid)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("w", [128, 1024, 1280, 2048])
@pytest.mark.parametrize("rows", [1, 127, 4097])
@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32])
def test_geo_ln_rows_kernels_match_plain(gen, dt, rows, w):
    """LN rows (bf16 out) and ln_post + the output dot, cached in registers
    (W <= 1024) or read again (wider)."""
    from hunyuan3d2_tpu_torch.ops import geo_decoder as g

    x = (torch.randn(rows, w, generator=gen, device="cuda") * 3.0 + 1.0).to(dt)
    s = torch.rand(w, generator=gen, device="cuda") + 0.5
    b = torch.randn(w, generator=gen, device="cuda") * 0.1
    before = (g.ln_rows.launches, g.ln_dot_rows.launches)
    _bf16_close(g.ln_rows(x, s, b, 1e-6), g.ln_rows_plain(x, s, b, 1e-6))
    if dt == torch.float32:
        wout = (torch.randn(w, generator=gen, device="cuda") * w ** -0.5).to(torch.bfloat16)
        bout = torch.full((1,), 0.25, device="cuda")
        out = g.ln_dot_rows(x, s, b, wout, bout, 1e-6)
        ref = g.ln_dot_rows_plain(x, s, b, wout, bout, 1e-6)
        torch.cuda.synchronize()
        # an LN output one bf16 ulp apart moves the dot by ~2^-8 |y w|
        torch.testing.assert_close(out, ref, atol=2e-2, rtol=1e-3)
    torch.cuda.synchronize()
    assert g.ln_rows.launches == before[0] + 1
    assert g.ln_dot_rows.launches == before[1] + (dt == torch.float32)


def test_geo_kernels_refuse_what_they_do_not_take(gen):
    from hunyuan3d2_tpu_torch.ops import geo_decoder as g

    a = torch.zeros(10, 128, device="cuda", dtype=torch.bfloat16)
    w = torch.zeros(256, 128, device="cuda", dtype=torch.bfloat16)
    bias = torch.zeros(256, device="cuda")
    with pytest.raises(ValueError):       # K % 64
        g.gemm_gelu(a[:, :96].contiguous(), w[:, :96].contiguous(), bias)
    with pytest.raises(ValueError):       # B on the CPU
        g.gemm_gelu(a, w.cpu(), bias)
    with pytest.raises(ValueError):       # A not 16-byte aligned
        g.gemm_gelu(torch.zeros(10 * 128 + 4, device="cuda", dtype=torch.bfloat16)[4:]
                    .view(10, 128), w, bias)
    with pytest.raises(ValueError):       # a bf16 output over a bf16 residual
        g.gemm_residual(a, w, bias, torch.zeros(10, 256, device="cuda", dtype=torch.bfloat16),
                        torch.bfloat16)
    with pytest.raises(ValueError):       # W % 128
        g.ln_rows(torch.zeros(4, 96, device="cuda"), torch.ones(96, device="cuda"),
                  torch.zeros(96, device="cuda"), 1e-6)


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


def _raster_agrees(v, f, h, w):
    """The kernel (records, bbox and pixels) against face_setup and the plain
    twin on the same inputs: the same records and the same rounding (no FMA
    contraction) in both, so everything is equal; NaN where NaN."""
    from hunyuan3d2_tpu_torch.ops.rasterize import face_setup, rasterize_cuda, rasterize_plain

    out, recs, bbox = rasterize_cuda(v, f, h, w)
    ref_recs, ref_bbox = face_setup(v, f, h, w)
    ref = rasterize_plain(ref_recs, ref_bbox, h, w)
    torch.cuda.synchronize()
    torch.testing.assert_close(bbox, ref_bbox, atol=0, rtol=0)
    torch.testing.assert_close(recs, ref_recs, atol=0, rtol=0, equal_nan=True)
    finite = torch.isfinite(ref_recs)
    assert torch.equal(recs.view(torch.int32)[finite], ref_recs.view(torch.int32)[finite])
    torch.testing.assert_close(out.face_id, ref.face_id, atol=0, rtol=0)
    torch.testing.assert_close(out.bary, ref.bary, atol=0, rtol=0)
    torch.testing.assert_close(out.depth, ref.depth, atol=0, rtol=0)
    assert out.face_id.shape == (h, w) and out.bary.shape == (h, w, 3)
    assert int(out.overflow.abs().sum()) == 0
    return out


@pytest.mark.parametrize("n_faces,h,w", [(2000, 512, 512), (300, 97, 131), (40000, 2048, 2048)])
def test_rasterize_kernel_matches_plain(gen, n_faces, h, w):
    from hunyuan3d2_tpu_torch.ops.rasterize import rasterize

    v, f = _raster_case(gen, n_faces)
    before = rasterize.launches
    out = rasterize(v, f, h, w)
    again = _raster_agrees(v, f, h, w)
    assert rasterize.launches == before + 2
    torch.testing.assert_close(again.face_id, out.face_id, atol=0, rtol=0)
    fid = out.face_id
    assert not ((fid >= n_faces) & (fid < n_faces + 50)).any()   # ties go to the lower id
    assert not (fid == n_faces + 50).any()                        # the degenerate face
    assert (fid == n_faces + 51).any()                            # the big face


@pytest.mark.parametrize("h,w", [(96, 80), (512, 512), (33, 1000), (2048, 2048)])
@pytest.mark.parametrize("index_dtype", [torch.int32, torch.int64])
def test_rasterize_random_meshes_and_sizes(gen, h, w, index_dtype):
    """Random meshes of small, tile-sized and screen-sized faces (the last
    go to the wide list), non-square and non-tile-multiple sizes."""
    for scale, n in ((0.05, 4000), (0.3, 500), (3.0, 40)):
        c = torch.rand(n, 1, 2, generator=gen, device="cuda") * 2.4 - 1.2
        xy = c + (torch.rand(n, 3, 2, generator=gen, device="cuda") - 0.5) * scale
        v = torch.cat([xy, torch.rand(n, 3, 1, generator=gen, device="cuda") * 2 - 1,
                       torch.ones(n, 3, 1, device="cuda")], -1).reshape(-1, 4)
        f = torch.arange(3 * n, device="cuda", dtype=index_dtype).reshape(n, 3)
        out = _raster_agrees(v, f, h, w)
        assert (out.face_id >= 0).any()


def test_rasterize_duplicate_faces_lowest_id_wins(gen):
    """Each face drawn three times at the same depth (the copies in reverse
    winding): every covered pixel goes to the first copy."""
    n = 3000
    v = torch.rand(3 * n, 4, generator=gen, device="cuda") * 1.8 - 0.9
    v[:, 3] = 1.0
    v[:, 2] = 0.25
    f = torch.arange(3 * n, device="cuda", dtype=torch.int32).reshape(n, 3)
    f = torch.cat([f, f.flip(1), f])
    out = _raster_agrees(v, f, 300, 257)
    assert (out.face_id >= 0).any() and int(out.face_id.max()) < n


def test_rasterize_degenerate_nan_w0_offscreen_faces(gen):
    n = 2000
    v = torch.rand(3 * n, 4, generator=gen, device="cuda") * 2.2 - 1.1
    v[:, 3] = 1.0
    v[0::7, 3] = 0.0                        # w = 0 (taken as 1e-8)
    v[1::11, 0] = float("nan")              # NaN vertices
    v[2::13, 3] = -0.0
    v[3::17, 2] = float("inf")
    v[4::19] += 5.0                         # off screen
    f = torch.arange(3 * n, device="cuda", dtype=torch.int32).reshape(n, 3)
    f[5::23, 1] = f[5::23, 0]               # degenerate (zero area)
    out = _raster_agrees(v, f, 160, 200)
    assert (out.face_id >= 0).any()
    culled = torch.cat([torch.tensor([[0, 0, 0]], device="cuda", dtype=torch.int32), f[:3]])
    _raster_agrees(v, culled, 64, 64)


def test_rasterize_screen_sized_and_crowded_faces(gen):
    """Screen-sized faces over every tile, and thousands of faces inside one
    tile, which overflow its list into the wide list."""
    big = torch.rand(768, 4, generator=gen, device="cuda") * 2.0 - 1.0
    big[:, 3] = 1.0
    _raster_agrees(big, torch.arange(768, device="cuda", dtype=torch.int32).reshape(256, 3),
                   2048, 2048)
    n = 6000
    v = torch.rand(3 * n, 4, generator=gen, device="cuda") * 0.02 - 0.01
    v[:, 2] = torch.rand(3 * n, generator=gen, device="cuda")
    v[:, 3] = 1.0
    f = torch.arange(3 * n, device="cuda", dtype=torch.int32).reshape(n, 3)
    _raster_agrees(v, f, 2048, 2048)
    _raster_agrees(v, f[:0], 64, 48)        # no faces


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


# ---------------------------------------------------------------------------
# the served path: the CLIP tower's attention shape, loading onto the card
# ---------------------------------------------------------------------------
def test_flash_attention_clip_shape(gen):
    """ViT-L/14 at 224: 257 tokens, 16 heads of 64."""
    from hunyuan3d2_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain

    q, k, v = (torch.randn(1, 16, 257, 64, generator=gen, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    before = flash_attention.launches
    out = flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    torch.testing.assert_close(out.float(), flash_attention_plain(q, k, v).float(),
                               atol=2e-2, rtol=2e-2)


def test_clip_tower_on_the_card_matches_the_cpu(gen):
    from hunyuan3d2_tpu_torch.models import clip_vit
    from hunyuan3d2_tpu_torch.models.conditioner import CLIPImageEncoder
    from hunyuan3d2_tpu_torch.ops.flash_attention import flash_attention
    from hunyuan3d2_tpu_torch.ops.nn import build

    cfg = clip_vit.CLIPVisionConfig(hidden_size=128, num_layers=2, num_heads=2, patch_size=14,
                                    image_size=224, intermediate_size=256)
    cpu = build(CLIPImageEncoder, cfg, device="cpu")
    card = build(CLIPImageEncoder, cfg, device="cuda")
    card.load_state_dict(cpu.state_dict())
    img = np.random.RandomState(0).uniform(-1, 1, (2, 256, 256, 3)).astype(np.float32)
    before = flash_attention.launches
    out = card.encode(card.preprocess(img))
    torch.cuda.synchronize()
    assert flash_attention.launches == before + cfg.num_layers
    ref = cpu.encode(cpu.preprocess(img))
    assert out.shape == ref.shape == (2, 257, 128)
    err = (out.float().cpu() - ref.float()).abs().max().item()
    assert err <= 0.03 * ref.float().abs().max().item(), err


def test_from_pretrained_loads_straight_to_the_card(tmp_path):
    """Checkpoints written from CPU modules (fp16 shape stack, bf16/fp32 paint
    stack) load onto the card equal to the source cast to each parameter's
    dtype; the paint directory is the turbo model's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    import dataclasses
    import json
    import os

    import yaml
    from safetensors.torch import save_file

    from hunyuan3d2_tpu_torch import Hunyuan3DDiTFlowMatchingPipeline, Hunyuan3DPaintPipeline
    from hunyuan3d2_tpu_torch.models import paint_unet, sd_vae
    from hunyuan3d2_tpu_torch.ops.nn import build

    src = Hunyuan3DDiTFlowMatchingPipeline.init_random(size="tiny", dino="tiny", device="cpu")
    sd = {f"{top}.{k}": v.half() for top, m in (("model", src.model), ("vae", src.vae),
                                                  ("conditioner", src.conditioner))
          for k, v in m.state_dict().items()}
    os.makedirs(tmp_path / "tiny")
    save_file(sd, str(tmp_path / "tiny" / "model.fp16.safetensors"))
    c, vc, d = src.model_cfg, src.vae.cfg, src.conditioner.main.cfg.dino
    config = {"model": {"params": {k: getattr(c, k) for k in (
        "in_channels", "context_in_dim", "hidden_size", "num_heads", "depth",
        "depth_single_blocks")}},
        "vae": {"params": {k: getattr(vc, k) for k in (
            "num_latents", "embed_dim", "width", "heads", "num_decoder_layers")}},
        "conditioner": {"params": {"main_image_encoder": {"kwargs": {
            "config": {"hidden_size": d.hidden_size, "num_hidden_layers": d.num_layers,
                       "num_attention_heads": d.num_heads}, "image_size": d.image_size}}}}}
    (tmp_path / "tiny" / "config.yaml").write_text(yaml.safe_dump(config))
    pipe = Hunyuan3DDiTFlowMatchingPipeline.from_pretrained(str(tmp_path), subfolder="tiny",
                                                            device="cuda")
    for top, m in (("model", pipe.model), ("vae", pipe.vae), ("conditioner", pipe.conditioner)):
        for k, t in m.state_dict().items():
            assert t.is_cuda and torch.equal(t.cpu(), sd[f"{top}.{k}"].to(t.dtype)), k

    ucfg = dataclasses.replace(paint_unet.TINY, block_out_channels=(64, 128),
                               attention_head_dim=64)
    weights = {"unet": build(paint_unet.UNet2p5D, ucfg, device="cpu").state_dict(),
               "vae": build(sd_vae.AutoencoderKL, sd_vae.TINY, device="cpu").state_dict()}
    configs = {"unet": {"block_out_channels": [64, 128], "layers_per_block": 1,
                        "cross_attention_dim": 32, "norm_num_groups": 8},
               "vae": {"block_out_channels": [32, 32], "layers_per_block": 1}}
    root = tmp_path / "hunyuan3d-paint-v2-0-turbo"
    for part, w in weights.items():
        os.makedirs(root / part)
        (root / part / "config.json").write_text(json.dumps(configs[part]))
        save_file({k: v.contiguous() for k, v in w.items()},
                  str(root / part / "diffusion_pytorch_model.safetensors"))
    loaded = Hunyuan3DPaintPipeline.from_pretrained(str(tmp_path), device="cuda")
    got = loaded.models["multiview_model"].pipeline
    assert got.is_turbo
    for part, module in (("unet", got.unet), ("vae", got.vae)):
        for k, t in module.state_dict().items():
            assert t.is_cuda and torch.equal(t.cpu(), weights[part][k]), k


def test_standard_paint_loop_on_the_card_matches_the_cpu(gen):
    """The EulerAncestral + CFG loop (3 steps) on the card against the same
    weights and draws on the CPU: 64² views through the tiny VAE give 32²
    latents, so the head-64 UNet's attention at that level (6144 multiview
    tokens at CFG batch 2, 1024 self and reference tokens) passes kernel 1's
    gate; the standard loop builds no voxel mask, so the masked kernel does
    not run."""
    import dataclasses

    from PIL import Image

    from hunyuan3d2_tpu_torch.models import paint_unet
    from hunyuan3d2_tpu_torch.ops.flash_attention import flash_attention, flash_attention_masked
    from hunyuan3d2_tpu_torch.ops.nn import build
    from hunyuan3d2_tpu_torch.pipelines.hunyuanpaint import HunyuanPaintPipeline

    view, steps = 64, 3
    ucfg = dataclasses.replace(paint_unet.TINY, block_out_channels=(64, 128),
                               attention_head_dim=64)
    cpu = HunyuanPaintPipeline.init_random("tiny", view, device="cpu", seed=1)
    cpu.unet = build(paint_unet.UNet2p5D, ucfg, device="cpu",
                     generator=torch.Generator().manual_seed(2))
    card = HunyuanPaintPipeline.init_random("tiny", view, device="cuda", seed=1)
    card.unet = build(paint_unet.UNet2p5D, ucfg, device="cuda")
    card.unet.load_state_dict(cpu.unet.state_dict())
    card.vae.load_state_dict(cpu.vae.state_dict())
    rs = np.random.RandomState(0)
    lat = (1, 6, view // 2, view // 2, 4)
    init = rs.randn(*lat).astype(np.float32)
    noises = [rs.randn(*lat).astype(np.float32) for _ in range(steps)]
    normal, position = (torch.from_numpy(rs.randint(0, 256, (6, view, view, 3)).astype(np.uint8))
                        for _ in range(2))
    img = np.zeros((96, 96, 4), np.uint8)
    img[16:80, 24:72] = [200, 40, 40, 255]
    outs = {}
    for name, pipe in (("cpu", cpu), ("cuda", card)):
        before = flash_attention.launches, flash_attention_masked.launches
        outs[name] = pipe(Image.fromarray(img), normal_imgs=normal.to(pipe.device),
                          position_imgs=position.to(pipe.device),
                          camera_info_gen=[[12, 15, 18, 21, 40, 36]],
                          num_inference_steps=steps, output_type="device", init_latents=init,
                          step_noises=noises).images.cpu().numpy().astype(np.float64)
    assert flash_attention.launches > before[0]
    assert flash_attention_masked.launches == before[1]
    a, b = outs["cuda"], outs["cpu"]
    assert a.shape == b.shape == (6, view, view, 3)
    corr = np.corrcoef(a.ravel(), b.ravel())[0, 1]
    assert corr >= 0.99 and np.abs(a - b).mean() <= 3.0, (corr, np.abs(a - b).mean())


def test_t2i_pipeline_on_the_card_matches_the_cpu(gen):
    """The TINY HunyuanDiT pipeline (4 DDPM steps, CFG + PAG, 64²) on the
    card against the same weights, pseudo text embeddings and draws on the
    CPU. No kernel is on this path (head size 32 and 256 tokens are under
    the flash gate): it holds the port's plain code on the card."""
    from hunyuan3d2_tpu_torch.pipelines.t2i import HunyuanDiTTorchPipeline

    steps = 4
    cpu = HunyuanDiTTorchPipeline.init_random(device="cpu", num_inference_steps=steps, seed=3)
    card = HunyuanDiTTorchPipeline.init_random(device="cuda", num_inference_steps=steps, seed=4)
    card.transformer.load_state_dict(cpu.transformer.state_dict())
    card.vae.load_state_dict(cpu.vae.state_dict())
    rs = np.random.RandomState(0)
    init = rs.randn(1, 32, 32, 4).astype(np.float32)
    noises = [rs.randn(1, 32, 32, 4).astype(np.float32) for _ in range(steps)]
    a, b = (np.asarray(p("a teapot", seed=0, init_latents=init, step_noises=noises), np.float64)
            for p in (card, cpu))
    corr = np.corrcoef(a.ravel(), b.ravel())[0, 1]
    assert a.std() > 1.0 and corr >= 0.99 and np.abs(a - b).mean() <= 3.0, (corr,)



def test_delight_pipeline_on_the_card_matches_the_cpu(gen):
    """The TINY delight pipeline (3 steps, triple CFG, 32²) with the same
    weights and draws; head sizes 16 and 32 take the plain attention."""
    from hunyuan3d2_tpu_torch.tools import card_agreement as ca

    a, b = ca.delight_images()
    assert ca.agrees(a, b), ca.image_agreement(a, b)


def test_upscale_pipeline_on_the_card_matches_the_cpu(gen):
    """A head-64 TINY upscaler (channels (64, 128), 2 heads) on a 64² image:
    the self and cross attention of its 32² level and mid block (1024
    queries) go through kernel 1 on the card."""
    from hunyuan3d2_tpu_torch.tools import card_agreement as ca

    a, b, launches = ca.upscale_images()
    assert launches == ca.UPSCALE_FLASH_LAUNCHES
    assert a.size == (256, 256)
    assert ca.agrees(a, b), ca.image_agreement(a, b)


def test_align_pipeline_on_the_card_matches_the_cpu(gen):
    """The TINY ControlNet + IP-Adapter pipeline (non-zero adapter and zero
    convs, seeded image tokens) on the card, text-to-image and img2img."""
    from hunyuan3d2_tpu_torch.tools import card_agreement as ca

    for strength, a, b in ca.align_images():
        assert ca.agrees(a, b), (strength, ca.image_agreement(a, b))


def test_conv2d_adds_an_fp32_bias_before_its_one_rounding(gen):
    """bf16 activations under an fp32 weight and bias (the ControlNet's zero
    convs): a 1×1 conv over one channel is x·w + b, exact in fp32 up to the
    sum's rounding, so the card gives the CPU's bits only if it adds the
    bias in fp32 before rounding to bf16."""
    from hunyuan3d2_tpu_torch.ops.conv import conv2d

    x = torch.randn(2, 8, 8, 1, generator=gen, device="cuda").to(torch.bfloat16)
    w = torch.randn(16, 1, 1, 1, generator=gen, device="cuda") * 2 ** -6
    b = 0.5 + torch.arange(16, device="cuda", dtype=torch.float32) * 2 ** -12
    out = conv2d(x, w, b)
    ref = conv2d(x.cpu(), w.cpu(), b.cpu())
    assert out.dtype == torch.bfloat16
    assert torch.equal(out.cpu(), ref)
    rounded_first = conv2d(x.cpu(), w.cpu(), b.cpu().to(torch.bfloat16))
    assert not torch.equal(ref, rounded_first)


# ---------------------------------------------------------------------------
# gradients: kernel 1's, the refusals of the kernels without one, training
# and the differentiable surface
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("lq,lk", [(130, 200), (512, 512), (700, 333)])
def test_flash_attention_gradient_matches_plain(gen, lq, lk, dt):
    """The backward is the plain twin's gradient recomputed from the saved
    inputs: it equals the plain autograd's up to the GEMMs' reduction order;
    the forward is the kernel's (one launch)."""
    from hunyuan3d2_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain

    q, k, v = (torch.randn(2, 3, n, 64, generator=gen, device="cuda").to(dt)
               for n in (lq, lk, lk))
    dout = torch.randn(2, 3, lq, 64, generator=gen, device="cuda").to(dt)
    q, k, v = (t.requires_grad_(True) for t in (q, k, v))
    before = flash_attention.launches
    out = flash_attention(q, k, v)
    grads = torch.autograd.grad(out, (q, k, v), dout)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    ref_in = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    refs = torch.autograd.grad(flash_attention_plain(*ref_in), ref_in, dout)
    for g, r in zip(grads, refs):
        assert g.dtype == dt
        tol = 2e-2 if dt == torch.bfloat16 else 1e-5
        torch.testing.assert_close(g.float(), r.float(), atol=tol * float(r.abs().max()),
                                   rtol=0)


def test_kernels_without_a_gradient_refuse_on_the_card(gen):
    from hunyuan3d2_tpu_torch.models import shapevae
    from hunyuan3d2_tpu_torch.ops import geo_decoder, rasterize
    from hunyuan3d2_tpu_torch.ops.flash_attention import flash_attention_masked

    q, k, v = (torch.randn(1, 2, 256, 64, generator=gen, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    mask = torch.ones(1, 256, 256, dtype=torch.bool, device="cuda")
    with pytest.raises(RuntimeError, match="flash_attention_masked has no gradient"):
        flash_attention_masked(q.requires_grad_(True), k, v, mask)
    for latents, fn in ((512, geo_decoder.fused_geo_decode),
                        (1280, geo_decoder.fused_geo_decode_stream)):
        vae = shapevae.ShapeVAE.init_random(shapevae.ShapeVAEConfig(
            num_latents=latents, width=128, heads=2, num_decoder_layers=1), device="cuda")
        vae.geo_decoder.requires_grad_(True)
        kk, vv = (torch.randn(1, 2, latents, 64, generator=gen, device="cuda")
                  .to(torch.bfloat16) for _ in range(2))
        pts = torch.rand(1, 512, 3, generator=gen, device="cuda") * 2 - 1
        with pytest.raises(RuntimeError, match="has no gradient"):
            fn(vae, pts, kk, vv)
        with pytest.raises(RuntimeError, match="geo_mlp_tail has no gradient"):
            geo_decoder.geo_mlp_tail(vae, torch.zeros(1, 512, 128, dtype=torch.bfloat16,
                                                      device="cuda"))
    verts = torch.tensor([[-0.5, -0.5, 0.1, 1.0], [0.5, -0.5, 0.1, 1.0], [0.0, 0.5, 0.1, 1.0]],
                         device="cuda", requires_grad=True)
    faces = torch.tensor([[0, 1, 2]], dtype=torch.int32, device="cuda")
    with pytest.raises(RuntimeError, match="rasterize has no gradient"):
        rasterize.rasterize(verts, faces, 8, 8)
    with torch.no_grad():
        assert (rasterize.rasterize(verts, faces, 8, 8).face_id == 0).any()


def test_device_memory_stats_on_the_card(gen):
    from hunyuan3d2_tpu_torch.utils.profiling import device_memory_stats

    x = torch.empty(1 << 20, device="cuda")
    s = device_memory_stats()
    assert set(s) == {"bytes_in_use", "peak_bytes_in_use", "bytes_limit"}
    assert s["peak_bytes_in_use"] >= s["bytes_in_use"] >= x.numel() * 4
    assert s["bytes_limit"] > 10 * 2 ** 30
    assert set(device_memory_stats("cuda:0")) == set(s)


def test_train_step_on_the_card_agrees_with_the_cpu(gen):
    from hunyuan3d2_tpu_torch.tools import card_agreement as ca

    stats = ca.train_agreement(ca.train_step_pair())
    assert ca.train_agrees(stats), stats


def test_diff_surface_on_the_card_agrees_with_the_cpu(gen):
    from hunyuan3d2_tpu_torch.tools import card_agreement as ca

    stats = ca.diff_surface_agreement(ca.diff_surface_pair())
    assert ca.diff_surface_agrees(stats), stats
