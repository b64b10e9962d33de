"""Kernel 6 (the flash tile sweep) and the masked kernel's tile map, on the CPU.

The JAX side is the Pallas sweep kernel of scripts/profile_flash_variants.py
(``flash_v``), loaded by path and run in interpret mode as
tests/test_flash_attention.py runs ``_flash``. The port's
``flash_attention_variant`` takes its plain twin for CPU tensors. Inputs are
made by numpy from a seed and handed to both frameworks.
"""

import importlib.util
import os
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hunyuan3d2_tpu_torch.ops.flash_attention import (
    default_config,
    flash_attention_masked_plain,
    tile_map,
)
from hunyuan3d2_tpu_torch.tools.profile_flash_variants import VARIANTS, flash_attention_variant

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_flash_v(q, k, v, scale, bq, bk):
    """scripts/profile_flash_variants.py ``flash_v`` (fold_scale, no
    dimension_semantics) in interpret mode."""
    from jax.experimental import pallas as pl

    spec = importlib.util.spec_from_file_location(
        "profile_flash_variants_jax", os.path.join(ROOT, "scripts", "profile_flash_variants.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    with mock.patch.object(pl, "pallas_call", patched):
        return mod.flash_v.__wrapped__(q, k, v, scale, bq, bk, dimsem=False, fold_scale=True)


# fp32: the summation order only; bf16: p and the output are rounded to
# bf16 after other running maxima (online blocks against one softmax)
@pytest.mark.parametrize("dt,atol", [("fp32", 1e-5), ("bf16", 2e-2)])
@pytest.mark.parametrize("n,l,d", [(2, 256, 64), (1, 384, 128)])
def test_variant_matches_pallas_sweep_kernel(n, l, d, dt, atol):
    rs = np.random.RandomState(n * l + d)
    q, k, v = (rs.randn(n, l, d).astype(np.float32) for _ in range(3))
    jdt, tdt = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[dt]
    scale = d ** -0.5
    ref = _jax_flash_v(*(jnp.asarray(x, jdt) for x in (q, k, v)), scale, 128, 128)
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    tq, tk, tv = (torch.from_numpy(x).to(tdt)[None] for x in (q, k, v))
    out = flash_attention_variant(tq, tk, tv, scale, 128, 128, 3)[0].float().numpy()
    assert out.shape == ref.shape == (n, l, d)
    np.testing.assert_allclose(out, ref, atol=atol, rtol=atol)


@pytest.mark.parametrize("cfg", [(256, 128, 2), (128, 128, 4), (128, 32, 2), (64, 64, 2)])
def test_uncompiled_variant_raises(cfg):
    x = torch.zeros(1, 2, 64, 64)
    with pytest.raises(ValueError, match="not compiled"):
        flash_attention_variant(x, x, x, 0.125, *cfg)


def test_default_configs_are_compiled_variants():
    """The product kernel's bf16 defaults are configurations the sweep times."""
    for shape in [(1, 5, 24576, 24576), (1, 24, 1370, 1370), (2, 16, 1882, 1882),
                  (1, 2, 300, 77), (1, 16, 199680, 3072)]:
        for d in (64, 128):
            assert default_config(*shape, d, torch.bfloat16) in VARIANTS
    assert default_config(1, 2, 300, 77, 64, torch.bfloat16)[0] == 64   # 6 CTAs of 128 rows


# (B, H, Lq, Lk, D, masked) → the fp32 kernels' (q rows, keys, slots), as
# csrc/flash_attention.cu compiles them (FLASH_F32, FLASH_F32_MASKED): the
# unmasked kernel's 64-row q tiles where 128-row ones would leave SMs idle;
# the masked kernel's one configuration a head size
FP32_CONFIGS = {
    "vae": ((1, 16, 512, 512, 64, False), (64, 64, 6)),
    "vae full": ((1, 16, 3072, 3072, 64, False), (128, 64, 4)),
    "decode chunk": ((1, 16, 65536, 512, 64, False), (128, 64, 4)),
    "d128": ((1, 8, 1024, 1024, 128, False), (64, 64, 2)),
    "d128 many q tiles": ((2, 8, 4096, 4096, 128, False), (64, 64, 2)),
    "masked": ((1, 10, 6144, 6144, 64, True), (128, 64, 4)),
    "masked d128": ((1, 2, 300, 77, 128, True), (64, 64, 2)),
    "masked few q tiles": ((2, 3, 130, 200, 64, True), (128, 64, 4)),
    "masked grid 16": ((1, 20, 1536, 1536, 64, True), (128, 64, 4)),
}


@pytest.mark.parametrize("name", sorted(FP32_CONFIGS))
def test_fp32_default_configs(name):
    (b, h, lq, lk, d, masked), want = FP32_CONFIGS[name]
    assert default_config(b, h, lq, lk, d, torch.float32, masked) == want


def _tile_map_loop(mask, bq, bk):
    b, lq, lk = mask.shape
    nq, nk = -(-lq // bq), -(-lk // bk)
    out = np.zeros((b, nq, nk), np.uint8)
    for i in range(b):
        for qi in range(nq):
            for ki in range(nk):
                out[i, qi, ki] = mask[i, qi * bq:(qi + 1) * bq, ki * bk:(ki + 1) * bk].any()
    return out


@pytest.mark.parametrize("lq,lk,bq,bk", [(300, 333, 128, 128), (130, 200, 64, 64),
                                         (256, 256, 128, 128), (77, 1000, 64, 128)])
def test_tile_map_matches_brute_force(lq, lk, bq, bk):
    rs = np.random.RandomState(lq + lk)
    m = rs.rand(3, lq, lk) < 0.002
    m[1] = False                                # all-False
    m[2] = False
    m[2, lq - 1, lk - 1] = True                 # one pair, in the ragged last tile
    out = tile_map(torch.from_numpy(m), bq, bk)
    assert out.dtype == torch.uint8
    np.testing.assert_array_equal(out.numpy(), _tile_map_loop(m, bq, bk))
    assert out[1].sum() == 0 and out[2].sum() == 1 and out[2, -1, -1] == 1


def _blocked_masked_attention(q, k, v, mask, bq, bk):
    """The masked kernel's loop in plain fp32: per q tile, an online softmax
    over only the key tiles the occupancy map marks; -1e30 and p = 0 where
    the mask forbids; acc / max(l, 1e-30)."""
    b, h, lq, d = q.shape
    lk = k.shape[2]
    occ = tile_map(mask, bq, bk)
    qs = q * d ** -0.5
    out = torch.zeros_like(q)
    for qi in range(occ.shape[1]):
        rows = slice(qi * bq, min((qi + 1) * bq, lq))
        for bi in range(b):
            n = rows.stop - rows.start
            m_run = torch.full((h, n, 1), -1e30)
            l_run = torch.zeros(h, n, 1)
            acc = torch.zeros(h, n, d)
            for ki in torch.nonzero(occ[bi, qi]).flatten().tolist():
                cols = slice(ki * bk, min((ki + 1) * bk, lk))
                allowed = mask[bi, rows, cols][None]
                s = torch.where(allowed, qs[bi, :, rows] @ k[bi, :, cols].transpose(1, 2), -1e30)
                m_new = torch.maximum(m_run, s.amax(-1, keepdim=True))
                p = torch.where(allowed, torch.exp(s - m_new), 0.0)
                alpha = torch.exp(m_run - m_new)
                l_run = l_run * alpha + p.sum(-1, keepdim=True)
                acc = acc * alpha + p @ v[bi, :, cols]
                m_run = m_new
            out[bi, :, rows] = acc / l_run.clamp_min(1e-30)
    return out


def test_skipping_empty_tiles_is_exact():
    """Visiting only the occupied tiles gives the masked plain twin's
    output (the argument the kernel's tile skipping rests on); a fully
    masked row gives 0."""
    rs = np.random.RandomState(7)
    b, h, lq, lk, d = 2, 2, 300, 333, 64
    blk = np.arange(max(lq, lk)) // 96
    m = (blk[:lq, None] == blk[None, :lk]) & (rs.rand(b, lq, lk) < 0.4)
    m[:, 10] = False
    mask = torch.from_numpy(m)
    occ = tile_map(mask, 64, 64)
    assert 0.2 < occ.float().mean().item() < 0.8     # some tiles are skipped
    q, k, v = (torch.from_numpy(rs.randn(b, h, n, d).astype(np.float32)) for n in (lq, lk, lk))
    out = _blocked_masked_attention(q, k, v, mask, 64, 64)
    ref = flash_attention_masked_plain(q, k, v, mask)
    assert (out[:, :, 10] == 0).all() and (ref[:, :, 10] == 0).all()
    torch.testing.assert_close(out, ref, atol=1e-6, rtol=1e-6)
