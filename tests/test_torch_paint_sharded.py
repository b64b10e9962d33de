"""The paint stack sharded over a (dp, tp) mesh in the port
(hunyuan3d2_tpu_torch/parallel; HunyuanPaintPipeline.shard and
Hunyuan3DPaintPipeline.shard) against the JAX package's single-device paint
UNet, on the CPU.

The port's side runs once on 8 gloo ranks (dp = 2 × tp = 4) spawned by a
module-scoped fixture (tests/torch_parallel_cases.py, which imports no JAX).
The UNet is tests/test_paint_sharded.py's TINY with 16-channel heads, so
that its 32-channel level has 2 heads, which tp = 4 does not divide (that
level's attentions keep their projections sharded and run whole), and its
64-channel level 4 heads, one a rank. Weights are drawn by numpy into the
JAX init's tree (tests/torch_sd_ref.py ``random_params``: compiling the JAX
init takes ~10 s here) and carried across by io/convert.py; inputs come
from np.random.RandomState(0), as in tests/test_paint_sharded.py, whose
tolerance (3e-2) holds the UNet.
The standard sampler of the tiny paint pipeline, whose CFG batch of 2 is
split over dp, is held to its unsharded run as the card-vs-CPU paint checks
hold views: correlation above 0.999 and a mean difference within 2 levels of
255 (measured 0.99944 and 1.04 levels, the largest 9, for views whose
standard deviation is 44 levels: the same sums in another order flip bf16
roundings, which two steps through two UNets and the VAE's decoder grow).
A branch given the other's reference cache does not correlate so (a cache
written from the whole CFG batch gave 0.988).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from hunyuan3d2_tpu.models import paint_unet as jpu
from hunyuan3d2_tpu_torch.io import convert
from tests import torch_parallel_cases as cases
from tests.torch_sd_ref import random_params

CFG = dataclasses.replace(jpu.TINY, attention_head_dim=16)


def _inputs():
    rs = np.random.RandomState(0)
    b, n, h = 2, 2, 16
    sample, normal, position = (rs.randn(b, n, h, h, 4).astype(np.float32) for _ in range(3))
    ref = rs.randn(b, 1, h, h, 4).astype(np.float32)
    return sample, normal, position, ref, np.zeros((b, n), np.int64), np.zeros((b, 1), np.int64)


@pytest.fixture(scope="module")
def params():
    return random_params(jpu.init, CFG)


@pytest.fixture(scope="module")
def ranks(params, tmp_path_factory):
    return cases.spawn_once(tmp_path_factory, "paint_cases", cases.paint_cases, 8,
                            lambda: (convert.paint_unet_state_dict(params),
                                     dataclasses.asdict(CFG), _inputs()))


def test_sharded_paint_unet_matches_jax(ranks, params):
    sample, normal, position, ref, cam_gen, cam_ref = (jnp.asarray(a) for a in _inputs())
    out_ref = jax.jit(lambda p, s, nm, po, r, cg, cr: jpu.apply(
        p, CFG, s, jnp.float32(200.0), nm, po, r, cg, cr)[0])(
        params, sample, normal, position, ref, cam_gen.astype(jnp.int32),
        cam_ref.astype(jnp.int32))
    out_ref = np.asarray(out_ref, np.float32)
    for r in ranks:
        assert r["unet"].shape == out_ref.shape
        np.testing.assert_allclose(r["unet"], out_ref, atol=3e-2, rtol=3e-2)


@pytest.mark.parametrize("level,channels,modes", [
    # 2 heads at tp = 4: projections sharded, outputs gathered, attention whole
    ("down_blocks.0", 32, {"to_q": "gather", "to_k": "gather", "to_v": "gather",
                           "to_out.0": "slice"}),
    # 4 heads: one a rank, a column/row pair
    ("mid_block", 64, {"to_q": "col", "to_k": "col", "to_v": "col", "to_out.0": "row"})])
def test_attention_layouts(ranks, level, channels, modes):
    assert channels in CFG.block_out_channels
    got = ranks[0]["modes"]
    for attn in ("transformer.attn1", "transformer.attn2", "attn_refview", "attn_multiview"):
        prefix = f"unet.{level}.attentions.0.transformer_blocks.0.{attn}."
        assert {k: got[prefix + k] for k in modes} == modes, attn
    blk = f"unet.{level}.attentions.0."
    assert got[blk + "proj_in"] == "gather" and got[blk + "proj_out"] == "slice"
    assert got[blk + "transformer_blocks.0.transformer.ff.net.0.proj"] == "col"


def test_sharded_paint_pipeline_matches_unsharded(ranks):
    whole, sharded = ranks[0]["paint"]
    assert sharded.shape == whole.shape == (2, 32, 32, 3)
    assert np.corrcoef(sharded.ravel(), whole.ravel())[0, 1] > 0.999
    assert np.abs(sharded - whole).mean() * 255 < 2.0
    assert ranks[0]["texgen_mesh"] == (2, 4)
