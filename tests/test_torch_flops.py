"""The port's analytic FLOP counts (models/paint_unet.py ``flops`` /
``apply_flops``, models/sd_vae.py ``flops``, utils/flops.py) against the
JAX package's functions and against ``torch.utils.flop_counter``'s count of
the port's own modules, on the CPU.

The full-width models are built on the ``meta`` device and fed
``torch.empty`` inputs: the counter sees every matmul and convolution of
the pass without computing one (the DEFAULT paint UNet's two passes take a
few seconds). On the CPU attention takes the plain ``sdpa`` (two einsums),
so the counter sees its products too; on the card the hand-written kernels
are ctypes launches that it cannot see. The small models run on real bf16
tensors.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from hunyuan3d2_tpu.models import dit as jdit
from hunyuan3d2_tpu.models import paint_unet as jpu
from hunyuan3d2_tpu.models import sd_vae as jvae
from hunyuan3d2_tpu_torch.models import dinov2 as tdino
from hunyuan3d2_tpu_torch.models import dit as tdit
from hunyuan3d2_tpu_torch.models import paint_unet as tpu
from hunyuan3d2_tpu_torch.models import sd_vae as tvae
from hunyuan3d2_tpu_torch.models import shapevae as tsv
from hunyuan3d2_tpu_torch.ops.nn import build
from hunyuan3d2_tpu_torch.pipelines import delight, upscale
from hunyuan3d2_tpu_torch.utils import flops
from hunyuan3d2_tpu_torch.volume import decoders


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread a test: the suite runs several workers on the
    host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def counted(fn) -> int:
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


def _bf16(rs, *shape):
    return torch.from_numpy(rs.standard_normal(shape).astype(np.float32)).to(torch.bfloat16)


# ---------------------------------------------------------------------------
# (a) the paint models' counts equal the JAX package's
# ---------------------------------------------------------------------------
UNET_CONFIGS = {
    "tiny": tpu.TINY,
    "default": tpu.DEFAULT,
    "dual_default": tpu.dual_config(tpu.DEFAULT),
    "sd15_num_heads_8": delight.IP2P_UNET,
    "x4_down_cross": upscale.X4_UNET,
}


@pytest.mark.parametrize("name", sorted(UNET_CONFIGS))
@pytest.mark.parametrize("hw,views,ref,batch", [(64, 6, 1, 1), (32, 4, 2, 2)])
def test_paint_unet_flops_equal_jax(name, hw, views, ref, batch):
    fields = dataclasses.asdict(UNET_CONFIGS[name])
    tcfg, jcfg = tpu.PaintUNetConfig(**fields), jpu.PaintUNetConfig(**fields)
    for mode in ("r", "w"):
        assert (tpu.flops(tcfg, hw, hw, views, ref, batch, mode)
                == jpu.flops(jcfg, hw, hw, views, ref, batch, mode))
    assert (tpu.apply_flops(tcfg, hw, hw, views, ref, batch)
            == jpu.apply_flops(jcfg, hw, hw, views, ref, batch))


@pytest.mark.parametrize("name", ["tiny", "default"])
@pytest.mark.parametrize("direction,hw", [("encode", 512), ("encode", 64), ("decode", 64),
                                          ("decode", 16)])
def test_sd_vae_flops_equal_jax(name, direction, hw):
    fields = dataclasses.asdict({"tiny": tvae.TINY, "default": tvae.DEFAULT}[name])
    tcfg, jcfg = tvae.SDVAEConfig(**fields), jvae.SDVAEConfig(**fields)
    for batch in (1, 6):
        assert (tvae.flops(tcfg, hw, hw, batch, direction)
                == jvae.flops(jcfg, hw, hw, batch, direction))


# ---------------------------------------------------------------------------
# (b) the paint models' counts equal the counter's on the port's modules
# ---------------------------------------------------------------------------
def _unet_counts(unet, n_gen, hw, make):
    """(the counted 'w' pass, the counted 'r' pass) of write_cache and
    forward on [1, n_gen (or 1), hw, hw, 4] inputs from ``make``."""
    ref = make(1, 1, hw, hw, 4)
    cache = {}

    def write():
        cache.update(unet.write_cache(ref))

    w = counted(write)
    sample, normal, position = (make(1, n_gen, hw, hw, 4) for _ in range(3))
    cam = torch.zeros(1, n_gen, dtype=torch.long)
    r = counted(lambda: unet(sample, 500.0, normal, position, cam, cache))
    return w, r


def test_paint_unet_flops_equal_counter_tiny():
    """TINY on real bf16 tensors: 3 views and the reference at 16²."""
    rs = np.random.RandomState(0)
    unet = build(tpu.UNet2p5D, tpu.TINY, device="cpu")
    w, r = _unet_counts(unet, 3, 16, lambda *s: _bf16(rs, *s))
    assert (r, w) == tpu.apply_flops(tpu.TINY, 16, 16, 3, 1, 1)


def test_paint_unet_flops_equal_counter_default():
    """DEFAULT on meta at the paint stage's shape: 6 views and the
    reference at 64² latents (512² views)."""
    with torch.device("meta"):
        unet = tpu.UNet2p5D(tpu.DEFAULT)
        w, r = _unet_counts(unet, 6, 64, lambda *s: torch.empty(s, dtype=torch.bfloat16))
    assert (r, w) == tpu.apply_flops(tpu.DEFAULT, 64, 64, 6, 1, 1)
    assert (r, w) == (10_585_498_583_040, 804_257_464_320)


@pytest.mark.parametrize("size", ["tiny", "default"])
def test_sd_vae_flops_equal_counter(size):
    """encode and decode: TINY on real bf16 tensors (two images at 64²),
    DEFAULT on meta (one 512² view, one 64² latent)."""
    if size == "tiny":
        rs = np.random.RandomState(1)
        vae, cfg, n, img = build(tvae.AutoencoderKL, tvae.TINY, device="cpu"), tvae.TINY, 2, 64
        make = lambda *s: _bf16(rs, *s)   # noqa: E731
    else:
        with torch.device("meta"):
            vae = tvae.AutoencoderKL(tvae.DEFAULT)
        cfg, n, img = tvae.DEFAULT, 1, 512
        make = lambda *s: torch.empty(s, dtype=torch.bfloat16, device="meta")   # noqa: E731
    lat = img >> (len(cfg.block_out_channels) - 1)
    enc = counted(lambda: vae.encode(make(n, img, img, 3)))
    dec = counted(lambda: vae.decode(make(n, lat, lat, 4)))
    assert enc == tvae.flops(cfg, img, img, n, "encode")
    assert dec == tvae.flops(cfg, lat, lat, n, "decode")
    if size == "default":
        assert (enc, dec) == (1_116_658_466_816, 2_514_518_933_504)


# ---------------------------------------------------------------------------
# (c) the shape stages
# ---------------------------------------------------------------------------
def _jax_leaves(cfg) -> int:
    tree = jax.eval_shape(lambda key: jdit.init(key, cfg), jax.random.PRNGKey(0))
    return sum(int(np.prod(x.shape)) for x in jax.tree.leaves(tree))


def test_dit_parameter_count_equals_jax():
    """The port's TINY DiT holds the JAX tree's parameters, leaf for leaf
    in count (1,977,792), with and without the guidance embedder."""
    for guided in (False, True):
        fields = {**tdit.TINY.__dict__, "guidance_embed": guided}
        with torch.device("meta"):
            model = tdit.Hunyuan3DDiT(tdit.DiTConfig(**fields))
        n = sum(p.numel() for p in model.parameters())
        assert n == _jax_leaves(jdit.DiTConfig(**fields))
    assert _jax_leaves(jdit.TINY) == 1_977_792


DIT_CASES = {   # config, batch, latent tokens, cond tokens (DINOv2-giant: 1370)
    "tiny_cfg": (tdit.TINY, 2, 64, 1370),
    "mini_cfg": (tdit.MINI, 2, 512, 1370),
    "full_guided": (dataclasses.replace(tdit.FULL, guidance_embed=True), 1, 3072, 1370),
}


@pytest.mark.parametrize("name", sorted(DIT_CASES))
def test_dit_forward_flops_equal_counter(name):
    """The DiT counted as it runs equals the counter exactly. bench.py's
    2·params·T charges every parameter to every token: 1.65× the mini DiT's
    CFG pass, 1.49× the FULL DiT's."""
    cfg, batch, lat, cond = DIT_CASES[name]
    with torch.device("meta"):
        model = tdit.Hunyuan3DDiT(cfg)
        x = torch.empty(batch, lat, cfg.in_channels, dtype=torch.bfloat16)
        c = torch.empty(batch, cond, cfg.context_in_dim, dtype=torch.bfloat16)
        t = torch.empty(batch)
        g = torch.empty(batch) if cfg.guidance_embed else None
        n = counted(lambda: model(x, t, c, g))
    want = flops.dit_forward_flops(cfg, lat, cond, batch)
    assert want == n
    params = sum(p.numel() for p in model.parameters())
    seq = lat + cond
    bench = batch * (2 * params * seq + 4 * seq * seq * cfg.hidden_size
                     * (cfg.depth + cfg.depth_single_blocks))
    if name == "mini_cfg":
        assert round(want / 1e12, 3) == 2.979 and round(bench / want, 2) == 1.65
    if name == "full_guided":
        assert round(want / 1e12, 3) == 9.251 and round(bench / want, 2) == 1.49


DINO_CASES = {
    "giant": tdino.GIANT,
    "large": tdino.DinoConfig(hidden_size=1024, num_layers=24, num_heads=16,
                              use_swiglu_ffn=False, mlp_ratio=4),
}


@pytest.mark.parametrize("name", sorted(DINO_CASES))
def test_dino_encode_flops_within_one_percent(name):
    cfg = DINO_CASES[name]
    with torch.device("meta"):
        model = tdino.Dinov2Model(cfg)
        px = torch.empty(2, cfg.image_size, cfg.image_size, 3, dtype=torch.bfloat16)
        n = counted(lambda: model(px))
    assert flops.dino_params(cfg) == sum(p.numel() for p in model.parameters())
    want = flops.dino_encode_flops(cfg, images=2)
    assert n <= want <= 1.01 * n, (want, n)


def test_volume_decode_flops_equal_counter():
    """A TINY geo decoder over a fixed batch of queries through the dense
    decode (decode_queries) on real tensors."""
    cfg = tsv.TINY
    vae = tsv.ShapeVAE.init_random(cfg, device="cpu")
    rs = np.random.RandomState(2)
    lat = torch.from_numpy(rs.standard_normal((1, cfg.num_latents, cfg.embed_dim))
                           .astype(np.float32))
    k, v = vae.compute_kv(vae.decode_latents(lat))
    pts = torch.from_numpy(rs.uniform(-1.01, 1.01, (1, 4096, 3)).astype(np.float32))
    n = counted(lambda: vae.decode_queries(pts, k, v))
    assert flops.volume_decode_flops(cfg, 4096) == n


@pytest.mark.parametrize("decoder,octree,num_chunks", [
    (decoders.FlashVDMVolumeDecoding(), 256, 65536),          # the mini path
    (decoders.FlashVDMVolumeDecoding(), 380, 200000),         # the v2-0 Fast path
    (decoders.HierarchicalVolumeDecoding(), 64, 8192),
    (decoders.VanillaVolumeDecoder(), 64, 65536),
], ids=["flashvdm_256", "flashvdm_380", "hierarchical_64", "vanilla_64"])
def test_volume_decode_queries_are_those_sent(decoder, octree, num_chunks):
    """The count taken from the decoder object equals the queries that its
    decode sends through the decode function (a sphere's logits stand in for
    the geo decoder), padding included."""
    sent = []

    def sphere(pts):
        sent.append(pts.shape[0] * pts.shape[1])
        return 0.6 - pts.norm(dim=-1)

    if isinstance(decoder, decoders.HierarchicalVolumeDecoding):
        decoder.decode_sparse(sphere, 1, octree, num_chunks, device="cpu")
    else:
        decoder(sphere, 1, octree, num_chunks, device="cpu")
    assert sum(sent) == flops.volume_decode_queries(decoder, octree, num_chunks)


def test_mfu_and_peaks():
    assert flops.mfu(989e12, 2.0) == 0.5
    assert flops.mfu(67e12, 1.0, peak=flops.PEAK_FP32) == 1.0
    assert (flops.PEAK_BF16, flops.PEAK_TF32, flops.PEAK_FP32, flops.HBM_BYTES_PER_S) == (
        989e12, 495e12, 67e12, 3.35e12)


# ---------------------------------------------------------------------------
# the trivial counterparts
# ---------------------------------------------------------------------------
def test_decode_queries_topk_is_the_pruned_mean_mode():
    cfg = tsv.ShapeVAEConfig(num_latents=96, width=64, heads=2, num_decoder_layers=1)
    vae = tsv.ShapeVAE.init_random(cfg, device="cpu")
    rs = np.random.RandomState(3)
    lat = torch.from_numpy(rs.standard_normal((1, 96, 64)).astype(np.float32))
    k, v = vae.compute_kv(vae.decode_latents(lat))
    pts = torch.from_numpy(rs.uniform(-1.01, 1.01, (1, 256, 3)).astype(np.float32))
    torch.testing.assert_close(tsv.decode_queries_topk(vae, pts, k, v, 32, 128),
                               tsv.decode_queries_pruned(vae, pts, k, v, 32, 128, "mean"),
                               rtol=0, atol=0)


def test_to_rgb_image_matches_jax():
    from PIL import Image

    from hunyuan3d2_tpu.pipelines import hunyuanpaint as jhp
    from hunyuan3d2_tpu_torch.pipelines import hunyuanpaint as thp

    rs = np.random.RandomState(4)
    rgba = Image.fromarray(rs.randint(0, 256, (24, 20, 4)).astype(np.uint8))
    for image, bg in ((rgba, 255), (rgba, 0), (rgba.convert("LA"), 255)):
        np.testing.assert_array_equal(np.asarray(thp.to_rgb_image(image, bg)),
                                      np.asarray(jhp.to_rgb_image(image, bg)))
    rgb = rgba.convert("RGB")
    assert thp.to_rgb_image(rgb) is rgb
    arr = np.zeros((4, 4, 3))
    assert thp.to_rgb_image(arr) is arr
    ref = thp._reference_array(rgba, 16)
    np.testing.assert_array_equal(ref, thp._control_array(jhp.to_rgb_image(rgba), 16))
