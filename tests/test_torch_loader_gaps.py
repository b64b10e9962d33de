"""The two loader configurations the port gained after the JAX package had
them, on the CPU against the JAX package: the plain-MLP DINOv2
(``use_swiglu_ffn: false``, the HF ViT-S/B/L FFN: fc1 → exact GELU → fc2)
and the fp32 paint stack (``load_paint_pipeline(..., dtype="fp32")``).

Weights are drawn by the JAX package and carried to the checkpoint key
names (hunyuan3d2_tpu_torch/io/convert.py, the JAX diffusers exporters);
inputs are made by numpy from a seed and handed to both frameworks.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hunyuan3d2_tpu.io import checkpoints as jckpt
from hunyuan3d2_tpu.models import dinov2 as jdino
from hunyuan3d2_tpu.pipelines.shapegen import \
    Hunyuan3DDiTFlowMatchingPipeline as JaxPipeline
from hunyuan3d2_tpu_torch.io import checkpoints, convert
from hunyuan3d2_tpu_torch.models import conditioner as tcond
from hunyuan3d2_tpu_torch.models import dinov2 as tdino
from hunyuan3d2_tpu_torch.ops.nn import Linear, build
from hunyuan3d2_tpu_torch.pipelines.shapegen import \
    Hunyuan3DDiTFlowMatchingPipeline as TorchPipeline
from tests.test_torch_loading import SUB, _config, _image, _published_sd, _write
from tests.test_torch_models import SMALL_DINO, _tree_equal, assert_close

# the small ViT of tests/test_torch_models.py with the plain-MLP FFN
PLAIN_DINO = dict(SMALL_DINO, use_swiglu_ffn=False, mlp_ratio=4)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.fixture(scope="module")
def plain_dino():
    dcfg = jdino.DinoConfig(**PLAIN_DINO)
    params = jax.device_get(jax.jit(jdino.init, static_argnums=1)(jax.random.PRNGKey(0), dcfg))
    enc = build(tcond.DinoImageEncoder,
                tcond.DinoEncoderConfig(dino=tdino.DinoConfig(**PLAIN_DINO),
                                        image_size=dcfg.image_size), device="cpu")
    return dcfg, params, convert.load_numpy_state_dict(enc, convert.dinov2_state_dict(params,
                                                                                      dcfg))


def test_plain_mlp_dinov2_state_dict_round_trip(plain_dino):
    dcfg, params, enc = plain_dino
    assert isinstance(enc.model.encoder.layer[0].mlp, tdino.Mlp)
    sd = {k: v.float().numpy() for k, v in enc.state_dict().items()}
    assert "model.encoder.layer.0.mlp.fc1.weight" in sd
    assert sd["model.encoder.layer.0.mlp.fc1.weight"].shape == (4 * 128, 128)
    assert not any("weights_in" in k for k in sd)
    _tree_equal(jckpt.map_dinov2(sd, dcfg), params)


def test_plain_mlp_dinov2_forward_matches(plain_dino):
    dcfg, params, enc = plain_dino
    pix = np.random.RandomState(0).randn(2, 56, 56, 3).astype(np.float32)
    ref = jdino.apply(params, dcfg, jnp.asarray(pix, jnp.bfloat16))
    out = enc.encode(torch.from_numpy(pix).to(torch.bfloat16))
    assert out.dtype == torch.bfloat16
    # test_dinov2_forward_matches's rule: bf16 activations through two
    # layers, rounded at other places
    assert_close(out, ref, 0.05)


@pytest.fixture(scope="module")
def jax_tiny_plain():
    """The tiny shape stack with a plain-MLP DINOv2 of the tiny one's widths
    (1536 wide: the DiT's context width)."""
    jp = JaxPipeline.init_random(jax.random.PRNGKey(0), size="tiny", dino="tiny")
    d = jp.conditioner.main.cfg.dino
    dcfg = dataclasses.replace(d, use_swiglu_ffn=False, mlp_ratio=2)
    params = jax.device_get(jax.jit(jdino.init, static_argnums=1)(jax.random.PRNGKey(1), dcfg))
    main = jp.conditioner.main
    main.params = params
    main.cfg = dataclasses.replace(main.cfg, dino=dcfg)
    return jp


def test_from_pretrained_loads_a_plain_mlp_dinov2(tmp_path, jax_tiny_plain):
    """A shape checkpoint whose conditioner config says use_swiglu_ffn:
    false (which the port used to refuse) loads through both packages'
    from_pretrained with the same weights, the FFN width read from the
    checkpoint's mlp.fc1, and both conditioners encode an image alike."""
    jp0 = jax_tiny_plain
    config = _config(jp0)
    config["conditioner"]["params"]["main_image_encoder"]["kwargs"]["config"][
        "use_swiglu_ffn"] = False
    _write(str(tmp_path), _published_sd(jp0), config, "safetensors")
    tp = TorchPipeline.from_pretrained(str(tmp_path), subfolder=SUB, device="cpu")
    jp = JaxPipeline.from_pretrained(str(tmp_path), subfolder=SUB)
    dcfg = tp.conditioner.main.cfg.dino
    assert not dcfg.use_swiglu_ffn and dcfg.mlp_ratio == 2
    assert not jp.conditioner.main.cfg.dino.use_swiglu_ffn
    own = tp.conditioner.main.state_dict()
    sd = convert.dinov2_state_dict(jax.device_get(jp.conditioner.main.params),
                                   jp.conditioner.main.cfg.dino)
    assert set(own) == set(sd) and "model.encoder.layer.1.mlp.fc2.weight" in own
    for k, t in own.items():
        assert torch.equal(t, torch.from_numpy(sd[k]).to(t.dtype)), k
    img = np.asarray(_image().convert("RGB")).astype(np.float32)[None] / 127.5 - 1.0
    assert_close(tp.conditioner.encode_image(img)["main"],
                 jp.conditioner.encode_image(img)["main"], 0.05)


# ---------------------------------------------------------------------------
# the fp32 paint stack
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def paint_dir(tmp_path_factory):
    """A paint-turbo directory written in fp32 by the JAX diffusers
    exporters: a UNet at the paint UNet's head size (64/128 channels, the
    width the loaders' fixed head size of 64 admits), the tiny VAE."""
    from hunyuan3d2_tpu.io import diffusers_maps as dm
    from hunyuan3d2_tpu.models import paint_unet as jpu
    from hunyuan3d2_tpu.models import sd_vae as jvae
    from safetensors.numpy import save_file

    ucfg = dataclasses.replace(jpu.TINY, block_out_channels=(64, 128), attention_head_dim=64)
    uparams = jax.device_get(jpu.init(jax.random.PRNGKey(0), ucfg))
    vparams = jax.device_get(jvae.init(jax.random.PRNGKey(1), jvae.TINY))
    root = tmp_path_factory.mktemp("paint") / "hunyuan3d-paint-v2-0-turbo"
    os.makedirs(root / "unet")
    os.makedirs(root / "vae")
    (root / "unet" / "config.json").write_text(json.dumps({
        "block_out_channels": list(ucfg.block_out_channels),
        "layers_per_block": ucfg.layers_per_block, "out_channels": 4,
        "cross_attention_dim": ucfg.cross_attention_dim,
        "norm_num_groups": ucfg.norm_num_groups}))
    save_file({k: np.asarray(v, np.float32) for k, v in dm.export_paint_unet(uparams).items()},
              str(root / "unet" / "diffusion_pytorch_model.safetensors"))
    (root / "vae" / "config.json").write_text(json.dumps({
        "block_out_channels": list(jvae.TINY.block_out_channels),
        "layers_per_block": jvae.TINY.layers_per_block, "latent_channels": 4}))
    save_file({k: np.asarray(v, np.float32) for k, v in dm.export_sd_vae(vparams).items()},
              str(root / "vae" / "diffusion_pytorch_model.safetensors"))
    return root


def test_fp32_paint_stack_matches_jax(paint_dir):
    """load_paint_pipeline(dtype="fp32") in both packages: every port
    parameter is fp32 (the pipeline computes in fp32), and one UNet forward
    ('w' pass, then 'r' under voxel masks) agrees with the JAX fp32 forward
    at test_torch_paint.py's fp32 tolerance."""
    from hunyuan3d2_tpu.models import paint_unet as jpu

    tpipe = checkpoints.load_paint_pipeline(str(paint_dir.parent), paint_dir.name,
                                            view_size=32, device="cpu", dtype="fp32")
    jpipe = jckpt.load_paint_pipeline(str(paint_dir), view_size=32, dtype="fp32")
    assert tpipe.dtype == torch.float32
    for module in (tpipe.unet, tpipe.vae):
        assert all(p.dtype == torch.float32 for p in module.parameters())
    linears = [m for m in tpipe.unet.modules() if isinstance(m, Linear)]
    assert linears and all(m.weight.dtype == torch.float32 for m in linears)
    assert all(np.asarray(x).dtype == np.float32
               for x in jax.tree_util.tree_leaves(jpipe.unet_params))

    rs = np.random.RandomState(4)
    b, n, h = 1, 3, 8
    samp, nl, pl_ = (rs.randn(b, n, h, h, 4).astype(np.float32) for _ in range(3))
    ref = rs.randn(b, 1, h, h, 4).astype(np.float32)
    cam_gen, cam_ref = np.array([[12, 15, 40]]), np.array([[0]])
    pos = rs.rand(b, n, 32, 32, 3).astype(np.float32)
    masks = {int(m.shape[1]): m for m in
             (jpu.compute_voxel_grid_mask(jnp.asarray(pos), g) for g in (8, 4))}
    assert all(np.asarray(m).any(-1).all() for m in masks.values())
    jout, _ = jax.jit(lambda p, *a: jpu.apply(p, jpipe.unet_cfg, *a, mva_masks=masks))(
        jpipe.unet_params, jnp.asarray(samp), jnp.float32(500.0), jnp.asarray(nl),
        jnp.asarray(pl_), jnp.asarray(ref), jnp.asarray(cam_gen), jnp.asarray(cam_ref))
    t = torch.from_numpy
    with torch.no_grad():
        cache = tpipe.unet.write_cache(t(ref))
        out = tpipe.unet(t(samp), 500.0, t(nl), t(pl_), t(cam_gen), cache,
                         mva_masks={k: t(np.array(v)) for k, v in masks.items()})
    assert out.dtype == torch.float32
    jout, out = _np(jout), _np(out)
    assert out.shape == jout.shape == (b, n, h, h, 4)
    # fp32: summation order only (test_torch_paint.py's fp32 rule)
    assert np.abs(out - jout).max() < 2e-5 * np.abs(jout).max()


def test_paint_loader_refuses_fp16(paint_dir):
    """fp16 weights stay refused, as everywhere in the port (kernel 1 has no
    fp16 instance; ROADMAP C.10)."""
    with pytest.raises(ValueError, match="fp16"):
        checkpoints.load_paint_pipeline(str(paint_dir.parent), paint_dir.name, device="cpu",
                                        dtype="fp16")
