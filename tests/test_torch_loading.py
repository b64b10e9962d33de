"""Checkpoint loading in the port against the JAX package, on the CPU.

Every checkpoint here is written by the test, in the published layouts, from
the JAX package's random weights carried to the checkpoint key names
(hunyuan3d2_tpu_torch/io/convert.py) and rounded to fp16 as the published
``model.fp16.safetensors`` are.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from hunyuan3d2_tpu.io import checkpoints as jckpt
from hunyuan3d2_tpu.pipelines.shapegen import \
    Hunyuan3DDiTFlowMatchingPipeline as JaxPipeline
from hunyuan3d2_tpu_torch.io import checkpoints, convert
from hunyuan3d2_tpu_torch.pipelines.shapegen import \
    Hunyuan3DDiTFlowMatchingPipeline as TorchPipeline

SUB = "hunyuan3d-dit-v2-test"


# ---------------------------------------------------------------------------
# shape checkpoints
# ---------------------------------------------------------------------------
def _image():
    rs = np.random.RandomState(0)
    img = np.zeros((64, 64, 4), np.uint8)
    img[16:48, 16:48, :3] = rs.randint(0, 255, (32, 32, 3))
    img[16:48, 16:48, 3] = 255
    return Image.fromarray(img)


def _config(jp, dual=None):
    c, v, d = jp.model_cfg, jp.vae.cfg, jp.conditioner.main.cfg
    cond = {"main_image_encoder": {"type": "DinoImageEncoder", "kwargs": {
        "config": {"hidden_size": d.dino.hidden_size, "num_hidden_layers": d.dino.num_layers,
                   "num_attention_heads": d.dino.num_heads, "patch_size": d.dino.patch_size,
                   "use_swiglu_ffn": True},
        "image_size": d.image_size}}}
    target = "hy3dgen.shapegen.models.conditioner.SingleImageEncoder"
    if dual is not None:
        target = "hy3dgen.shapegen.models.conditioner.DualImageEncoder"
        cond["additional_image_encoder"] = {"type": "CLIPImageEncoder", "kwargs": {
            "config": {"hidden_size": dual.hidden_size, "num_hidden_layers": dual.num_layers,
                       "num_attention_heads": dual.num_heads, "patch_size": dual.patch_size,
                       "intermediate_size": dual.intermediate_size},
            "image_size": dual.image_size}}
    return {
        "name": "test-tiny",
        "model": {"target": "hy3dgen.shapegen.models.Hunyuan3DDiT", "params": {
            "in_channels": c.in_channels, "context_in_dim": c.context_in_dim,
            "hidden_size": c.hidden_size, "mlp_ratio": c.mlp_ratio, "num_heads": c.num_heads,
            "depth": c.depth, "depth_single_blocks": c.depth_single_blocks,
            "axes_dim": [c.hidden_size // c.num_heads], "theta": 10000,
            "qkv_bias": c.qkv_bias, "guidance_embed": c.guidance_embed}},
        "vae": {"target": "hy3dgen.shapegen.models.ShapeVAE", "params": {
            "num_latents": v.num_latents, "embed_dim": v.embed_dim, "width": v.width,
            "heads": v.heads, "num_decoder_layers": v.num_decoder_layers,
            "num_freqs": v.num_freqs, "include_pi": v.include_pi,
            "scale_factor": v.scale_factor, "qkv_bias": v.qkv_bias}},
        "conditioner": {"target": target, "params": cond},
        "scheduler": {"target": "hy3dgen.shapegen.schedulers.FlowMatchEulerDiscreteScheduler",
                      "params": {"num_train_timesteps": 1000}},
        "image_processor": {"target": "hy3dgen.shapegen.preprocessors.ImageProcessorV2",
                            "params": {"size": 512, "border_ratio": 0.15}},
    }


def _published_sd(jp, clip=None):
    """The flat single-file state dict of a JAX pipeline, fp16, with the keys
    a published checkpoint carries that no module reads."""
    sd = {}
    for top, part in (("model", convert.dit_state_dict(jax.device_get(jp.model_params),
                                                       jp.model_cfg)),
                      ("vae", convert.shapevae_state_dict(jax.device_get(jp.vae.params),
                                                          jp.vae.cfg)),
                      ("conditioner", convert.dinov2_state_dict(
                          jax.device_get(jp.conditioner.main.params), jp.conditioner.main.cfg.dino,
                          prefix="main_image_encoder.model."))):
        sd.update({f"{top}.{k}": v for k, v in part.items()})
    h = jp.conditioner.main.cfg.dino.hidden_size
    sd["conditioner.main_image_encoder.model.embeddings.mask_token"] = np.zeros((1, h))
    sd["vae.pre_kl.weight"] = np.ones((2, 3))
    if clip is not None:
        params, ccfg = clip
        a = "conditioner.additional_image_encoder.model."
        sd.update({"conditioner." + k: v for k, v in convert.clip_vit_state_dict(
            jax.device_get(params), ccfg, prefix="additional_image_encoder.model.").items()})
        sd[a + "vision_model.embeddings.position_ids"] = np.arange(ccfg.seq_len)[None]
        sd[a + "vision_model.post_layernorm.weight"] = np.ones(ccfg.hidden_size)
        sd[a + "vision_model.post_layernorm.bias"] = np.zeros(ccfg.hidden_size)
    return {k: (np.asarray(v).astype(np.float16) if np.asarray(v).dtype.kind == "f"
                else np.asarray(v)) for k, v in sd.items()}


def _write(root, sd, config, layout):
    """Write ``sd`` under ``root/SUB`` in one of the published layouts."""
    from safetensors.numpy import save_file

    sub = os.path.join(root, SUB)
    os.makedirs(sub, exist_ok=True)
    with open(os.path.join(sub, "config.yaml"), "w") as fh:
        yaml.safe_dump(config, fh)
    if layout == "safetensors":
        save_file(sd, os.path.join(sub, "model.fp16.safetensors"))
        return
    tensors = {k: torch.from_numpy(v) for k, v in sd.items()}
    if layout == "nested":        # {model: sd, vae: sd, conditioner: sd}, DeepSpeed inside one
        ckpt = {}
        for k, v in tensors.items():
            top, rest = k.split(".", 1)
            ckpt.setdefault(top, {})[("_forward_module." if top == "model" else "") + rest] = v
    else:                         # flat, each key under the DeepSpeed wrapper
        ckpt = {f"_forward_module.{k}": v for k, v in tensors.items()}
    torch.save(ckpt, os.path.join(sub, "model.fp16.ckpt"))


@pytest.fixture(scope="module")
def jax_tiny():
    return JaxPipeline.init_random(jax.random.PRNGKey(0), size="tiny", dino="tiny")


def _assert_same_weights(tp, jp):
    """Every port tensor equals the JAX loader's, mapped to the same keys and
    cast to the port's dtype."""
    for module, sd in ((tp.model, convert.dit_state_dict(jax.device_get(jp.model_params),
                                                         jp.model_cfg)),
                       (tp.vae, convert.shapevae_state_dict(jax.device_get(jp.vae.params),
                                                            jp.vae.cfg)),
                       (tp.conditioner.main, convert.dinov2_state_dict(
                           jax.device_get(jp.conditioner.main.params),
                           jp.conditioner.main.cfg.dino))):
        own = module.state_dict()
        assert set(own) == set(sd)
        for k, t in own.items():
            assert torch.equal(t, torch.from_numpy(sd[k]).to(t.dtype)), k


@pytest.mark.parametrize("layout", ["safetensors", "nested", "deepspeed"])
def test_shape_layouts_load_the_jax_weights(tmp_path, jax_tiny, layout):
    sd = _published_sd(jax_tiny)
    _write(str(tmp_path), sd, _config(jax_tiny), layout)
    tp = TorchPipeline.from_pretrained(str(tmp_path), subfolder=SUB, device="cpu")
    jp = JaxPipeline.from_pretrained(str(tmp_path), subfolder=SUB)
    assert tp.device == torch.device("cpu")
    _assert_same_weights(tp, jp)
    ckpt = os.path.join(str(tmp_path), SUB, "model.fp16." + ("safetensors" if layout ==
                                                              "safetensors" else "ckpt"))
    single = TorchPipeline.from_single_file(ckpt, os.path.join(str(tmp_path), SUB,
                                                               "config.yaml"), device="cpu")
    for a, b in zip(single.model.state_dict().values(), tp.model.state_dict().values()):
        assert torch.equal(a, b)


def test_from_pretrained_matches_the_jax_call(tmp_path, jax_tiny, monkeypatch):
    """One call at octree 32 with injected latents through both packages'
    from_pretrained: the tolerances of tests/test_torch_shapegen.py."""
    _write(str(tmp_path), _published_sd(jax_tiny), _config(jax_tiny), "safetensors")
    monkeypatch.setenv("HY3DGEN_MODELS", str(tmp_path))
    tp = TorchPipeline.from_pretrained("", subfolder=SUB, device="cpu")   # found by $HY3DGEN_MODELS
    jp = JaxPipeline.from_pretrained(str(tmp_path), subfolder=SUB)
    lat = np.random.RandomState(5).randn(1, jp.vae.cfg.num_latents,
                                         jp.vae.cfg.embed_dim).astype(np.float32)
    jp.prepare_latents = lambda batch_size, key: jnp.asarray(lat)
    tp.prepare_latents = lambda batch_size, generator: torch.from_numpy(lat)
    jp.enable_flashvdm(True, mc_algo="dmc")
    tp.enable_flashvdm(mc_algo="dmc")
    kw = dict(image=_image(), num_inference_steps=2, guidance_scale=5.0, seed=3)
    lat_j = np.asarray(jp(output_type="latents", **kw))
    lat_t = tp(output_type="latents", **kw).numpy()
    assert np.abs(lat_t - lat_j).max() < 0.02 * np.abs(lat_j).max()
    mj = jp(octree_resolution=32, **kw)[0]
    mt = tp(octree_resolution=32, **kw)[0]
    nvj, nfj = len(mj.vertices), len(mj.faces)
    assert nvj > 0 and abs(len(mt.vertices) - nvj) <= 0.03 * nvj
    assert abs(len(mt.faces) - nfj) <= 0.03 * nfj
    # with the weights kept on the host between calls, the same latents
    tp.enable_model_cpu_offload()
    np.testing.assert_array_equal(tp(output_type="latents", **kw).numpy(), lat_t)


def test_offload_to_host_drops_the_geo_decoder_operands():
    """The geo decoder's kernel operands are device copies of its weights:
    offloading drops them, and the next decode builds them anew."""
    from hunyuan3d2_tpu_torch.ops import geo_decoder

    tp = TorchPipeline.init_random(size="tiny", dino="tiny", device="cpu")
    ops = geo_decoder._operands(tp.vae, tp.device)
    assert geo_decoder._operands(tp.vae, tp.device) is ops
    tp.offload_to_host()
    assert tp.vae._geo_operands is None
    tp.restore_to_device()
    assert geo_decoder._operands(tp.vae, tp.device) is not ops


def test_standalone_dit_checkpoint(tmp_path, jax_tiny):
    """A DeepSpeed-trained DiT on its own ('_forward_module.model.' keys):
    both readers strip the wrappers alike, and the port's DiT built from it
    runs the JAX DiT's forward."""
    from hunyuan3d2_tpu.models import dit as jdit
    from hunyuan3d2_tpu_torch.models import dit as tdit

    sd = convert.dit_state_dict(jax.device_get(jax_tiny.model_params), jax_tiny.model_cfg)
    path = str(tmp_path / "dit.ckpt")
    torch.save({f"_forward_module.model.{k}": torch.from_numpy(v).half()
                for k, v in sd.items()}, path)
    ours, ref = checkpoints.load_state_dict(path), jckpt.load_state_dict(path)
    assert set(ours) == set(ref) == set(sd)
    for k in sd:
        np.testing.assert_array_equal(ours[k].float().numpy(), ref[k])
    cfg = tdit.DiTConfig(**dataclasses.asdict(jax_tiny.model_cfg))
    model = checkpoints.load_weights(checkpoints.on_meta(tdit.Hunyuan3DDiT, cfg), ours, "cpu")
    params = jckpt.map_dit(ref, jax_tiny.model_cfg, "bf16")
    rs = np.random.RandomState(1)
    x = rs.randn(1, 16, cfg.in_channels).astype(np.float32)
    t = np.array([0.5], np.float32)
    cond = rs.randn(1, 10, cfg.context_in_dim).astype(np.float32)
    out = model(torch.from_numpy(x).bfloat16(), torch.from_numpy(t),
                torch.from_numpy(cond).bfloat16()).float().numpy()
    want = np.asarray(jdit.apply(params, jax_tiny.model_cfg, jnp.asarray(x, jnp.bfloat16),
                                 jnp.asarray(t), jnp.asarray(cond, jnp.bfloat16)), np.float32)
    assert np.abs(out - want).max() <= 0.02 * np.abs(want).max()


def test_unknown_key_raises_with_its_name(tmp_path, jax_tiny):
    sd = _published_sd(jax_tiny)
    sd["vae.geo_decoder.bogus_layer.weight"] = np.zeros(3, np.float16)
    _write(str(tmp_path), sd, _config(jax_tiny), "safetensors")
    with pytest.raises(KeyError, match="bogus_layer"):
        TorchPipeline.from_pretrained(str(tmp_path), subfolder=SUB, device="cpu")
    del sd["vae.geo_decoder.bogus_layer.weight"], sd["model.latent_in.bias"]
    _write(str(tmp_path), sd, _config(jax_tiny), "safetensors")
    with pytest.raises(KeyError, match="latent_in.bias"):
        TorchPipeline.from_pretrained(str(tmp_path), subfolder=SUB, device="cpu")


@pytest.mark.parametrize("section,target,message", [
    ("model", "hy3dgen.shapegen.models.NoSuchDiT", "NoSuchDiT"),
    ("vae", "hy3dgen.shapegen.models.NoSuchVAE", "NoSuchVAE"),
    ("conditioner", "hy3dgen.shapegen.models.NoSuchEncoder", "NoSuchEncoder"),
    ("scheduler", "hy3dgen.shapegen.schedulers.NoSuchScheduler", "NoSuchScheduler"),
])
def test_unknown_target_raises_with_its_name(tmp_path, jax_tiny, section, target, message):
    """The loader takes each tower's class from the config's target: one the
    port has no class for raises rather than loading another."""
    config = _config(jax_tiny)
    config[section]["target"] = target
    _write(str(tmp_path), _published_sd(jax_tiny), config, "safetensors")
    with pytest.raises(KeyError, match=message):
        TorchPipeline.from_pretrained(str(tmp_path), subfolder=SUB, device="cpu")


def test_config_without_targets_takes_the_default_classes(tmp_path, jax_tiny):
    """A config that names no targets loads the single-view stack and the
    flow-matching scheduler, with the same weights as one that names them."""
    from hunyuan3d2_tpu_torch.models import conditioner, dit, shapevae
    from hunyuan3d2_tpu_torch.pipelines import schedulers

    config = {k: {"params": v["params"]} for k, v in _config(jax_tiny).items() if k != "name"}
    _write(str(tmp_path), _published_sd(jax_tiny), config, "safetensors")
    tp = TorchPipeline.from_pretrained(str(tmp_path), subfolder=SUB, device="cpu")
    assert type(tp.model) is dit.Hunyuan3DDiT and type(tp.vae) is shapevae.ShapeVAE
    assert type(tp.conditioner) is conditioner.SingleImageEncoder
    assert type(tp.scheduler) is schedulers.FlowMatchEulerDiscreteScheduler
    assert tp.scheduler.num_train_timesteps == 1000
    _assert_same_weights(tp, JaxPipeline.from_pretrained(str(tmp_path), subfolder=SUB))


def test_missing_checkpoint_without_the_hub_raises(tmp_path, monkeypatch):
    """No local checkpoint and no huggingface_hub: FileNotFoundError (the
    hub is never contacted: the module is blocked)."""
    import sys

    monkeypatch.setitem(sys.modules, "huggingface_hub", None)
    monkeypatch.setenv("HY3DGEN_MODELS", str(tmp_path))
    with pytest.raises(FileNotFoundError, match="HY3DGEN_MODELS"):
        checkpoints.smart_load_model(str(tmp_path / "nowhere"), SUB)
    with pytest.raises(FileNotFoundError):
        checkpoints.load_paint_pipeline(str(tmp_path / "nowhere"), device="cpu")


def test_dual_conditioner_checkpoint(tmp_path, jax_tiny):
    """A v2-0-style Dual (DINOv2 + CLIP) checkpoint: the port builds the
    DualImageEncoder, its CLIP tower runs the JAX tower's function, and
    both streams come out CFG-doubled."""
    from hunyuan3d2_tpu.models import clip_vit as jclip
    from hunyuan3d2_tpu_torch.models.conditioner import DualImageEncoder
    from hunyuan3d2_tpu_torch.utils.imageproc import clip_transform

    # head size 64, as ViT-L/14's: the tower's attention takes kernel 1's path
    ccfg = jclip.CLIPVisionConfig(hidden_size=128, num_layers=2, num_heads=2, patch_size=14,
                                  image_size=56, intermediate_size=256)
    cparams = jclip.init(jax.random.PRNGKey(4), ccfg)
    _write(str(tmp_path), _published_sd(jax_tiny, (cparams, ccfg)), _config(jax_tiny, ccfg),
           "safetensors")
    tp = TorchPipeline.from_pretrained(str(tmp_path), subfolder=SUB, device="cpu")
    jp = JaxPipeline.from_pretrained(str(tmp_path), subfolder=SUB)
    assert isinstance(tp.conditioner, DualImageEncoder)
    assert tp.conditioner.additional.cfg.image_size == ccfg.image_size
    _assert_same_weights(tp, jp)

    img = np.random.RandomState(2).uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    pix = clip_transform(img, ccfg.image_size)
    out = tp.conditioner.additional.encode(torch.from_numpy(pix).bfloat16()).float().numpy()
    jadd = jp.conditioner.additional
    want = np.asarray(jclip.apply(jadd.params, jadd.cfg, jnp.asarray(pix, jnp.bfloat16)),
                      np.float32)
    assert out.shape == want.shape == (2, ccfg.seq_len, ccfg.hidden_size)
    assert np.abs(out - want).max() <= 0.02 * np.abs(want).max()

    tp.encode_cond(img[:1], do_cfg=True)
    streams = tp.last_cond_streams
    assert set(streams) == {"main", "additional"}
    assert streams["additional"].shape == (2, ccfg.seq_len, ccfg.hidden_size)
    assert float(streams["additional"][1].abs().max()) == 0.0


# ---------------------------------------------------------------------------
# the paint-turbo directory
# ---------------------------------------------------------------------------
def test_paint_turbo_directory_matches(tmp_path):
    """unet/ and vae/ written with the JAX package's diffusers exporters
    (a UNet at the paint UNet's head size, 64/128 channels; the tiny VAE) load
    through both packages' from_pretrained, and one multiview call gives the
    same views."""
    from hunyuan3d2_tpu.io import diffusers_maps as dm
    from hunyuan3d2_tpu.models import paint_unet as jpu
    from hunyuan3d2_tpu.models import sd_vae as jvae
    from hunyuan3d2_tpu.pipelines.texgen import Hunyuan3DPaintPipeline as JPaint
    from hunyuan3d2_tpu_torch import Hunyuan3DPaintPipeline
    from safetensors.numpy import save_file
    from tests.test_torch_texgen import _jax_turbo_noise

    ucfg = dataclasses.replace(jpu.TINY, block_out_channels=(64, 128), attention_head_dim=64)
    uparams = jax.device_get(jpu.init(jax.random.PRNGKey(0), ucfg))
    vparams = jax.device_get(jvae.init(jax.random.PRNGKey(1), jvae.TINY))
    root = tmp_path / "hunyuan3d-paint-v2-0-turbo"
    os.makedirs(root / "unet")
    os.makedirs(root / "vae")
    (root / "unet" / "config.json").write_text(json.dumps({
        "block_out_channels": list(ucfg.block_out_channels),
        "layers_per_block": ucfg.layers_per_block, "out_channels": 4,
        "cross_attention_dim": ucfg.cross_attention_dim,
        "norm_num_groups": ucfg.norm_num_groups}))
    save_file({k: np.asarray(v, np.float16) for k, v in dm.export_paint_unet(uparams).items()},
              str(root / "unet" / "diffusion_pytorch_model.safetensors"))
    (root / "vae" / "config.json").write_text(json.dumps({
        "block_out_channels": list(jvae.TINY.block_out_channels),
        "layers_per_block": jvae.TINY.layers_per_block, "latent_channels": 4}))
    torch.save({k: torch.tensor(np.asarray(v, np.float32))
                for k, v in dm.export_sd_vae(vparams).items()},
               str(root / "vae" / "diffusion_pytorch_model.bin"))

    tpipe = Hunyuan3DPaintPipeline.from_pretrained(str(tmp_path), device="cpu")
    # the JAX loader reads unet/ from model_path itself
    jpipe = JPaint.from_pretrained(str(root), subfolder="hunyuan3d-paint-v2-0-turbo")
    tnet, jnet = tpipe.models["multiview_model"], jpipe.models["multiview_model"]
    assert tnet.pipeline.is_turbo and jnet.pipeline.is_turbo
    view = 32
    tnet.view_size = jnet.view_size = view
    tnet.pipeline.view_size = jnet.pipeline.view_size = view
    tnet.num_inference_steps = jnet.num_inference_steps = 2
    rs = np.random.RandomState(3)
    normal = rs.randint(0, 255, (6, view, view, 3)).astype(np.uint8)
    position = rs.randint(0, 255, (6, view, view, 3)).astype(np.uint8)
    image = _image()
    cams = [12, 15, 18, 21, 40, 36]
    ref = jnet(image, (jnp.asarray(normal), jnp.asarray(position)), cams)
    init, noises = _jax_turbo_noise((1, 6, view // 2, view // 2, 4), 2)
    out = tnet(image, (torch.from_numpy(normal), torch.from_numpy(position)), cams,
               init_latents=init, step_noises=noises)
    a = np.stack([np.asarray(im) for im in out]).astype(np.float64)
    b = np.stack([np.asarray(im) for im in ref]).astype(np.float64)
    assert a.shape == b.shape == (6, view, view, 3)
    corr = np.corrcoef(a.ravel(), b.ravel())[0, 1]
    assert corr >= 0.99 and np.abs(a - b).mean() <= 3.0, (corr, np.abs(a - b).mean())


def test_config_registry_names_the_ports_classes():
    """Every reference class path of the JAX package's registry resolves to
    the port's class of the same name; schedulers and image processors build
    from their config blocks."""
    from hunyuan3d2_tpu import config as jconfig
    from hunyuan3d2_tpu_torch import config

    assert set(config.REGISTRY) == set(jconfig.REGISTRY)
    for name in config.REGISTRY:
        cls = config.get_obj_from_str(name)
        assert cls.__module__.startswith("hunyuan3d2_tpu_torch.")
        assert cls.__name__ == jconfig.REGISTRY[name].rsplit(".", 1)[1]
    sched = config.instantiate_from_config({
        "target": "hy3dgen.shapegen.schedulers.FlowMatchEulerDiscreteScheduler",
        "params": {"num_train_timesteps": 1000}})
    assert sched.num_train_timesteps == 1000
    proc = config.instantiate_from_config({
        "target": "hy3dgen.shapegen.preprocessors.ImageProcessorV2",
        "params": {"size": 512, "border_ratio": 0.15}})
    assert proc.size == 512
    with pytest.raises(KeyError):
        config.instantiate_from_config({"params": {}})


@pytest.mark.parametrize("path,cls", [
    ("hy3dgen.shapegen.models.SingleImageEncoder", "SingleImageEncoder"),
    ("hy3dgen.shapegen.models.DualImageEncoder", "DualImageEncoder"),
    ("hy3dgen.shapegen.models.denoisers.hunyuan3ddit.Hunyuan3DDiT", "Hunyuan3DDiT"),
    ("hy3dgen.shapegen.models.autoencoders.model.ShapeVAE", "ShapeVAE"),
])
def test_config_registry_resolves_other_reference_paths_by_class_name(path, cls):
    """The reference exports each class from more than one module; a path
    the registry does not list resolves by its class name."""
    from hunyuan3d2_tpu_torch import config

    got = config.get_obj_from_str(path)
    assert got.__name__ == cls and got.__module__.startswith("hunyuan3d2_tpu_torch.")
