"""Checkpoint loading: the unchanged Hunyuan3D-2 checkpoint files → the
port's modules on a device (port of hunyuan3d2_tpu/io/checkpoints.py).

* Readers: ``model.{variant}.safetensors`` and torch ``.ckpt`` files in
  their three layouts (nested
  ``{model: sd, vae: sd, conditioner: sd}``, flat multi-model ``model.`` /
  ``vae.`` / ``conditioner.`` keys, a standalone submodel), each with the
  DeepSpeed ``_forward_module.`` wrapper stripped.
* ``smart_load_model``: ``{model_path}/{subfolder}``, then
  ``$HY3DGEN_MODELS/{model_path}/{subfolder}`` (default ``~/.cache/hy3dgen``),
  ``model.{variant}.safetensors`` before ``.ckpt``, then the hub.
* ``load_pipeline_single_file``: each tower's class from its config.yaml
  ``target`` (through the registry in ``config.py``) and its config from
  ``params`` (the same defaults as the JAX loader): the DiT, the ShapeVAE,
  the conditioner (single, multiview or Dual DINOv2 + CLIP) and the
  scheduler.
* ``load_paint_pipeline``: the diffusers layout ``unet/`` and ``vae/``, each
  a ``config.json`` beside ``diffusion_pytorch_model.{bin,safetensors}``.
* ``load_t2i_pipeline``: a diffusers HunyuanDiT directory, ``transformer/``
  and ``vae/`` (``.safetensors`` before ``.bin``), and the text encoders
  ``text_encoder/`` (BERT) and ``text_encoder_2/`` (mT5) through
  ``transformers`` when the package and both directories are there.
* ``load_delight_pipeline``, ``load_upscale_pipeline`` and
  ``load_align_pipeline``: the diffusers InstructPix2Pix, x4-upscaler and
  SD1.5 directories (``unet/``, ``vae/``, the x4's ``scheduler/`` and
  ``low_res_scheduler/``), a ControlNetModel directory and an IP-Adapter
  file, ``.safetensors`` before ``.bin``; the "" prompt's CLIP embedding
  through ``transformers`` (``empty_prompt_embed``).

The port's modules carry the checkpoint key names, so a state dict loads as
it is: each module is built on the ``meta`` device, given storage on the
target device, and filled from the file, every tensor cast to the dtype the
module holds (bf16 weights, fp32 norms and embeddings); no random weights
are drawn. The keys the JAX mappers read nothing from are skipped by name
(:data:`IGNORED`); any other missing or unexpected key raises with its name.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Tuple

import numpy as np
import safetensors.torch
import torch
import yaml
from torch import nn

# Per tower, the key prefixes of a published checkpoint that no module reads:
# the ShapeVAE's encoder half (the pipelines only decode), DINOv2's mask
# token, and CLIP's position-id buffer, post-LayerNorm and projection (the
# conditioner reads last_hidden_state).
IGNORED = {
    "model": (),
    "vae": ("encoder.", "pre_kl."),
    "conditioner": ("main_image_encoder.model.embeddings.mask_token",
                    "additional_image_encoder.model.vision_model.embeddings.position_ids",
                    "additional_image_encoder.model.vision_model.post_layernorm.",
                    "additional_image_encoder.model.visual_projection."),
}


# ---------------------------------------------------------------------------
# raw tensors
# ---------------------------------------------------------------------------
def load_torch_ckpt(path: str) -> Dict[str, torch.Tensor]:
    """A torch checkpoint as a flat ``{'top.rest': tensor}`` dict: a nested
    pipeline checkpoint is flattened, a flat multi-model one keeps its
    prefixes, a standalone submodel loses its ``model.`` wrapper; the
    DeepSpeed ``_forward_module.`` wrapper goes in every layout. Tensors keep
    their stored dtype."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(ckpt, dict) and "state_dict" in ckpt:
        ckpt = ckpt["state_dict"]
    if all(isinstance(v, dict) for v in ckpt.values()):
        return {f"{top}.{k.replace('_forward_module.', '')}": v
                for top, sub in ckpt.items() for k, v in sub.items()}
    tops = {k.replace("_forward_module.", "").split(".", 1)[0] for k in ckpt}
    multi = {"model", "vae"} <= tops
    out = {}
    for k, v in ckpt.items():
        k = k.replace("_forward_module.", "")
        if not multi and k.startswith("model."):
            k = k[len("model."):]
        out[k] = v
    return out


def load_state_dict(path: str) -> Dict[str, torch.Tensor]:
    if path.endswith(".safetensors"):
        return safetensors.torch.load_file(path)
    return load_torch_ckpt(path)


def split_by_top_key(sd: Dict[str, torch.Tensor]) -> Dict[str, Dict[str, torch.Tensor]]:
    """``{'model.x': t, 'vae.y': u}`` → ``{'model': {'x': t}, 'vae': {'y': u}}``."""
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    for k, v in sd.items():
        top, rest = k.split(".", 1)
        out.setdefault(top, {})[rest] = v
    return out


def _models_root() -> str:
    return os.path.expanduser(os.environ.get("HY3DGEN_MODELS", "~/.cache/hy3dgen"))


def _hub_download(model_path: str, allow_patterns=None) -> str:
    """The hub's snapshot of ``model_path``; FileNotFoundError when
    ``huggingface_hub`` is absent or the download fails."""
    try:
        from huggingface_hub import snapshot_download

        return snapshot_download(repo_id=model_path, allow_patterns=allow_patterns)
    except Exception as e:  # ImportError, or any failure of the download
        raise FileNotFoundError(f"{model_path} not found locally (HY3DGEN_MODELS="
                                f"{_models_root()}) and the hub download failed: {e}") from e


def _checkpoint_in(d: str, variant: str):
    """(config.yaml, checkpoint) in directory ``d``, or None."""
    cfg = os.path.join(d, "config.yaml")
    if os.path.exists(cfg):
        for name in (f"model.{variant}.safetensors", f"model.{variant}.ckpt",
                     "model.safetensors", "model.ckpt"):
            if os.path.exists(os.path.join(d, name)):
                return cfg, os.path.join(d, name)
    return None


def smart_load_model(model_path: str, subfolder: str, variant: str = "fp16"):
    """(config.yaml path, checkpoint path) of ``{model_path}/{subfolder}``:
    local first, then under ``$HY3DGEN_MODELS``, then the hub."""
    for d in (os.path.join(model_path, subfolder),
              os.path.join(_models_root(), model_path, subfolder)):
        found = _checkpoint_in(d, variant)
        if found:
            return found
    d = os.path.join(_hub_download(model_path, [f"{subfolder}/*"]), subfolder)
    found = _checkpoint_in(d, variant)
    if found is None:
        raise FileNotFoundError(f"no config.yaml and model checkpoint in {d}")
    return found


# ---------------------------------------------------------------------------
# weights → modules
# ---------------------------------------------------------------------------
def on_meta(cls, *args, **kwargs) -> nn.Module:
    """``cls(*args, **kwargs)`` with its parameters on the ``meta`` device."""
    with torch.device("meta"):
        return cls(*args, **kwargs)


def load_weights(module: nn.Module, sd: Dict[str, torch.Tensor], device,
                 ignored: Tuple[str, ...] = (), what: str = "checkpoint") -> nn.Module:
    """Give a ``meta`` module storage on ``device`` and fill every parameter
    from ``sd``, cast to the parameter's dtype. Keys starting with one of
    ``ignored`` are skipped; any other missing or unexpected key raises
    ``KeyError`` naming it. The parameters do not require a gradient until a
    trainer asks (``requires_grad_(True)``)."""
    module = module.to_empty(device=device).requires_grad_(False)
    own = module.state_dict()
    keys = {k for k in sd if not k.startswith(ignored)}
    missing, unexpected = sorted(own.keys() - keys), sorted(keys - own.keys())
    if missing or unexpected:
        raise KeyError(f"{what}: missing keys {missing[:10]}{' ...' if len(missing) > 10 else ''}"
                       f", unexpected keys {unexpected[:10]}"
                       f"{' ...' if len(unexpected) > 10 else ''}")
    with torch.no_grad():
        for k, dst in own.items():
            src = sd[k]
            if tuple(src.shape) != tuple(dst.shape):
                raise ValueError(f"{what}: {k} is {tuple(src.shape)} in the checkpoint, "
                                 f"{tuple(dst.shape)} in the model")
            dst.copy_(src)
    return module.eval()


# ---------------------------------------------------------------------------
# the shape pipeline
# ---------------------------------------------------------------------------
def load_pipeline(cls, model_path: str, subfolder: str, variant: str = "fp16", device=None,
                  **kwargs):
    cfg_path, ckpt_path = smart_load_model(model_path, subfolder, variant)
    return load_pipeline_single_file(cls, ckpt_path, cfg_path, device=device, **kwargs)


def _params(config: dict, section: str) -> dict:
    return (config.get(section, {}) or {}).get("params", {}) or {}


def _target_cls(config: dict, section: str, default):
    """The class that ``config[section]["target"]`` names, or ``default``
    when the section names none."""
    from hunyuan3d2_tpu_torch.config import get_obj_from_str

    target = (config.get(section) or {}).get("target")
    return default if target is None else get_obj_from_str(str(target))


def resolve_dtype(dtype) -> torch.dtype:
    """The Linear weights' dtype a loader takes: bf16 (the port's policy,
    ops/nn.py) or fp32, named as the JAX loader names them (a torch or numpy
    dtype, or "bf16" / "bfloat16" / "fp32" / "f32" / "float32"). Any other
    raises ``ValueError``."""
    names = {"bf16": torch.bfloat16, "bfloat16": torch.bfloat16, "fp32": torch.float32,
             "f32": torch.float32, "float32": torch.float32}
    if isinstance(dtype, str):
        out = names.get(dtype)
    elif isinstance(dtype, torch.dtype):
        out = dtype
    else:
        try:
            out = names.get(np.dtype(dtype).name)
        except TypeError:
            out = None
    if out not in (torch.bfloat16, torch.float32):
        raise ValueError(f"dtype {dtype!r} is not supported: the port loads bf16 (its default) "
                         "or fp32 weights")
    return out


def load_pipeline_single_file(cls, ckpt_path: str, config_path: str, device=None,
                              dtype="bf16", **kwargs):
    """A shape pipeline from one multi-model checkpoint and its config.yaml,
    on ``device`` (``cuda`` unless the caller passes another). ``dtype``
    (:func:`resolve_dtype`) is the Linear weights' dtype: bf16, or fp32, in
    which every parameter is fp32 (as the JAX loader's ``dtype``)."""
    from hunyuan3d2_tpu_torch.models import clip_vit, dinov2
    from hunyuan3d2_tpu_torch.models import conditioner as cond_lib
    from hunyuan3d2_tpu_torch.models import dit as dit_lib
    from hunyuan3d2_tpu_torch.models import shapevae as vae_lib
    from hunyuan3d2_tpu_torch.pipelines import schedulers as sched_lib

    device = torch.device(device if device is not None else "cuda")
    dtype = resolve_dtype(dtype)

    def meta(build, *args):
        module = on_meta(build, *args)
        return module.float() if dtype == torch.float32 else module

    with open(config_path) as fh:
        config = yaml.safe_load(fh)
    towers = split_by_top_key(load_state_dict(ckpt_path))
    extra = sorted(set(towers) - set(IGNORED))
    if extra:
        raise KeyError(f"{ckpt_path}: unexpected top-level keys {extra}")

    mp = _params(config, "model")
    dit_cfg = dit_lib.DiTConfig(
        in_channels=mp.get("in_channels", 64), context_in_dim=mp.get("context_in_dim", 1536),
        hidden_size=mp.get("hidden_size", 1024), mlp_ratio=mp.get("mlp_ratio", 4.0),
        num_heads=mp.get("num_heads", 16), depth=mp.get("depth", 16),
        depth_single_blocks=mp.get("depth_single_blocks", 32),
        qkv_bias=mp.get("qkv_bias", True), guidance_embed=mp.get("guidance_embed", False))
    model = load_weights(meta(_target_cls(config, "model", dit_lib.Hunyuan3DDiT), dit_cfg),
                         towers.get("model", {}), device, IGNORED["model"], "model")

    vp = _params(config, "vae")
    vae_cfg = vae_lib.ShapeVAEConfig(
        num_latents=vp.get("num_latents", 512), embed_dim=vp.get("embed_dim", 64),
        width=vp.get("width", 1024), heads=vp.get("heads", 16),
        num_decoder_layers=vp.get("num_decoder_layers", 16), num_freqs=vp.get("num_freqs", 8),
        include_pi=vp.get("include_pi", False),
        scale_factor=vp.get("scale_factor", 1.0188137142395404),
        qkv_bias=vp.get("qkv_bias", False))
    vae = load_weights(meta(_target_cls(config, "vae", vae_lib.ShapeVAE), vae_cfg),
                       towers.get("vae", {}), device, IGNORED["vae"], "vae")

    cp = _params(config, "conditioner")
    cond_sd = towers.get("conditioner", {})
    main_spec = cp.get("main_image_encoder") or {}
    mk = main_spec.get("kwargs") or {}
    ec = mk.get("config") or {}
    if not ec.get("use_swiglu_ffn", True):
        raise NotImplementedError("the port's DINOv2 has the SwiGLU FFN only")
    # the FFN width as the checkpoint stores it (HF derives it from mlp_ratio)
    ffn = cond_sd.get("main_image_encoder.model.encoder.layer.0.mlp.weights_out.weight")
    dcfg = dinov2.DinoConfig(
        hidden_size=ec.get("hidden_size", 1536), num_layers=ec.get("num_hidden_layers", 40),
        num_heads=ec.get("num_attention_heads", 24), patch_size=ec.get("patch_size", 14),
        image_size=mk.get("image_size", 518),
        swiglu_hidden=dinov2.GIANT.swiglu_hidden if ffn is None else int(ffn.shape[1]))
    enc_cfg = cond_lib.DinoEncoderConfig(dino=dcfg, image_size=dcfg.image_size)
    target = str((config.get("conditioner") or {}).get("target", ""))
    mv = ("MV" in target or "MV" in str(main_spec.get("type", ""))
          or "mv" in str(config.get("name") or ""))
    main_cls = cond_lib.DinoImageEncoderMV if mv else cond_lib.DinoImageEncoder
    add_spec = cp.get("additional_image_encoder") or {}
    cond_cls = _target_cls(config, "conditioner", cond_lib.SingleImageEncoder)
    if cond_cls is cond_lib.DualImageEncoder or add_spec:
        ak = add_spec.get("kwargs") or {}
        ac = ak.get("config") or {}
        ccfg = clip_vit.CLIPVisionConfig(
            hidden_size=ac.get("hidden_size", 1024), num_layers=ac.get("num_hidden_layers", 24),
            num_heads=ac.get("num_attention_heads", 16), patch_size=ac.get("patch_size", 14),
            image_size=ak.get("image_size", 224),
            intermediate_size=ac.get("intermediate_size", 4096))
        conditioner = meta(lambda: cond_lib.DualImageEncoder(
            main_cls(enc_cfg), cond_lib.CLIPImageEncoder(ccfg)))
    else:
        conditioner = meta(lambda: cond_lib.SingleImageEncoder(main_cls(enc_cfg)))
    conditioner = load_weights(conditioner, cond_sd, device, IGNORED["conditioner"],
                               "conditioner")

    sched_cls = _target_cls(config, "scheduler", sched_lib.FlowMatchEulerDiscreteScheduler)
    scheduler = sched_cls(**{k: v for k, v in _params(config, "scheduler").items()
                             if k in sched_cls.__dataclass_fields__})
    return cls(vae=vae, model=model, scheduler=scheduler, conditioner=conditioner,
               device=device, **kwargs)


# ---------------------------------------------------------------------------
# the paint pipeline
# ---------------------------------------------------------------------------
def _paint_root(model_path: str, subfolder: str) -> str:
    """The directory holding ``unet/``: ``{model_path}/{subfolder}``, or
    ``model_path`` itself (the JAX loader's reading), locally, then under
    ``$HY3DGEN_MODELS``, then from the hub."""
    base = _models_root()
    for d in (os.path.join(model_path, subfolder), model_path,
              os.path.join(base, model_path, subfolder), os.path.join(base, model_path)):
        if os.path.isdir(os.path.join(d, "unet")):
            return d
    path = _hub_download(model_path, [f"{subfolder}/*"])
    return os.path.join(path, subfolder)


def _diffusers_part(root: str, part: str, names=("diffusion_pytorch_model.bin",
                                                  "diffusion_pytorch_model.safetensors")):
    """(config.json dict, state dict) of ``root/part``, the weights from the
    first of ``names`` that exists."""
    cfg_path = os.path.join(root, part, "config.json")
    config = {}
    if os.path.exists(cfg_path):
        with open(cfg_path) as fh:
            config = json.load(fh)
    for name in names:
        path = os.path.join(root, part, name)
        if os.path.exists(path):
            return config, load_state_dict(path)
    raise FileNotFoundError(f"no diffusion_pytorch_model.{{bin,safetensors}} in "
                            f"{os.path.join(root, part)}")


def _sd_vae(root: str, device, block_out_channels, scaling_factor: float, what: str,
            names=("diffusion_pytorch_model.bin", "diffusion_pytorch_model.safetensors")):
    """The SD VAE of ``root/vae``, its config from ``config.json`` with the
    given defaults."""
    from hunyuan3d2_tpu_torch.models import sd_vae

    vj, vae_sd = _diffusers_part(root, "vae", names)
    vcfg = sd_vae.SDVAEConfig(
        latent_channels=vj.get("latent_channels", 4),
        block_out_channels=tuple(vj.get("block_out_channels", block_out_channels)),
        layers_per_block=vj.get("layers_per_block", 2),
        scaling_factor=vj.get("scaling_factor", scaling_factor))
    return load_weights(on_meta(sd_vae.AutoencoderKL, vcfg), vae_sd, device, (), what)


def load_paint_pipeline(model_path: str, subfolder: str = "hunyuan3d-paint-v2-0-turbo",
                        view_size: int = 512, device=None):
    """The HunyuanPaint stack (2.5D UNet with its dual copy, SD VAE) from a
    diffusers-layout directory, on ``device`` (``cuda`` unless the caller
    passes another)."""
    from hunyuan3d2_tpu_torch.models import paint_unet
    from hunyuan3d2_tpu_torch.pipelines.hunyuanpaint import HunyuanPaintPipeline

    device = torch.device(device if device is not None else "cuda")
    root = _paint_root(model_path, subfolder)
    uj, unet_sd = _diffusers_part(root, "unet")
    ucfg = paint_unet.PaintUNetConfig(
        in_channels=12, out_channels=uj.get("out_channels", 4),
        block_out_channels=tuple(uj.get("block_out_channels", (320, 640, 1280, 1280))),
        layers_per_block=uj.get("layers_per_block", 2),
        cross_attention_dim=uj.get("cross_attention_dim", 1024), attention_head_dim=64,
        norm_num_groups=uj.get("norm_num_groups", 32))
    unet = load_weights(on_meta(paint_unet.UNet2p5D, ucfg), unet_sd, device, (), "unet")
    vae = _sd_vae(root, device, (128, 256, 512, 512), 0.18215, "paint vae")
    return HunyuanPaintPipeline(unet, vae, view_size=view_size, device=device)


# ---------------------------------------------------------------------------
# the text-to-image pipeline
# ---------------------------------------------------------------------------
SAFETENSORS_FIRST = ("diffusion_pytorch_model.safetensors", "diffusion_pytorch_model.bin")


def _t2i_text_encoder(root: str, dcfg, device):
    """``encode_text(prompt, negative) → (neg, pos)`` for a diffusers
    HunyuanDiT layout: ``text_encoder/`` is the Chinese-CLIP BertModel,
    ``text_encoder_2/`` the mT5 encoder, each state (clip [1, 77, 1024],
    clip_mask, t5 [1, 256, 2048], t5_mask) as float32 numpy arrays. None
    when either directory or ``transformers`` is missing."""
    te1, te2 = os.path.join(root, "text_encoder"), os.path.join(root, "text_encoder_2")
    if not (os.path.isdir(te1) and os.path.isdir(te2)):
        return None
    try:
        from transformers import AutoTokenizer, BertModel, T5EncoderModel
    except ImportError:
        return None
    bert = BertModel.from_pretrained(te1).to(device).eval()
    t5 = T5EncoderModel.from_pretrained(te2).to(device).eval()
    tk1 = AutoTokenizer.from_pretrained(os.path.join(root, "tokenizer"))
    tk2 = AutoTokenizer.from_pretrained(os.path.join(root, "tokenizer_2"))

    @torch.no_grad()
    def enc_one(text):
        b = tk1(text, padding="max_length", max_length=dcfg.text_len, truncation=True,
                return_tensors="pt").to(device)
        tb = tk2(text, padding="max_length", max_length=dcfg.t5_len, truncation=True,
                 return_tensors="pt").to(device)
        clip = bert(input_ids=b.input_ids, attention_mask=b.attention_mask).last_hidden_state
        t5s = t5(input_ids=tb.input_ids, attention_mask=tb.attention_mask).last_hidden_state
        return tuple(x.float().cpu().numpy() for x in (clip, b.attention_mask, t5s,
                                                       tb.attention_mask))

    def encode_text(prompt, negative_prompt):
        return enc_one(negative_prompt), enc_one(prompt)

    return encode_text


def _t2i_config(tj: dict):
    """The transformer config of a diffusers HunyuanDiT ``config.json``."""
    from hunyuan3d2_tpu_torch.models import hunyuan_dit

    depth = tj.get("num_layers", 40)
    nh = tj.get("num_attention_heads", 16)
    return dataclasses.replace(
        hunyuan_dit.FULL, hidden_size=tj.get("attention_head_dim", 88) * nh, num_heads=nh,
        depth=depth, in_channels=tj.get("in_channels", 4), mlp_ratio=tj.get("mlp_ratio", 4.0),
        text_dim=tj.get("cross_attention_dim", 1024), t5_dim=tj.get("cross_attention_dim_t5", 2048),
        text_len=tj.get("text_len", 77), t5_len=tj.get("text_len_t5", 256),
        pooled_dim=tj.get("pooled_projection_dim", 1024),
        # v1.1 / v1.2 checkpoints drop the style and image-meta conditioning
        use_style_meta=bool(tj.get("use_style_cond_and_image_meta_size", True)),
        # PAG layers past a shallow checkpoint's depth would be dead
        pag_layers=tuple(i for i in hunyuan_dit.FULL.pag_layers if i < depth))


def load_t2i_pipeline(cls, ckpt_path: str, device=None, **kwargs):
    """A diffusers HunyuanDiT directory → ``cls`` (the t2i pipeline) on
    ``device`` (``cuda`` unless the caller passes another). Without text
    encoders the pipeline conditions on pseudo-random embeddings and says so
    in a warning at each call."""
    from hunyuan3d2_tpu_torch.models import hunyuan_dit

    device = torch.device(device if device is not None else "cuda")
    tj, dit_sd = _diffusers_part(ckpt_path, "transformer", SAFETENSORS_FIRST)
    dcfg = _t2i_config(tj)
    transformer = load_weights(on_meta(hunyuan_dit.HunyuanDiT2DModel, dcfg), dit_sd, device, (),
                               "transformer")
    vae = _sd_vae(ckpt_path, device, (128, 256, 512, 512), 0.13025, "t2i vae",
                  SAFETENSORS_FIRST)
    if "encode_text" not in kwargs:   # loading the encoders is costly: only when needed
        kwargs["encode_text"] = _t2i_text_encoder(ckpt_path, dcfg, device)
    pipe = cls(transformer, vae, device=device, **kwargs)
    pipe.from_checkpoint = True
    return pipe


# ---------------------------------------------------------------------------
# the secondary image pipelines: delight, x4 upscale, align
# ---------------------------------------------------------------------------
def empty_prompt_embed(ckpt_path: str) -> np.ndarray:
    """[77, D] CLIP text hidden states of the "" prompt (the delight and
    upscale models' only prompt), computed once on the host through
    ``transformers`` CLIPTextModel from ``text_encoder/`` and
    ``tokenizer/``."""
    from transformers import CLIPTextModel, CLIPTokenizer

    tok = CLIPTokenizer.from_pretrained(os.path.join(ckpt_path, "tokenizer"))
    te = CLIPTextModel.from_pretrained(os.path.join(ckpt_path, "text_encoder"))
    ids = tok("", padding="max_length", max_length=tok.model_max_length,
              return_tensors="pt").input_ids
    with torch.no_grad():
        return te(ids)[0][0].float().numpy()


def _sd_unet_config(base, uj: dict, **overrides):
    """An SD-class UNet config from a diffusers ``config.json``. An int
    ``attention_head_dim`` is the SD1.5 convention's head count; a list
    (SD2.x-style configs) leaves the head size at 64."""
    head = uj.get("attention_head_dim", 8)
    return dataclasses.replace(
        base, in_channels=uj.get("in_channels", base.in_channels),
        block_out_channels=tuple(uj.get("block_out_channels", base.block_out_channels)),
        layers_per_block=uj.get("layers_per_block", base.layers_per_block),
        cross_attention_dim=uj.get("cross_attention_dim", base.cross_attention_dim),
        norm_num_groups=uj.get("norm_num_groups", base.norm_num_groups),
        num_heads=head if isinstance(head, int) else None, **overrides)


def load_delight_pipeline(cls, ckpt_path: str, device=None, **kwargs):
    """A diffusers InstructPix2Pix directory → ``cls`` (DelightPipeline) on
    ``device`` (``cuda`` unless the caller passes another)."""
    from hunyuan3d2_tpu_torch.models.paint_unet import plain_unet
    from hunyuan3d2_tpu_torch.pipelines.delight import IP2P_UNET

    device = torch.device(device if device is not None else "cuda")
    uj, unet_sd = _diffusers_part(ckpt_path, "unet", SAFETENSORS_FIRST)
    unet = load_weights(on_meta(plain_unet, _sd_unet_config(IP2P_UNET, uj)), unet_sd, device,
                        (), "delight unet")
    vae = _sd_vae(ckpt_path, device, (128, 256, 512, 512), 0.18215, "delight vae",
                  SAFETENSORS_FIRST)
    return cls(unet, vae, empty_prompt_embed(ckpt_path), device=device, **kwargs)


def load_upscale_pipeline(cls, ckpt_path: str, device=None, **kwargs):
    """A diffusers StableDiffusionUpscalePipeline directory → ``cls``
    (UpscalePipeline) on ``device``: ``down_block_types`` give the
    cross-attention flags, ``class_embed_type`` the class embedding,
    ``scheduler/`` the DDIM and ``low_res_scheduler/`` the low-res noising
    table."""
    from hunyuan3d2_tpu_torch.models.paint_unet import plain_unet
    from hunyuan3d2_tpu_torch.pipelines.paint_schedulers import (
        DDIMScheduler,
        alphas_cumprod_from_config,
    )
    from hunyuan3d2_tpu_torch.pipelines.upscale import X4_UNET

    device = torch.device(device if device is not None else "cuda")
    uj, unet_sd = _diffusers_part(ckpt_path, "unet", SAFETENSORS_FIRST)
    types = uj.get("down_block_types")
    ucfg = _sd_unet_config(
        X4_UNET, uj,
        down_cross=tuple("CrossAttn" in t for t in types) if types else X4_UNET.down_cross,
        class_embed_type="timestep" if uj.get("class_embed_type") == "timestep" else "table",
        num_class_embeds=uj.get("num_class_embeds") or 1000)
    unet = load_weights(on_meta(plain_unet, ucfg), unet_sd, device, (), "upscale unet")
    vae = _sd_vae(ckpt_path, device, (128, 256, 512), 0.08333, "upscale vae", SAFETENSORS_FIRST)
    for sub, key, build_fn in (("scheduler", "scheduler", DDIMScheduler.from_config),
                               ("low_res_scheduler", "low_res_alphas_cumprod",
                                alphas_cumprod_from_config)):
        path = os.path.join(ckpt_path, sub, "scheduler_config.json")
        if os.path.exists(path):
            with open(path) as fh:
                kwargs.setdefault(key, build_fn(json.load(fh)))
    return cls(unet, vae, empty_prompt_embed(ckpt_path), device=device, **kwargs)


def load_align_pipeline(cls, sd_path: str, controlnet_path: str, ip_adapter_path: str = None,
                        device=None, **kwargs):
    """An SD1.5 diffusers directory + a ControlNetModel directory (+ an
    IP-Adapter file, ``image_proj.*`` and ``ip_adapter.*``) → ``cls``
    (ControlNetSDPipeline) on ``device``. Without an IP-Adapter file the
    UNet gets the zero graft and a seed-0 ``PLUS_SD15`` resampler, which it
    then ignores; a file that is named and missing raises."""
    from hunyuan3d2_tpu_torch.models import controlnet as cn
    from hunyuan3d2_tpu_torch.models import ip_adapter as ipa
    from hunyuan3d2_tpu_torch.models.paint_unet import plain_unet
    from hunyuan3d2_tpu_torch.ops.nn import build
    from hunyuan3d2_tpu_torch.pipelines.align import SD15_UNET

    device = torch.device(device if device is not None else "cuda")
    names = SAFETENSORS_FIRST + ("diffusion_pytorch_model.fp16.safetensors",)
    uj, unet_sd = _diffusers_part(sd_path, "unet", names)
    ucfg = _sd_unet_config(SD15_UNET, uj)
    unet = load_weights(on_meta(plain_unet, ucfg), unet_sd, device, (), "align unet")
    _, ctrl_sd = _diffusers_part(controlnet_path, "", names)
    controlnet = load_weights(on_meta(cn.ControlNet, ucfg), ctrl_sd, device, (), "controlnet")
    vae = _sd_vae(sd_path, device, (128, 256, 512, 512), 0.18215, "align vae", names)
    if ip_adapter_path is not None:
        ip_sd = load_state_dict(ip_adapter_path)
        proj = {k[len("image_proj."):]: v for k, v in ip_sd.items()
                if k.startswith("image_proj.")}
        dim = int(proj["layers.0.0.to_q.weight"].shape[1])
        rcfg = dataclasses.replace(
            ipa.PLUS_SD15, dim=dim, heads=dim // ipa.PLUS_SD15.dim_head,
            depth=sum(k.endswith(".0.to_q.weight") for k in proj),
            num_queries=int(proj["latents"].shape[-2]),
            embedding_dim=int(proj["proj_in.weight"].shape[1]),
            output_dim=int(proj["proj_out.weight"].shape[0]),
            ff_mult=int(proj["layers.0.1.1.weight"].shape[0]) // dim)
        resampler = load_weights(on_meta(ipa.Resampler, rcfg), proj, device, (),
                                 "IP-Adapter image_proj")
        ipa.load_ip_adapter(unet, ip_sd)
    else:
        rcfg = dataclasses.replace(ipa.PLUS_SD15, output_dim=ucfg.cross_attention_dim)
        resampler = build(ipa.Resampler, rcfg, device=device)
        ipa.add_ip_adapter(unet, ucfg.cross_attention_dim)
    text = empty_prompt_embed(sd_path)
    return cls(unet, controlnet, vae, resampler, text, np.zeros_like(text), device=device,
               **kwargs)
