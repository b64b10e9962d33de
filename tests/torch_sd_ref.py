"""Shared pieces of the port's parity tests for the secondary image
pipelines (tests/test_torch_{delight,upscale,align}.py): the plain SD-class
UNet in both packages with the same weights, the agreement measures, the
JAX draws of the loops, and the writers of the diffusers directories the
loader tests read (a config.json + safetensors per part, a tiny CLIP text
encoder and tokenizer).
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from hunyuan3d2_tpu.models import paint_unet as jpu
from hunyuan3d2_tpu_torch.io import convert
from hunyuan3d2_tpu_torch.models import paint_unet as tpu
from hunyuan3d2_tpu_torch.ops.nn import build


def one_thread(monkeypatch):
    """A fixture body: one torch intra-op thread a test (the suite runs
    several workers on the host's cores), and ``transformers`` kept off the
    hub and away from TensorFlow and Flax."""
    for var, value in (("USE_TF", "0"), ("USE_FLAX", "0"), ("HF_HUB_OFFLINE", "1"),
                       ("TRANSFORMERS_OFFLINE", "1")):
        monkeypatch.setenv(var, value)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_cfg(jcfg) -> tpu.PaintUNetConfig:
    return tpu.PaintUNetConfig(**dataclasses.asdict(jcfg))


def random_params(init_fn, *args, seed: int = 0):
    """A JAX param tree of ``init_fn(key, *args)``'s structure, filled by
    numpy from ``seed`` (compiling the JAX init of a TINY UNet takes
    ~15 s on a CPU; tracing its shapes well under one): each {"w", "b"} layer
    U(±1/sqrt(fan_in)), each {"scale", "bias"} norm 1 + 0.1·N and 0.1·N,
    other arrays 0.02·N (0.1·N for 2-D and larger ones). The ControlNet's
    zero convs come out non-zero, as its parity checks need."""
    shapes = jax.eval_shape(lambda k: init_fn(k, *args), jax.random.PRNGKey(0))
    rs = np.random.RandomState(seed)

    def arr(x, dtype):
        return np.asarray(x, np.float32).astype(dtype)

    def walk(t):
        if isinstance(t, list):
            return [walk(v) for v in t]
        if not isinstance(t, dict):
            scale = 0.1 if len(t.shape) >= 2 else 0.02
            return arr(rs.randn(*t.shape) * scale, t.dtype)
        if "w" in t and not isinstance(t["w"], (dict, list)):
            bound = 1.0 / np.sqrt(np.prod(t["w"].shape[:-1]))
            return {k: arr(rs.uniform(-bound, bound, v.shape), v.dtype) for k, v in t.items()}
        if set(t) == {"scale", "bias"}:
            return {"scale": arr(1 + 0.1 * rs.randn(*t["scale"].shape), t["scale"].dtype),
                    "bias": arr(0.1 * rs.randn(*t["bias"].shape), t["bias"].dtype)}
        return {k: walk(v) for k, v in t.items()}

    return walk(shapes)


def jax_unet(jcfg, seed: int = 0) -> dict:
    """A plain UNet's JAX params (no dual copy), seeded by numpy."""
    return random_params(jpu.init, jcfg, False, seed=seed)


jax_unet_apply = jax.jit(jpu.unet_apply, static_argnames=("cfg", "mode", "num_views"))


def unet_apply(params, cfg, sample, t, context, class_labels=None, **kw):
    """The JAX package's unet_apply, compiled ('r' mode, one view)."""
    return jax_unet_apply(params, cfg=cfg, sample=sample, t=t, context=context,
                          class_labels=class_labels, mode="r", num_views=1, cache={}, **kw)


def port_unet(params: dict, jcfg) -> tpu.UNetCore:
    """The port's plain UNet holding ``params``; zero ``to_k_ip`` /
    ``to_v_ip`` are grafted first where the params carry them."""
    from hunyuan3d2_tpu_torch.models.ip_adapter import add_ip_adapter

    module = build(tpu.plain_unet, port_cfg(jcfg), device="cpu")
    if "to_k_ip" in params["mid"]["attn"]["block"]["attn2"]:
        add_ip_adapter(module, jcfg.cross_attention_dim)
    return convert.load_numpy_state_dict(module, convert.unet_core_state_dict(params))


def fill(tree, key: str, rs, scale: float = 0.1):
    """Seeded non-zero values for every ``key`` leaf dict ({"w", "b"}) found
    in ``tree``, in place: the zero-initialised branches would make a
    parity check pass whatever the branch computes. The values are bf16, as
    the JAX loader maps a checkpoint's (and as the port holds them)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            if k == key and isinstance(v, dict):
                for n in v:
                    v[n] = (rs.randn(*np.shape(v[n])) * scale).astype(jnp.bfloat16)
            else:
                fill(v, key, rs, scale)
    elif isinstance(tree, list):
        for v in tree:
            fill(v, key, rs, scale)
    return tree


def to_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.array(jnp.asarray(x, jnp.float32))


def assert_bf16_close(out, ref):
    """bf16 paths: within 5 % of the output scale, correlation ≥ 0.999."""
    out, ref = to_np(out), to_np(ref)
    assert out.shape == ref.shape
    assert np.abs(out - ref).max() <= 0.05 * np.abs(ref).max(), \
        np.abs(out - ref).max() / np.abs(ref).max()
    assert np.corrcoef(out.ravel(), ref.ravel())[0, 1] >= 0.999


def assert_fp32_close(out, ref):
    """fp32 paths: within 1e-4 of the output scale."""
    out, ref = to_np(out), to_np(ref)
    assert out.shape == ref.shape
    assert np.abs(out - ref).max() <= 1e-4 * max(1.0, np.abs(ref).max()), \
        np.abs(out - ref).max()


def image_agreement(a, b):
    """(correlation, mean |Δ| in 0-255 levels) of two images, PIL or
    arrays in [0, 1]."""
    x, y = (np.asarray(i, np.float64) * (255.0 if np.asarray(i).dtype != np.uint8 else 1.0)
            for i in (a, b))
    assert x.shape == y.shape
    assert x.std() > 1.0, "a flat image says nothing"
    return np.corrcoef(x.ravel(), y.ravel())[0, 1], np.abs(x - y).mean()


def normal(key, shape) -> np.ndarray:
    return np.asarray(jax.random.normal(key, shape, jnp.float32))


def write_part(root, part: str, sd: dict, config: dict, name="diffusion_pytorch_model.safetensors"):
    """``root/part/config.json`` and the safetensors file of ``sd``."""
    import safetensors.numpy

    d = os.path.join(str(root), part)
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "config.json"), "w") as fh:
        json.dump(config, fh)
    safetensors.numpy.save_file({k: np.ascontiguousarray(v, np.float32) for k, v in sd.items()},
                                os.path.join(d, name))


def unet_config_json(jcfg, head) -> dict:
    """A diffusers UNet2DConditionModel config.json of ``jcfg``;
    ``head`` is its attention_head_dim (an int head count or a list)."""
    return {"in_channels": jcfg.in_channels, "out_channels": jcfg.out_channels,
            "block_out_channels": list(jcfg.block_out_channels),
            "layers_per_block": jcfg.layers_per_block,
            "cross_attention_dim": jcfg.cross_attention_dim,
            "norm_num_groups": jcfg.norm_num_groups, "attention_head_dim": head}


def plain_unet_sd(jparams) -> dict:
    """export_unet_core's diffusers dict without the paint UNet's learned
    text embeddings, which a plain SD checkpoint does not hold."""
    from hunyuan3d2_tpu.io import diffusers_maps as dm

    sd = dm.export_unet_core(jparams, prefix="", extras=False)
    return {k: v for k, v in sd.items() if not k.startswith("learned_text")}


def write_vae(root, jvae_params, vcfg):
    from hunyuan3d2_tpu.io import diffusers_maps as dm

    write_part(root, "vae", dm.export_sd_vae(jax.tree.map(np.asarray, jvae_params)), {
        "block_out_channels": list(vcfg.block_out_channels),
        "layers_per_block": vcfg.layers_per_block, "latent_channels": vcfg.latent_channels,
        "scaling_factor": vcfg.scaling_factor})


def write_clip_text(root, dim: int):
    """A tiny CLIP text encoder (``text_encoder/``) and BPE tokenizer
    (``tokenizer/``) of hidden size ``dim``, written through
    ``transformers``."""
    import transformers as tf

    tok_dir = os.path.join(str(root), "tokenizer")
    os.makedirs(tok_dir, exist_ok=True)
    vocab = {"<|startoftext|>": 0, "<|endoftext|>": 1, "!": 2}
    for c in "abcdefghijklmnopqrstuvwxyz":
        vocab[c] = len(vocab)
        vocab[c + "</w>"] = len(vocab)
    with open(os.path.join(tok_dir, "vocab.json"), "w") as fh:
        json.dump(vocab, fh)
    with open(os.path.join(tok_dir, "merges.txt"), "w") as fh:
        fh.write("#version: 0.2\n")
    tf.CLIPTokenizer(os.path.join(tok_dir, "vocab.json"), os.path.join(tok_dir, "merges.txt"),
                     model_max_length=77).save_pretrained(tok_dir)
    torch.manual_seed(0)
    tf.CLIPTextModel(tf.CLIPTextConfig(
        vocab_size=len(vocab), hidden_size=dim, intermediate_size=2 * dim, num_hidden_layers=1,
        num_attention_heads=2, max_position_embeddings=77, bos_token_id=0, eos_token_id=1,
        pad_token_id=1)).save_pretrained(os.path.join(str(root), "text_encoder"))


def assert_same_weights(module: torch.nn.Module, sd: dict):
    """Every tensor of ``module`` equals the converted JAX leaf of the same
    key, both rounded to the module's dtype."""
    own = module.state_dict()
    assert set(own) == set(sd), sorted(set(own) ^ set(sd))[:10]
    for k, v in own.items():
        ref = torch.from_numpy(np.ascontiguousarray(sd[k])).to(v.dtype)
        assert torch.equal(v.cpu(), ref), k
