"""Carry JAX-package parameter trees into the port's state dicts.

The inverse of hunyuan3d2_tpu/io/checkpoints.py ``map_dit``, ``map_shapevae``
and ``map_dinov2``: per-layer leaves stacked along axis 0 are unstacked,
Linear kernels [in, out] are transposed to torch's [out, in], and every key
is the Hunyuan3D-2 checkpoint key. Input leaves are numpy arrays (any float
dtype, bf16 included); outputs are float32 numpy arrays, which
``load_state_dict`` casts to each parameter's dtype.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _f32(x) -> np.ndarray:
    return np.asarray(x).astype(np.float32)


def _lin(out: dict, key: str, p: dict, i=None):
    w = _f32(p["w"] if i is None else p["w"][i])
    out[key + ".weight"] = np.ascontiguousarray(w.T)
    if "b" in p:
        out[key + ".bias"] = _f32(p["b"] if i is None else p["b"][i])


def dit_state_dict(params: dict, cfg) -> Dict[str, np.ndarray]:
    """models/dit.py param tree → Hunyuan3DDiT state dict."""
    sd: Dict[str, np.ndarray] = {}
    _lin(sd, "latent_in", params["latent_in"])
    _lin(sd, "cond_in", params["cond_in"])
    for name in ("time_in", "guidance_in"):
        if name in params:
            _lin(sd, f"{name}.in_layer", params[name]["in_layer"])
            _lin(sd, f"{name}.out_layer", params[name]["out_layer"])
    _lin(sd, "final_layer.adaLN_modulation.1", params["final_layer"]["adaLN"])
    _lin(sd, "final_layer.linear", params["final_layer"]["linear"])
    d = params["double_blocks"]
    for i in range(cfg.depth):
        b = f"double_blocks.{i}"
        for s in ("img", "txt"):
            _lin(sd, f"{b}.{s}_mod.lin", d[f"{s}_mod"], i)
            _lin(sd, f"{b}.{s}_attn.qkv", d[f"{s}_qkv"], i)
            sd[f"{b}.{s}_attn.norm.query_norm.scale"] = _f32(d[f"{s}_q_scale"][i])
            sd[f"{b}.{s}_attn.norm.key_norm.scale"] = _f32(d[f"{s}_k_scale"][i])
            _lin(sd, f"{b}.{s}_attn.proj", d[f"{s}_proj"], i)
            _lin(sd, f"{b}.{s}_mlp.0", d[f"{s}_mlp_in"], i)
            _lin(sd, f"{b}.{s}_mlp.2", d[f"{s}_mlp_out"], i)
    s = params["single_blocks"]
    for i in range(cfg.depth_single_blocks):
        b = f"single_blocks.{i}"
        _lin(sd, f"{b}.modulation.lin", s["mod"], i)
        _lin(sd, f"{b}.linear1", s["linear1"], i)
        _lin(sd, f"{b}.linear2", s["linear2"], i)
        sd[f"{b}.norm.query_norm.scale"] = _f32(s["q_scale"][i])
        sd[f"{b}.norm.key_norm.scale"] = _f32(s["k_scale"][i])
    return sd


def shapevae_state_dict(params: dict, cfg) -> Dict[str, np.ndarray]:
    """models/shapevae.py param tree → ShapeVAE state dict."""
    sd: Dict[str, np.ndarray] = {}

    def ln(key, tree, name, i=None):
        for suffix, leaf in (("weight", "_scale"), ("bias", "_bias")):
            x = tree[name + leaf]
            sd[f"{key}.{suffix}"] = _f32(x if i is None else x[i])

    _lin(sd, "post_kl", params["post_kl"])
    t = params["transformer"]
    for i in range(cfg.num_decoder_layers):
        b = f"transformer.resblocks.{i}"
        ln(f"{b}.ln_1", t, "ln_1", i)
        _lin(sd, f"{b}.attn.c_qkv", t["c_qkv"], i)
        ln(f"{b}.attn.attention.q_norm", t, "q_norm", i)
        ln(f"{b}.attn.attention.k_norm", t, "k_norm", i)
        _lin(sd, f"{b}.attn.c_proj", t["c_proj"], i)
        ln(f"{b}.ln_2", t, "ln_2", i)
        _lin(sd, f"{b}.mlp.c_fc", t["mlp_fc"], i)
        _lin(sd, f"{b}.mlp.c_proj", t["mlp_proj"], i)
    g = params["geo_decoder"]
    c = "geo_decoder.cross_attn_decoder"
    _lin(sd, "geo_decoder.query_proj", g["query_proj"])
    for n in ("ln_1", "ln_2", "ln_3"):
        ln(f"{c}.{n}", g, n)
    _lin(sd, f"{c}.attn.c_q", g["c_q"])
    _lin(sd, f"{c}.attn.c_kv", g["c_kv"])
    ln(f"{c}.attn.attention.q_norm", g, "q_norm")
    ln(f"{c}.attn.attention.k_norm", g, "k_norm")
    _lin(sd, f"{c}.attn.c_proj", g["c_proj"])
    _lin(sd, f"{c}.mlp.c_fc", g["mlp_fc"])
    _lin(sd, f"{c}.mlp.c_proj", g["mlp_proj"])
    ln("geo_decoder.ln_post", g, "ln_post")
    _lin(sd, "geo_decoder.output_proj", g["output_proj"])
    return sd


def dinov2_state_dict(params: dict, cfg, prefix: str = "model.") -> Dict[str, np.ndarray]:
    """models/dinov2.py param tree → HF Dinov2Model state dict (keys under
    ``prefix``, the conditioner's ``model.``)."""
    sd: Dict[str, np.ndarray] = {}
    h, c, p = cfg.hidden_size, cfg.num_channels, cfg.patch_size
    sd["embeddings.cls_token"] = _f32(params["cls_token"])
    sd["embeddings.position_embeddings"] = _f32(params["pos_embed"])
    pw = _f32(params["patch_proj"]["w"])                         # [C*p*p, H]
    sd["embeddings.patch_embeddings.projection.weight"] = np.ascontiguousarray(
        pw.T.reshape(h, c, p, p))
    sd["embeddings.patch_embeddings.projection.bias"] = _f32(params["patch_proj"]["b"])
    ly = params["layers"]
    for i in range(cfg.num_layers):
        b = f"encoder.layer.{i}"
        sd[f"{b}.norm1.weight"] = _f32(ly["norm1_scale"][i])
        sd[f"{b}.norm1.bias"] = _f32(ly["norm1_bias"][i])
        for n, k in (("query", "q"), ("key", "k"), ("value", "v")):
            _lin(sd, f"{b}.attention.attention.{n}", ly[k], i)
        _lin(sd, f"{b}.attention.output.dense", ly["out"], i)
        sd[f"{b}.layer_scale1.lambda1"] = _f32(ly["ls1"][i])
        sd[f"{b}.norm2.weight"] = _f32(ly["norm2_scale"][i])
        sd[f"{b}.norm2.bias"] = _f32(ly["norm2_bias"][i])
        sd[f"{b}.layer_scale2.lambda1"] = _f32(ly["ls2"][i])
        _lin(sd, f"{b}.mlp.weights_in", ly["ffn_in"], i)   # SwiGLU FFN
        _lin(sd, f"{b}.mlp.weights_out", ly["ffn_out"], i)
    sd["layernorm.weight"] = _f32(params["final_norm_scale"])
    sd["layernorm.bias"] = _f32(params["final_norm_bias"])
    return {prefix + k: v for k, v in sd.items()}


def load_numpy_state_dict(module: torch.nn.Module, sd: Dict[str, np.ndarray]):
    """Strict ``load_state_dict`` from numpy arrays (each cast to its
    parameter's dtype and device)."""
    module.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()},
                           strict=True)
    return module
