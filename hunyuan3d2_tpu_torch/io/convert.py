"""Carry JAX-package parameter trees into the port's state dicts.

The inverse of hunyuan3d2_tpu/io/checkpoints.py ``map_dit``, ``map_shapevae``,
``map_dinov2`` and ``map_clip_vit``: per-layer leaves stacked along axis 0 are unstacked,
Linear kernels [in, out] are transposed to torch's [out, in], and every key
is the Hunyuan3D-2 checkpoint key. The paint UNet and the SD VAE go to the
diffusers keys that hunyuan3d2_tpu/io/diffusers_maps.py ``export_paint_unet``
and ``export_sd_vae`` write, with conv kernels HWIO → [out, in, kh, kw].
HunyuanDiT goes to the diffusers ``HunyuanDiT2DModel`` keys that
``map_hunyuan_dit`` reads: the stacked ``blocks`` and ``skip_blocks`` become
``blocks.0 .. blocks.{depth-1}``, the flattened patch kernel the patch conv.
The plain SD-class UNets (delight, x4 upscale, align) go to the
UNet2DConditionModel keys, a ControlNet to the ControlNetModel keys that
``export_controlnet`` writes, and an IP-Adapter (resampler and grafted
``to_k_ip`` / ``to_v_ip``) to its checkpoint's ``image_proj.*`` /
``ip_adapter.{1,3,5,…}`` keys, as ``export_ip_adapter`` writes them.
Input leaves are numpy arrays (any float dtype, bf16 included); outputs are
float32 numpy arrays, which
``load_state_dict`` casts to each parameter's dtype.

The other way, :func:`dit_tree`, :func:`shapevae_tree` and
:func:`dinov2_tree` take a module's state dict to the JAX package's tree
(the inverse of ``dit_state_dict``, ``shapevae_state_dict`` and
``dinov2_state_dict``; the same trees as its ``map_dit``, ``map_shapevae``
and ``map_dinov2`` build): per-layer leaves stacked on a leading axis,
Linear weights as [in, out], float32 numpy leaves.
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
        ffn_in, ffn_out = (("weights_in", "weights_out") if cfg.use_swiglu_ffn  # SwiGLU
                           else ("fc1", "fc2"))                                 # plain MLP
        _lin(sd, f"{b}.mlp.{ffn_in}", ly["ffn_in"], i)
        _lin(sd, f"{b}.mlp.{ffn_out}", ly["ffn_out"], i)
    sd["layernorm.weight"] = _f32(params["final_norm_scale"])
    sd["layernorm.bias"] = _f32(params["final_norm_bias"])
    return {prefix + k: v for k, v in sd.items()}


def _t(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return _f32(x)


def _tree_lin(sd: dict, key: str) -> dict:
    p = {"w": np.ascontiguousarray(_t(sd[key + ".weight"]).T)}
    if key + ".bias" in sd:
        p["b"] = _t(sd[key + ".bias"])
    return p


def _stack(layers: list) -> dict:
    """[{name: leaf or {w, b}}] per layer → {name: stacked leaf}."""
    return {k: _stack([ly[k] for ly in layers]) if isinstance(v, dict)
            else np.stack([ly[k] for ly in layers]) for k, v in layers[0].items()}


def dit_tree(sd: dict, cfg) -> dict:
    """Hunyuan3DDiT state dict → models/dit.py param tree."""
    params = {
        "latent_in": _tree_lin(sd, "latent_in"),
        "cond_in": _tree_lin(sd, "cond_in"),
        "time_in": {"in_layer": _tree_lin(sd, "time_in.in_layer"),
                    "out_layer": _tree_lin(sd, "time_in.out_layer")},
        "final_layer": {"adaLN": _tree_lin(sd, "final_layer.adaLN_modulation.1"),
                        "linear": _tree_lin(sd, "final_layer.linear")},
    }
    if cfg.guidance_embed:
        params["guidance_in"] = {"in_layer": _tree_lin(sd, "guidance_in.in_layer"),
                                 "out_layer": _tree_lin(sd, "guidance_in.out_layer")}
    double = []
    for i in range(cfg.depth):
        b = f"double_blocks.{i}"
        ly = {}
        for s in ("img", "txt"):
            ly[f"{s}_mod"] = _tree_lin(sd, f"{b}.{s}_mod.lin")
            ly[f"{s}_qkv"] = _tree_lin(sd, f"{b}.{s}_attn.qkv")
            ly[f"{s}_q_scale"] = _t(sd[f"{b}.{s}_attn.norm.query_norm.scale"])
            ly[f"{s}_k_scale"] = _t(sd[f"{b}.{s}_attn.norm.key_norm.scale"])
            ly[f"{s}_proj"] = _tree_lin(sd, f"{b}.{s}_attn.proj")
            ly[f"{s}_mlp_in"] = _tree_lin(sd, f"{b}.{s}_mlp.0")
            ly[f"{s}_mlp_out"] = _tree_lin(sd, f"{b}.{s}_mlp.2")
        double.append(ly)
    params["double_blocks"] = _stack(double)
    params["single_blocks"] = _stack([{
        "mod": _tree_lin(sd, f"single_blocks.{i}.modulation.lin"),
        "linear1": _tree_lin(sd, f"single_blocks.{i}.linear1"),
        "linear2": _tree_lin(sd, f"single_blocks.{i}.linear2"),
        "q_scale": _t(sd[f"single_blocks.{i}.norm.query_norm.scale"]),
        "k_scale": _t(sd[f"single_blocks.{i}.norm.key_norm.scale"]),
    } for i in range(cfg.depth_single_blocks)])
    return params


def shapevae_tree(sd: dict, cfg) -> dict:
    """ShapeVAE state dict → models/shapevae.py param tree."""
    def ln(out, name, key):
        out[name + "_scale"] = _t(sd[key + ".weight"])
        out[name + "_bias"] = _t(sd[key + ".bias"])

    blocks = []
    for i in range(cfg.num_decoder_layers):
        b = f"transformer.resblocks.{i}"
        ly = {"c_qkv": _tree_lin(sd, f"{b}.attn.c_qkv"),
              "c_proj": _tree_lin(sd, f"{b}.attn.c_proj"),
              "mlp_fc": _tree_lin(sd, f"{b}.mlp.c_fc"),
              "mlp_proj": _tree_lin(sd, f"{b}.mlp.c_proj")}
        for name, key in (("ln_1", "ln_1"), ("ln_2", "ln_2"), ("q_norm", "attn.attention.q_norm"),
                          ("k_norm", "attn.attention.k_norm")):
            ln(ly, name, f"{b}.{key}")
        blocks.append(ly)
    c = "geo_decoder.cross_attn_decoder"
    g = {"query_proj": _tree_lin(sd, "geo_decoder.query_proj"),
         "c_q": _tree_lin(sd, f"{c}.attn.c_q"), "c_kv": _tree_lin(sd, f"{c}.attn.c_kv"),
         "c_proj": _tree_lin(sd, f"{c}.attn.c_proj"), "mlp_fc": _tree_lin(sd, f"{c}.mlp.c_fc"),
         "mlp_proj": _tree_lin(sd, f"{c}.mlp.c_proj"),
         "output_proj": _tree_lin(sd, "geo_decoder.output_proj")}
    for name in ("ln_1", "ln_2", "ln_3"):
        ln(g, name, f"{c}.{name}")
    ln(g, "q_norm", f"{c}.attn.attention.q_norm")
    ln(g, "k_norm", f"{c}.attn.attention.k_norm")
    ln(g, "ln_post", "geo_decoder.ln_post")
    return {"post_kl": _tree_lin(sd, "post_kl"), "transformer": _stack(blocks), "geo_decoder": g}


def dinov2_tree(sd: dict, cfg, prefix: str = "") -> dict:
    """Dinov2Model state dict (keys under ``prefix``) → models/dinov2.py
    param tree (SwiGLU FFN)."""
    def g(k):
        return _t(sd[prefix + k])

    def lin(k):
        return {"w": np.ascontiguousarray(g(k + ".weight").T), "b": g(k + ".bias")}

    conv = g("embeddings.patch_embeddings.projection.weight")     # [H, C, p, p]
    layers = []
    for i in range(cfg.num_layers):
        b = f"encoder.layer.{i}"
        layers.append({
            "norm1_scale": g(f"{b}.norm1.weight"), "norm1_bias": g(f"{b}.norm1.bias"),
            "q": lin(f"{b}.attention.attention.query"), "k": lin(f"{b}.attention.attention.key"),
            "v": lin(f"{b}.attention.attention.value"),
            "out": lin(f"{b}.attention.output.dense"),
            "ls1": g(f"{b}.layer_scale1.lambda1"),
            "norm2_scale": g(f"{b}.norm2.weight"), "norm2_bias": g(f"{b}.norm2.bias"),
            "ls2": g(f"{b}.layer_scale2.lambda1"),
            "ffn_in": lin(f"{b}.mlp.weights_in"), "ffn_out": lin(f"{b}.mlp.weights_out"),
        })
    return {
        "cls_token": g("embeddings.cls_token"),
        "pos_embed": g("embeddings.position_embeddings"),
        "patch_proj": {"w": np.ascontiguousarray(conv.reshape(conv.shape[0], -1).T),
                       "b": g("embeddings.patch_embeddings.projection.bias")},
        "layers": _stack(layers),
        "final_norm_scale": g("layernorm.weight"),
        "final_norm_bias": g("layernorm.bias"),
    }


def clip_vit_state_dict(params: dict, cfg, prefix: str = "model.") -> Dict[str, np.ndarray]:
    """models/clip_vit.py param tree → HF CLIPVisionModel state dict (keys
    under ``prefix`` + ``vision_model.``, the encoder's ``model.``)."""
    sd: Dict[str, np.ndarray] = {}
    h, p = cfg.hidden_size, cfg.patch_size
    sd["embeddings.class_embedding"] = _f32(params["class_embedding"])
    pw = _f32(params["patch_proj"]["w"])                         # [3*p*p, H]
    sd["embeddings.patch_embedding.weight"] = np.ascontiguousarray(pw.T.reshape(h, 3, p, p))
    sd["embeddings.position_embedding.weight"] = _f32(params["pos_embed"])
    sd["pre_layrnorm.weight"] = _f32(params["pre_ln_scale"])
    sd["pre_layrnorm.bias"] = _f32(params["pre_ln_bias"])
    ly = params["layers"]
    for i in range(cfg.num_layers):
        b = f"encoder.layers.{i}"
        for n in ("1", "2"):
            sd[f"{b}.layer_norm{n}.weight"] = _f32(ly[f"ln{n}_scale"][i])
            sd[f"{b}.layer_norm{n}.bias"] = _f32(ly[f"ln{n}_bias"][i])
        for n, k in (("q_proj", "q"), ("k_proj", "k"), ("v_proj", "v"), ("out_proj", "out")):
            _lin(sd, f"{b}.self_attn.{n}", ly[k], i)
        _lin(sd, f"{b}.mlp.fc1", ly["fc1"], i)
        _lin(sd, f"{b}.mlp.fc2", ly["fc2"], i)
    return {prefix + "vision_model." + k: v for k, v in sd.items()}


def _conv(out: dict, key: str, p: dict):
    out[key + ".weight"] = np.ascontiguousarray(_f32(p["w"]).transpose(3, 2, 0, 1))
    out[key + ".bias"] = _f32(p["b"])


def _norm(out: dict, key: str, p: dict):
    out[key + ".weight"] = _f32(p["scale"])
    out[key + ".bias"] = _f32(p["bias"])


def _resnet(out: dict, key: str, p: dict):
    _norm(out, f"{key}.norm1", p["norm1"])
    _conv(out, f"{key}.conv1", p["conv1"])
    _norm(out, f"{key}.norm2", p["norm2"])
    _conv(out, f"{key}.conv2", p["conv2"])
    if "time_emb_proj" in p:
        _lin(out, f"{key}.time_emb_proj", p["time_emb_proj"])
    if "shortcut" in p:
        _conv(out, f"{key}.conv_shortcut", p["shortcut"])


def _attn(out: dict, key: str, p: dict):
    for n in ("to_q", "to_k", "to_v", "to_k_ip", "to_v_ip"):
        if n in p:
            _lin(out, f"{key}.{n}", p[n])
    _lin(out, f"{key}.to_out.0", p["to_out"])


def _transformer2d(out: dict, key: str, p: dict, wrapped: bool):
    _norm(out, f"{key}.norm", p["norm"])
    _lin(out, f"{key}.proj_in", p["proj_in"])
    blk, tb = p["block"], f"{key}.transformer_blocks.0"
    base = f"{tb}.transformer" if wrapped else tb
    for n in ("norm1", "norm2", "norm3"):
        _norm(out, f"{base}.{n}", blk[n])
    _attn(out, f"{base}.attn1", blk["attn1"])
    _attn(out, f"{base}.attn2", blk["attn2"])
    _lin(out, f"{base}.ff.net.0.proj", blk["ff_in"])
    _lin(out, f"{base}.ff.net.2", blk["ff_out"])
    for n in ("attn_refview", "attn_multiview"):
        if n in blk:
            _attn(out, f"{tb}.{n}", blk[n])
    _lin(out, f"{key}.proj_out", p["proj_out"])


def _trunk(sd: dict, params: dict, wrapped: bool, up: bool):
    """conv_in, the time MLP, the down blocks and the mid block (and the up
    blocks with ``up``): what a UNet and a ControlNet share."""
    _conv(sd, "conv_in", params["conv_in"])
    _lin(sd, "time_embedding.linear_1", params["time_mlp_in"])
    _lin(sd, "time_embedding.linear_2", params["time_mlp_out"])
    parts = [("down", params["down"], "downsample")]
    if up:
        parts.append(("up", params["up"], "upsample"))
    for tag, blocks, sampler in parts:
        for i, blk in enumerate(blocks):
            for j, r in enumerate(blk["resnets"]):
                _resnet(sd, f"{tag}_blocks.{i}.resnets.{j}", r)
            for j, a in enumerate(blk["attns"]):
                _transformer2d(sd, f"{tag}_blocks.{i}.attentions.{j}", a, wrapped)
            if sampler in blk:
                _conv(sd, f"{tag}_blocks.{i}.{sampler}rs.0.conv", blk[sampler])
    _resnet(sd, "mid_block.resnets.0", params["mid"]["res1"])
    _transformer2d(sd, "mid_block.attentions.0", params["mid"]["attn"], wrapped)
    _resnet(sd, "mid_block.resnets.1", params["mid"]["res2"])


def _unet_core(params: dict, prefix: str, wrapped: bool,
               learned_text: bool = True) -> Dict[str, np.ndarray]:
    sd: Dict[str, np.ndarray] = {}
    _trunk(sd, params, wrapped, up=True)
    if "class_embedding" in params:
        sd["class_embedding.weight"] = _f32(params["class_embedding"])
    if "class_mlp_in" in params:   # class_embed_type "timestep"
        _lin(sd, "class_embedding.linear_1", params["class_mlp_in"])
        _lin(sd, "class_embedding.linear_2", params["class_mlp_out"])
    if learned_text:
        sd["learned_text_clip_gen"] = _f32(params["learned_text_clip_gen"])
        sd["learned_text_clip_ref"] = _f32(params["learned_text_clip_ref"])
    _norm(sd, "conv_norm_out", params["norm_out"])
    _conv(sd, "conv_out", params["conv_out"])
    return {prefix + k: v for k, v in sd.items()}


def unet_core_state_dict(params: dict) -> Dict[str, np.ndarray]:
    """A plain SD-class UNet's param tree (models/paint_unet.py ``init``
    without its dual copy, any class embedding, ``to_k_ip`` / ``to_v_ip``
    where grafted) → UNet2DConditionModel state dict, for
    ``UNetCore(cfg, extras=False, learned_text=False)``. The paint UNet's
    learned text embeddings, which a plain checkpoint lacks, are left
    out."""
    return _unet_core(params, "", wrapped=False, learned_text=False)


def controlnet_state_dict(params: dict) -> Dict[str, np.ndarray]:
    """models/controlnet.py param tree → ControlNetModel state dict."""
    sd: Dict[str, np.ndarray] = {}
    _trunk(sd, params, wrapped=False, up=False)
    ce = params["cond_embed"]
    _conv(sd, "controlnet_cond_embedding.conv_in", ce["conv_in"])
    for i, b in enumerate(ce["blocks"]):
        _conv(sd, f"controlnet_cond_embedding.blocks.{i}", b)
    _conv(sd, "controlnet_cond_embedding.conv_out", ce["conv_out"])
    for i, zc in enumerate(params["ctrl_down"]):
        _conv(sd, f"controlnet_down_blocks.{i}", zc)
    _conv(sd, "controlnet_mid_block", params["ctrl_mid"])
    return sd


def resampler_state_dict(params: dict, prefix: str = "image_proj.") -> Dict[str, np.ndarray]:
    """models/ip_adapter.py resampler tree → the IP-Adapter checkpoint's
    ``image_proj.*`` keys (``latents`` as [1, Q, D])."""
    sd: Dict[str, np.ndarray] = {"latents": _f32(params["latents"])[None]}
    _lin(sd, "proj_in", params["proj_in"])
    _lin(sd, "proj_out", params["proj_out"])
    _norm(sd, "norm_out", params["norm_out"])
    for i, lp in enumerate(params["layers"]):
        _norm(sd, f"layers.{i}.0.norm1", lp["norm1"])
        _norm(sd, f"layers.{i}.0.norm2", lp["norm2"])
        for n in ("to_q", "to_kv", "to_out"):
            _lin(sd, f"layers.{i}.0.{n}", lp[n])
        _norm(sd, f"layers.{i}.1.0", lp["ff_norm"])
        _lin(sd, f"layers.{i}.1.1", lp["ff_in"])
        _lin(sd, f"layers.{i}.1.3", lp["ff_out"])
    return {prefix + k: v for k, v in sd.items()}


def ip_adapter_state_dict(unet_params: dict, resampler_params: dict) -> Dict[str, np.ndarray]:
    """(UNet tree with ``to_k_ip`` / ``to_v_ip``, resampler tree) → the
    IP-Adapter checkpoint: ``image_proj.*`` and
    ``ip_adapter.{1,3,5,…}.to_{k,v}_ip.weight`` numbered in the JAX graft
    order (diffusers' processor order: all down blocks, all up blocks, then
    mid)."""
    sd = resampler_state_dict(resampler_params)
    order = [t["block"]["attn2"] for part in ("down", "up")
             for blk in unet_params[part] for t in blk["attns"]]
    order.append(unet_params["mid"]["attn"]["block"]["attn2"])
    for i, a in enumerate(order):
        _lin(sd, f"ip_adapter.{2 * i + 1}.to_k_ip", a["to_k_ip"])
        _lin(sd, f"ip_adapter.{2 * i + 1}.to_v_ip", a["to_v_ip"])
    return sd


def image_proj_state_dict(params: dict, prefix: str = "image_proj.") -> Dict[str, np.ndarray]:
    """The plain IP-Adapter's projection tree → ``image_proj.proj`` /
    ``image_proj.norm`` keys."""
    sd: Dict[str, np.ndarray] = {}
    _lin(sd, "proj", params["proj"])
    _norm(sd, "norm", params["norm"])
    return {prefix + k: v for k, v in sd.items()}


def paint_unet_state_dict(params: dict) -> Dict[str, np.ndarray]:
    """models/paint_unet.py param tree → UNet2p5D state dict (``unet.*`` and,
    with a dual copy, ``unet_dual.*``)."""
    sd = _unet_core(params, "unet.", wrapped=True)
    if "dual" in params:
        sd.update(_unet_core(params["dual"], "unet_dual.", wrapped=False))
    return sd


def sd_vae_state_dict(params: dict) -> Dict[str, np.ndarray]:
    """models/sd_vae.py param tree → AutoencoderKL state dict."""
    sd: Dict[str, np.ndarray] = {}
    enc, dec = params["encoder"], params["decoder"]

    def mid(key, m):
        _resnet(sd, f"{key}.mid_block.resnets.0", m["res1"])
        a = m["attn"]
        _norm(sd, f"{key}.mid_block.attentions.0.group_norm", a["norm"])
        for n in ("q", "k", "v"):
            _lin(sd, f"{key}.mid_block.attentions.0.to_{n}", a[n])
        _lin(sd, f"{key}.mid_block.attentions.0.to_out.0", a["out"])
        _resnet(sd, f"{key}.mid_block.resnets.1", m["res2"])

    _conv(sd, "encoder.conv_in", enc["conv_in"])
    for i, blk in enumerate(enc["down"]):
        for j, r in enumerate(blk["resnets"]):
            _resnet(sd, f"encoder.down_blocks.{i}.resnets.{j}", r)
        if "downsample" in blk:
            _conv(sd, f"encoder.down_blocks.{i}.downsamplers.0.conv", blk["downsample"])
    mid("encoder", enc["mid"])
    _norm(sd, "encoder.conv_norm_out", enc["norm_out"])
    _conv(sd, "encoder.conv_out", enc["conv_out"])
    _conv(sd, "quant_conv", enc["quant_conv"])
    _conv(sd, "post_quant_conv", dec["post_quant_conv"])
    _conv(sd, "decoder.conv_in", dec["conv_in"])
    mid("decoder", dec["mid"])
    for i, blk in enumerate(dec["up"]):
        for j, r in enumerate(blk["resnets"]):
            _resnet(sd, f"decoder.up_blocks.{i}.resnets.{j}", r)
        if "upsample" in blk:
            _conv(sd, f"decoder.up_blocks.{i}.upsamplers.0.conv", blk["upsample"])
    _norm(sd, "decoder.conv_norm_out", dec["norm_out"])
    _conv(sd, "decoder.conv_out", dec["conv_out"])
    return sd


def _hdit_attn(out: dict, key: str, p: dict, i: int):
    for n, k in (("to_q", "q"), ("to_k", "k"), ("to_v", "v"), ("to_out.0", "out")):
        _lin(out, f"{key}.{n}", p[k], i)
    for n in ("q", "k"):
        out[f"{key}.norm_{n}.weight"] = _f32(p[f"{n}_norm_scale"][i])
        out[f"{key}.norm_{n}.bias"] = _f32(p[f"{n}_norm_bias"][i])


def hunyuan_dit_state_dict(params: dict, cfg) -> Dict[str, np.ndarray]:
    """models/hunyuan_dit.py param tree → HunyuanDiT2DModel state dict."""
    sd: Dict[str, np.ndarray] = {}
    h, ps, c = cfg.hidden_size, cfg.patch_size, cfg.in_channels
    # the patch linear [(p_row, p_col, C), h] is the conv [h, C, p_row, p_col]
    w = _f32(params["patch_embed"]["w"]).reshape(ps, ps, c, h)
    sd["pos_embed.proj.weight"] = np.ascontiguousarray(w.transpose(3, 2, 0, 1))
    sd["pos_embed.proj.bias"] = _f32(params["patch_embed"]["b"])
    _lin(sd, "text_embedder.linear_1", params["text_embedder"]["fc1"])
    _lin(sd, "text_embedder.linear_2", params["text_embedder"]["fc2"])
    sd["text_embedding_padding"] = _f32(params["text_embedding_padding"])
    te = "time_extra_emb"
    for name in ("timestep_embedder", "extra_embedder"):
        _lin(sd, f"{te}.{name}.linear_1", params[name]["in_layer"])
        _lin(sd, f"{te}.{name}.linear_2", params[name]["out_layer"])
    pool = params["pooler"]
    sd[f"{te}.pooler.positional_embedding"] = _f32(pool["pos"])
    for n, k in (("q_proj", "q"), ("k_proj", "k"), ("v_proj", "v"), ("c_proj", "out")):
        _lin(sd, f"{te}.pooler.{n}", pool[k])
    if "style_embedder" in params:
        sd[f"{te}.style_embedder.weight"] = _f32(params["style_embedder"])
    _lin(sd, "norm_out.linear", params["norm_out"]["linear"])
    _lin(sd, "proj_out", params["proj_out"])
    for tree, n, first in ((params["blocks"], cfg.n_pre, 0),
                           (params["skip_blocks"], cfg.n_skip, cfg.n_pre)):
        for i in range(n):
            b = f"blocks.{first + i}"
            sd[f"{b}.norm1.norm.weight"] = _f32(tree["norm1_scale"][i])
            sd[f"{b}.norm1.norm.bias"] = _f32(tree["norm1_bias"][i])
            _lin(sd, f"{b}.norm1.linear", tree["norm1_linear"], i)
            _hdit_attn(sd, f"{b}.attn1", tree["attn1"], i)
            _hdit_attn(sd, f"{b}.attn2", tree["attn2"], i)
            for norm in ("norm2", "norm3") + (("skip_norm",) if first else ()):
                sd[f"{b}.{norm}.weight"] = _f32(tree[f"{norm}_scale"][i])
                sd[f"{b}.{norm}.bias"] = _f32(tree[f"{norm}_bias"][i])
            _lin(sd, f"{b}.ff.net.0.proj", tree["mlp_in"], i)
            _lin(sd, f"{b}.ff.net.2", tree["mlp_out"], i)
            if first:
                _lin(sd, f"{b}.skip_linear", tree["skip_linear"], i)
    return sd


def load_numpy_state_dict(module: torch.nn.Module, sd: Dict[str, np.ndarray]):
    """Strict ``load_state_dict`` from numpy arrays (each cast to its
    parameter's dtype and device)."""
    module.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()},
                           strict=True)
    return module
