"""IP-Adapter: image-prompt conditioning for the SD-class UNets (port of
hunyuan3d2_tpu/models/ip_adapter.py).

Two parts:

* the image projection: the 'plus' variant's Perceiver resampler over the
  CLIP vision penultimate hidden states (learned latent queries attend over
  [image tokens; latents], depth × (attention + GELU feed-forward), 16 query
  tokens out), or the plain variant's one Linear from the pooled CLIP embed
  to ``num_tokens`` context rows + LayerNorm;
* the decoupled attention: every ``attn2`` gains ``to_k_ip`` / ``to_v_ip``
  over the image tokens, and the scaled image branch is added to the text
  branch before ``to_out`` (models/paint_unet.py ``Attention``).

The modules carry the original IP-Adapter checkpoint names under
``image_proj.`` (``latents`` [1, Q, D], ``proj_in``, ``layers.{i}.0.*`` for
the attention, ``layers.{i}.1.{0,1,3}`` for the feed-forward's LayerNorm and
two Linears, ``proj_out``, ``norm_out``). :func:`add_ip_adapter` grafts zero
``to_k_ip`` / ``to_v_ip`` onto every ``attn2``, which leaves the forward
unchanged; :func:`load_ip_adapter` fills them from the checkpoint's
``ip_adapter.{1,3,5,…}`` keys in diffusers' processor order.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import torch
from torch import nn

from hunyuan3d2_tpu_torch.ops.attention import attention, merge_heads, split_heads
from hunyuan3d2_tpu_torch.ops.nn import LayerNorm, Linear, gelu_exact


@dataclasses.dataclass(frozen=True)
class ResamplerConfig:
    dim: int = 768              # inner width
    depth: int = 4
    dim_head: int = 64
    heads: int = 12
    num_queries: int = 16
    embedding_dim: int = 1280   # CLIP ViT-H/14 hidden (ip-adapter-plus_sd15)
    output_dim: int = 768       # the UNet's cross_attention_dim
    ff_mult: int = 4


PLUS_SD15 = ResamplerConfig()
TINY = ResamplerConfig(dim=32, depth=1, dim_head=8, heads=2, num_queries=4, embedding_dim=48,
                       output_dim=32, ff_mult=2)


class PerceiverAttention(nn.Module):
    def __init__(self, cfg: ResamplerConfig):
        super().__init__()
        inner = cfg.dim_head * cfg.heads
        self.norm1 = LayerNorm(cfg.dim)     # on the image tokens
        self.norm2 = LayerNorm(cfg.dim)     # on the latents
        self.to_q = Linear(cfg.dim, inner, bias=False)
        self.to_kv = Linear(cfg.dim, 2 * inner, bias=False)
        self.to_out = Linear(inner, cfg.dim, bias=False)


class Resampler(nn.Module):
    """[B, T, embedding_dim] CLIP hidden states → [B, num_queries,
    output_dim] IP tokens: q from the latents, k/v from [image tokens;
    latents] (the original resampler.py)."""

    def __init__(self, cfg: ResamplerConfig = PLUS_SD15):
        super().__init__()
        self.cfg = cfg
        self.latents = nn.Parameter(torch.empty(1, cfg.num_queries, cfg.dim, dtype=torch.float32))
        self.proj_in = Linear(cfg.embedding_dim, cfg.dim)
        self.proj_out = Linear(cfg.dim, cfg.output_dim)
        self.norm_out = LayerNorm(cfg.output_dim)
        ff = cfg.ff_mult * cfg.dim
        self.layers = nn.ModuleList([
            nn.ModuleList([PerceiverAttention(cfg),
                           nn.ModuleList([LayerNorm(cfg.dim), Linear(cfg.dim, ff, bias=False),
                                          nn.Identity(), Linear(ff, cfg.dim, bias=False)])])
            for _ in range(cfg.depth)])

    def init_random_(self, generator):
        self.latents.normal_(generator=generator).div_(self.cfg.dim ** 0.5)

    def forward(self, image_embeds: torch.Tensor) -> torch.Tensor:
        heads = self.cfg.heads
        x = self.proj_in(image_embeds)
        lat = self.latents.to(x.dtype).expand(x.shape[0], -1, -1)
        for att, ff in self.layers:
            xh, lh = att.norm1(x), att.norm2(lat)
            q = split_heads(att.to_q(lh), heads)
            k, v = att.to_kv(torch.cat([xh, lh], dim=1)).chunk(2, dim=-1)
            out = attention(q, split_heads(k, heads), split_heads(v, heads))
            lat = lat + att.to_out(merge_heads(out))
            lat = lat + ff[3](gelu_exact(ff[1](ff[0](lat))))
        return self.norm_out(self.proj_out(lat))


class ImageProjModel(nn.Module):
    """The plain IP-Adapter's projection: pooled CLIP embed [B, clip_dim] →
    [B, num_tokens, cross_dim]."""

    def __init__(self, clip_embed_dim: int, cross_dim: int, num_tokens: int = 4):
        super().__init__()
        self.num_tokens = num_tokens
        self.proj = Linear(clip_embed_dim, num_tokens * cross_dim)
        self.norm = LayerNorm(cross_dim)

    def forward(self, pooled: torch.Tensor) -> torch.Tensor:
        return self.norm(self.proj(pooled).reshape(pooled.shape[0], self.num_tokens, -1))


def _blocks(unet: nn.Module) -> List[nn.Module]:
    """The transformer blocks (holding ``attn2``) of a UNet or ControlNet in
    diffusers' attention-processor order: all down blocks, all up blocks,
    then the mid block (UNet2DConditionModel assigns mid_block after the
    ModuleLists)."""
    out = []
    for name in ("down_blocks", "up_blocks", "mid_block"):
        part = getattr(unet, name, None)
        if part is None:
            continue
        for m in part.modules():
            if hasattr(m, "attn2"):
                out.append(m)
    return out


def add_ip_adapter(module: nn.Module, cross_dim: int) -> nn.Module:
    """Graft zero ``to_k_ip`` / ``to_v_ip`` onto every ``attn2`` of
    ``module`` (a UNetCore, a ControlNet, or a UNet2p5D with its dual copy),
    in place. Zero keys give uniform attention over zero values, so the
    image branch adds exactly 0 until weights are loaded."""
    for m in module.modules():
        if hasattr(m, "attn2"):
            a = m.attn2
            w = a.to_q.weight
            for name in ("to_k_ip", "to_v_ip"):
                lin = Linear(cross_dim, a.to_q.out_features, bias=False).to(w.device)
                lin.weight.requires_grad_(False).zero_()
                setattr(a, name, lin)
    return module


def load_ip_adapter(unet: nn.Module, sd: Dict[str, torch.Tensor],
                    prefix: str = "ip_adapter.") -> nn.Module:
    """Graft the checkpoint's ``ip_adapter.{1,3,5,…}.to_{k,v}_ip.weight``
    onto ``unet``'s ``attn2`` modules in diffusers' processor order, each
    cast to bf16 on the UNet's device. A missing or misshapen key raises."""
    blocks = _blocks(unet)
    want = {f"{prefix}{2 * i + 1}.to_{kv}_ip.weight" for i in range(len(blocks))
            for kv in "kv"}
    have = {k for k in sd if k.startswith(prefix)}
    if want != have:
        raise KeyError(f"IP-Adapter: missing keys {sorted(want - have)[:10]}, unexpected keys "
                       f"{sorted(have - want)[:10]}")
    add_ip_adapter(unet, int(sd[f"{prefix}1.to_k_ip.weight"].shape[1]))
    with torch.no_grad():
        for i, blk in enumerate(blocks):
            for kv in "kv":
                dst = getattr(blk.attn2, f"to_{kv}_ip").weight
                src = sd[f"{prefix}{2 * i + 1}.to_{kv}_ip.weight"]
                if tuple(src.shape) != tuple(dst.shape):
                    raise ValueError(f"IP-Adapter: {prefix}{2 * i + 1}.to_{kv}_ip.weight is "
                                     f"{tuple(src.shape)}, {tuple(dst.shape)} in the model")
                dst.copy_(src)
    return unet
