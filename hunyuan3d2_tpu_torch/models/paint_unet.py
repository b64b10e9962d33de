"""HunyuanPaint 2.5D UNet, the multiview diffusion denoiser, NHWC (port of
hunyuan3d2_tpu/models/paint_unet.py).

A diffusers SD2.1-class UNet2DConditionModel with a 12-channel conv_in
(gen latent + normal + position latents), learned text embeddings, a
camera-index class embedding added to the time embedding, and every
transformer block wrapped with a reference attention (K/V from the
reference branch's norm1 states, cached per layer) and a multiview attention
(self-attention over all views' tokens, under the voxel-locality mask for
the paint-turbo checkpoints). A dual copy of the UNet, without those extras
and with a 4-channel conv_in, runs the reference image once in 'w' (write)
mode to fill the cache; the main UNet then runs every step in 'r' (read)
mode.

Modules carry the diffusers names that the JAX package's
io/diffusers_maps.py ``export_paint_unet`` writes: ``unet.*`` for the main
UNet (wrapped blocks at ``...transformer_blocks.0.transformer.*``, extras at
``...transformer_blocks.0.attn_refview`` / ``attn_multiview``) and
``unet_dual.*`` for the dual copy. Views are folded into the batch axis.

Inside a denoise loop's :meth:`UNet2p5D.step_graphs` scope, an 'r' pass on
the card replays CUDA graphs of the eager body's pieces between its flash
attention calls, which run eagerly between them (:meth:`UNet2p5D.forward`,
through utils/cuda_graphs.py).

``UNetCore`` without the extras is also the plain SD-class
UNet2DConditionModel of the delight, x4 upscale and align pipelines: a head
count per block (``num_heads``), per-block cross-attention flags
(``down_cross``), a class embedding that is a table or a timestep MLP, the
IP-Adapter's image branch in every ``attn2`` that carries ``to_k_ip`` /
``to_v_ip`` (models/ip_adapter.py), and ControlNet residuals
(models/controlnet.py) added to the skips and after the mid block.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Dict, Optional

import torch
from torch import nn

from hunyuan3d2_tpu_torch.ops.attention import (
    attention,
    masked_attention,
    merge_heads,
    split_heads,
    use_flash,
)
from hunyuan3d2_tpu_torch.ops.conv import Conv2d, GroupNorm, ResnetBlock, upsample_nearest2x
from hunyuan3d2_tpu_torch.ops.nn import LayerNorm, Linear, gelu_exact, silu
from hunyuan3d2_tpu_torch.utils import timer
from hunyuan3d2_tpu_torch.utils.cuda_graphs import GraphPool, capturing, cut, graphable

GRAPH_REPLAYS = "Paint/graph_replays"       # the request's counters of the step graphs
GRAPH_CAPTURES = "Paint/graph_captures"
_SCOPE_LOCK = threading.Lock()      # one thread's denoise loop holds step graphs at a time


@dataclasses.dataclass(frozen=True)
class PaintUNetConfig:
    in_channels: int = 12
    out_channels: int = 4
    block_out_channels: tuple = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    cross_attention_dim: int = 1024
    attention_head_dim: int = 64
    norm_num_groups: int = 32
    num_class_embeds: int = 5 + 12 * 3 + 4 * 2   # max_num_ref + max_num_gen
    use_multiview_attention: bool = True
    use_reference_attention: bool = True
    use_camera_embedding: bool = True
    use_dual_stream: bool = True
    # SD2.1-class UNets fix the head size (attention_head_dim channels a
    # head); SD1.5-class ones (the delight and align UNets) fix the head
    # count at 8 with per-block head sizes: num_heads sets that count
    num_heads: Optional[int] = None
    # per-down-block cross-attention flags, the up blocks mirroring them
    # reversed; None is the SD default (all but the deepest down block). The
    # x4 upscaler has (False, True, True, True)
    down_cross: Optional[tuple] = None
    # "table": learned rows indexed by the class label (camera indices, the
    # x4 upscaler's noise level); "timestep": the label is sinusoid-embedded
    # and run through an MLP like the timestep (diffusers
    # class_embed_type="timestep")
    class_embed_type: str = "table"

    @property
    def time_embed_dim(self) -> int:
        return self.block_out_channels[0] * 4

    def is_cross(self, i: int, down: bool) -> bool:
        """Down blocks: CrossAttn × (n-1), then Down; up blocks mirror. An
        explicit ``down_cross`` overrides (the up blocks reversed)."""
        n = len(self.block_out_channels)
        if self.down_cross is not None:
            return self.down_cross[i if down else n - 1 - i]
        return (i < n - 1) if down else (i > 0)

    def heads(self, c: int) -> int:
        """The head count of a transformer block at ``c`` channels."""
        return self.num_heads or c // self.attention_head_dim


DEFAULT = PaintUNetConfig()
TINY = PaintUNetConfig(block_out_channels=(32, 64), layers_per_block=1,
                       cross_attention_dim=32, attention_head_dim=8, norm_num_groups=8)


def dual_config(cfg: PaintUNetConfig) -> PaintUNetConfig:
    """The dual (reference) copy: 4-channel conv_in, no class embedding, no
    2.5D attentions (the reference deep-copies the UNet before that
    surgery)."""
    return dataclasses.replace(cfg, in_channels=4, use_multiview_attention=False,
                               use_reference_attention=False, use_camera_embedding=False,
                               use_dual_stream=False)


def compute_voxel_grid_mask(position: torch.Tensor, grid_resolution: int) -> torch.Tensor:
    """Voxel-locality multiview attention mask: pool the per-view position
    maps to grid_resolution², average the 3D position over valid
    (non-background) pixels, and allow attention between token pairs whose
    positions lie within 1.73/grid_resolution, with the squared distance
    taken as |a|² + |b|² − 2a·b (as in the JAX package).

    position [B, N, H, W, 3] in [0, 1] (1 ⇒ background) → bool
    [B, N·g², N·g²]."""
    b, n, h, w, _ = position.shape
    g = grid_resolution
    position = position.float()
    valid = (position != 1.0).all(dim=-1, keepdim=True)
    pos = torch.where(valid, position, 0.0)
    ph, pw = h // g, w // g
    pos = pos.reshape(b, n, g, ph, g, pw, 3).sum(dim=(3, 5))
    cnt = valid.float().reshape(b, n, g, ph, g, pw, 1).sum(dim=(3, 5))
    grid_pos = pos / cnt.clamp_min(1.0)
    grid_pos = torch.where(cnt < 5, 0.0, grid_pos)
    flat = grid_pos.reshape(b, n * g * g, 3)
    sq = (flat * flat).sum(-1)
    d2 = sq[:, :, None] + sq[:, None, :] - 2.0 * torch.einsum("bld,bmd->blm", flat, flat)
    return d2 < (1.73 / g) ** 2


def compute_multi_resolution_mask(position_maps: torch.Tensor,
                                  grid_resolutions=(32, 16, 8)) -> Dict[int, torch.Tensor]:
    """{token count: [B, L, L] bool} voxel masks, keyed by the multiview
    sequence length of each grid."""
    masks = {}
    for g in grid_resolutions:
        m = compute_voxel_grid_mask(position_maps, g)
        masks[int(m.shape[1])] = m
    return masks


def multiview_calls(cfg: "PaintUNetConfig", h: int, w: int, num_views: int) -> Dict[int, int]:
    """{multiview token count: calls} of the multiview attention in one 'r'
    pass of :class:`UNet2p5D` at latent size (h, w): a call in every
    transformer block, at ``num_views`` times the block's tokens (the
    modules' walk, as :func:`flops` takes it). Empty without multiview
    attention or with one view."""
    if not cfg.use_multiview_attention or num_views < 2:
        return {}
    out: Dict[int, int] = {}

    def at(hh, ww, k):
        if k:
            out[num_views * hh * ww] = out.get(num_views * hh * ww, 0) + k

    n = len(cfg.block_out_channels)
    for i in range(n):
        at(h, w, cfg.layers_per_block if cfg.is_cross(i, down=True) else 0)
        if i < n - 1:
            h, w = h // 2, w // 2
    at(h, w, 1)                                                    # the mid block
    for i in range(n):
        at(h, w, cfg.layers_per_block + 1 if cfg.is_cross(i, down=False) else 0)
        if i < n - 1:
            h, w = h * 2, w * 2
    return out


def compute_discrete_voxel_indice(position: torch.Tensor, grid_resolution: int = 8,
                                  voxel_resolution: int = 128) -> torch.Tensor:
    """Quantised voxel indices per pooled grid cell: the voxel mask's
    valid-pixel pooling, then the mean position rounded onto a
    voxel_resolution³ lattice. The pooling runs in float16, as the reference
    does (it casts to half up front): fp32 pooling moves ~3 % of the cells
    across a rounding boundary.

    position [B, N, H, W, 3] in [0, 1] (1 ⇒ background) → int32
    [B, N, g, g, 3]."""
    b, n, h, w, _ = position.shape
    g = grid_resolution
    position = position.to(torch.float16)
    valid = (position != 1.0).all(dim=-1, keepdim=True)
    zero = torch.zeros((), dtype=torch.float16, device=position.device)
    pos = torch.where(valid, position, zero)
    ph, pw = h // g, w // g
    pos = pos.reshape(b, n, g, ph, g, pw, 3).sum(dim=(3, 5), dtype=torch.float16)
    cnt = valid.to(torch.float16).reshape(b, n, g, ph, g, pw, 1).sum(dim=(3, 5),
                                                                     dtype=torch.float16)
    grid_pos = pos / cnt.clamp_min(1.0)
    grid_pos = torch.where(cnt < 5, zero, grid_pos).clamp(0.0, 1.0)
    scale = torch.tensor(voxel_resolution - 1, dtype=torch.float16, device=position.device)
    return torch.round(grid_pos * scale).to(torch.int32)


def compute_multi_resolution_discrete_voxel_indice(
        position_maps: torch.Tensor, grid_resolutions=(64, 32, 16, 8),
        voxel_resolutions=(512, 256, 128, 64)) -> Dict[int, dict]:
    """{token count: {'voxel_indices': [B, N·g², 3] int32,
    'voxel_resolution': int}}, keyed by multiview sequence length. The
    reference hands these to the multiview attention, whose stock processor
    ignores them; the masks of compute_multi_resolution_mask are what takes
    effect."""
    out = {}
    for g, vr in zip(grid_resolutions, voxel_resolutions):
        idx = compute_discrete_voxel_indice(position_maps, g, vr)
        b, n = idx.shape[:2]
        flat = idx.reshape(b, n * g * g, 3)
        out[int(flat.shape[1])] = {"voxel_indices": flat, "voxel_resolution": vr}
    return out


def sd_timestep_embedding(t: torch.Tensor, dim: int, max_period: float = 10000.0) -> torch.Tensor:
    """diffusers Timesteps with flip_sin_to_cos=True, shift=0: [cos | sin]."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------
class Attention(nn.Module):
    """diffusers Attention: to_q / to_k / to_v without bias, to_out.0."""

    def __init__(self, dim: int, kv_dim: Optional[int] = None):
        super().__init__()
        kv_dim = kv_dim or dim
        self.to_q = Linear(dim, dim, bias=False)
        self.to_k = Linear(kv_dim, dim, bias=False)
        self.to_v = Linear(kv_dim, dim, bias=False)
        self.to_out = nn.ModuleList([Linear(dim, dim)])

    def forward(self, x, kv, heads: int, mask: Optional[torch.Tensor] = None,
                ip_context: Optional[torch.Tensor] = None, ip_scale=1.0):
        """With ``ip_context`` and the grafted ``to_k_ip`` / ``to_v_ip``
        (diffusers IPAdapterAttnProcessor): the same queries attend over the
        image tokens through their own K/V, and ``ip_scale`` times that
        attention is added before the shared ``to_out``. The sum is taken in
        fp32, as the JAX pipelines' fp32 scale promotes it; the residual
        stream after it is then fp32 too."""
        q = split_heads(self.to_q(x), heads)
        k = split_heads(self.to_k(kv), heads)
        v = split_heads(self.to_v(kv), heads)
        out = _attend(q, k, v, mask)
        if ip_context is not None and hasattr(self, "to_k_ip"):
            k_ip = split_heads(self.to_k_ip(ip_context), heads)
            v_ip = split_heads(self.to_v_ip(ip_context), heads)
            out = out.float() + ip_scale * _attend(q, k_ip, v_ip).float()
        return self.to_out[0](merge_heads(out))


def _attend(q, k, v, mask=None):
    """The module's ``attention`` / ``masked_attention``, read at each call
    (a tap on them sees every call). While this thread captures a step
    graph, a call that the flash gate admits is cut out of it
    (``cuda_graphs.cut``): at each replay it runs eagerly between the
    pieces, into the kernels' output layout."""
    if capturing() and use_flash(q):
        return cut(_gated, q, k, v, mask, like=q)
    return _gated(q, k, v, mask)


def _gated(q, k, v, mask):
    return attention(q, k, v) if mask is None else masked_attention(q, k, v, mask)


class _GEGLU(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.proj = Linear(dim, 8 * dim)


class FeedForward(nn.Module):
    """GEGLU feed-forward, names ff.net.0.proj / ff.net.2."""

    def __init__(self, dim: int):
        super().__init__()
        self.net = nn.ModuleList([_GEGLU(dim), nn.Identity(), Linear(4 * dim, dim)])

    def forward(self, h):
        a, b = self.net[0].proj(h).chunk(2, dim=-1)
        return self.net[2](a * gelu_exact(b))


class BasicTransformerBlock(nn.Module):
    def __init__(self, cfg: PaintUNetConfig, dim: int):
        super().__init__()
        self.norm1 = LayerNorm(dim, eps=1e-5)
        self.attn1 = Attention(dim)
        self.norm2 = LayerNorm(dim, eps=1e-5)
        self.attn2 = Attention(dim, cfg.cross_attention_dim)
        self.norm3 = LayerNorm(dim, eps=1e-5)
        self.ff = FeedForward(dim)


class Basic2p5DTransformerBlock(nn.Module):
    """The wrapped block: the base block under ``transformer`` and the 2.5D
    attentions beside it."""

    def __init__(self, cfg: PaintUNetConfig, dim: int):
        super().__init__()
        self.transformer = BasicTransformerBlock(cfg, dim)
        if cfg.use_reference_attention:
            self.attn_refview = Attention(dim)
        if cfg.use_multiview_attention:
            self.attn_multiview = Attention(dim)


def _pinned_add(x: torch.Tensor, scale, out: torch.Tensor) -> torch.Tensor:
    """x + (scale · out) with the product in fp32 and the sum back in x's
    (bf16) dtype, as the JAX package pins the residual stream. ``scale`` is
    a number or an fp32 [(B·N), 1, 1] tensor (CFG's per-branch scale)."""
    return x + (scale * out.float()).to(x.dtype)


class Transformer2D(nn.Module):
    def __init__(self, cfg: PaintUNetConfig, ch: int, extras: bool):
        super().__init__()
        self.cfg = cfg
        self.heads = cfg.heads(ch)  # this rank's share once tp shards it (parallel/sharding.py)
        self.norm = GroupNorm(ch)
        self.proj_in = Linear(ch, ch)
        blk = Basic2p5DTransformerBlock(cfg, ch) if extras else BasicTransformerBlock(cfg, ch)
        self.transformer_blocks = nn.ModuleList([blk])
        self.proj_out = Linear(ch, ch)

    def forward(self, x, context, layer: str, mode: str, num_views: int, cache: Dict,
                ref_scale, mva_scale, mva_masks, ip_context=None, ip_scale=1.0):
        cfg = self.cfg
        b, hh, ww, c = x.shape
        # diffusers Transformer2DModel GroupNorm eps is 1e-6
        y = self.proj_in(self.norm(x, cfg.norm_num_groups, 1e-6).reshape(b, hh * ww, c))
        wrapped = self.transformer_blocks[0]
        blk = getattr(wrapped, "transformer", wrapped)
        heads = self.heads

        h = blk.norm1(y)
        y = y + blk.attn1(h, h, heads)
        bn, l, _ = h.shape
        if mode == "w":
            cache[layer] = h.reshape(bn // num_views, num_views * l, c)
        if mode == "r" and cfg.use_reference_attention:
            ref = cache[layer]                                    # [B, Nr·L, C]
            ref_rep = ref.repeat_interleave(bn // ref.shape[0], dim=0)
            y = _pinned_add(y, ref_scale, wrapped.attn_refview(h, ref_rep, heads))
        if num_views > 1 and cfg.use_multiview_attention and mode == "r":
            mv = h.reshape(bn // num_views, num_views * l, c)
            mask = (mva_masks or {}).get(num_views * l)
            out = wrapped.attn_multiview(mv, mv, heads, mask=mask)
            y = _pinned_add(y, mva_scale, out.reshape(bn, l, c))
        y = y + blk.attn2(blk.norm2(y), context, heads, ip_context=ip_context,
                          ip_scale=ip_scale)
        y = y + blk.ff(blk.norm3(y))
        return x + self.proj_out(y).reshape(b, hh, ww, c)


class _Sampler(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv = Conv2d(c, c, 3)


class _UpDownBlock(nn.Module):
    def __init__(self, cfg, resnet_chans, attn_ch: Optional[int], extras: bool, sampler: str):
        super().__init__()
        temb = cfg.time_embed_dim
        self.resnets = nn.ModuleList([ResnetBlock(a, b, temb) for a, b in resnet_chans])
        n_attn = len(resnet_chans) if attn_ch else 0
        self.attentions = nn.ModuleList([Transformer2D(cfg, attn_ch, extras)
                                         for _ in range(n_attn)])
        if sampler:
            setattr(self, sampler, nn.ModuleList([_Sampler(resnet_chans[-1][1])]))


class _Mid(nn.Module):
    def __init__(self, cfg, c: int, extras: bool):
        super().__init__()
        temb = cfg.time_embed_dim
        self.resnets = nn.ModuleList([ResnetBlock(c, c, temb), ResnetBlock(c, c, temb)])
        self.attentions = nn.ModuleList([Transformer2D(cfg, c, extras)])


class _ClassEmbedding(nn.Module):
    def __init__(self, n: int, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(n, dim, dtype=torch.float32))

    def init_random_(self, generator):
        self.weight.normal_(generator=generator).mul_(0.02)


class _TimestepEmbedding(nn.Module):
    def __init__(self, cin: int, dim: int):
        super().__init__()
        self.linear_1 = Linear(cin, dim)
        self.linear_2 = Linear(dim, dim)


class UNetCore(nn.Module):
    """UNet2DConditionModel (+2.5D extras with ``extras``). The paint UNet's
    learned text embeddings are there with ``learned_text``; a plain SD
    checkpoint has none."""

    def __init__(self, cfg: PaintUNetConfig, extras: bool, learned_text: bool = True):
        super().__init__()
        self.cfg = cfg
        chs = cfg.block_out_channels
        n = len(chs)
        self.conv_in = Conv2d(cfg.in_channels, chs[0], 3)
        self.time_embedding = _TimestepEmbedding(chs[0], cfg.time_embed_dim)
        if cfg.use_camera_embedding:
            self.class_embedding = (
                _TimestepEmbedding(chs[0], cfg.time_embed_dim)
                if cfg.class_embed_type == "timestep"
                else _ClassEmbedding(cfg.num_class_embeds, cfg.time_embed_dim))
        if learned_text:
            self.learned_text_clip_gen = nn.Parameter(
                torch.empty(1, 77, cfg.cross_attention_dim, dtype=torch.float32))
            self.learned_text_clip_ref = nn.Parameter(
                torch.empty(1, 77, cfg.cross_attention_dim, dtype=torch.float32))
        down, c_in = [], chs[0]
        for i, c_out in enumerate(chs):
            down.append(_UpDownBlock(
                cfg, [(c_in if j == 0 else c_out, c_out) for j in range(cfg.layers_per_block)],
                c_out if cfg.is_cross(i, down=True) else None, extras,
                "downsamplers" if i < n - 1 else ""))
            c_in = c_out
        self.down_blocks = nn.ModuleList(down)
        self.mid_block = _Mid(cfg, chs[-1], extras)
        rev, up = list(reversed(chs)), []
        for i, c_out in enumerate(rev):
            prev = rev[max(i - 1, 0)]
            skip_src = rev[min(i + 1, n - 1)]
            chans = [((prev if j == 0 else c_out)
                      + (c_out if j < cfg.layers_per_block else skip_src), c_out)
                     for j in range(cfg.layers_per_block + 1)]
            up.append(_UpDownBlock(cfg, chans, c_out if cfg.is_cross(i, down=False) else None,
                                   extras, "upsamplers" if i < n - 1 else ""))
        self.up_blocks = nn.ModuleList(up)
        self.conv_norm_out = GroupNorm(chs[0])
        self.conv_out = Conv2d(chs[0], cfg.out_channels, 3)

    def init_random_(self, generator):
        if hasattr(self, "learned_text_clip_gen"):
            self.learned_text_clip_gen.normal_(generator=generator)
            self.learned_text_clip_ref.normal_(generator=generator)

    def forward(self, sample, t, context, class_labels, mode: str, num_views: int, cache: Dict,
                ref_scale=1.0, mva_scale=1.0, mva_masks=None, ip_context=None, ip_scale=1.0,
                ctrl_down=None, ctrl_mid=None):
        """sample [(B·N), H, W, C_in] NHWC; t [(B·N)]; context
        [(B·N), 77, D]. ``cache`` is filled in 'w' mode and read in 'r'.

        ``ip_context`` / ``ip_scale``: the IP-Adapter's image tokens, used by
        every ``attn2`` that carries ``to_k_ip``. ``ctrl_down`` /
        ``ctrl_mid``: ControlNet residuals, one per skip (conv_in and every
        down-block output), added to the skips after the down path, and one
        added after the mid block (diffusers
        down_block_additional_residuals / mid_block_additional_residual)."""
        cfg = self.cfg
        g = cfg.norm_num_groups
        temb = sd_timestep_embedding(t, cfg.block_out_channels[0]).to(sample.dtype)
        temb = self.time_embedding.linear_2(silu(self.time_embedding.linear_1(temb)))
        if cfg.use_camera_embedding and class_labels is not None:
            if cfg.class_embed_type == "timestep":
                cemb = sd_timestep_embedding(torch.as_tensor(class_labels, device=t.device),
                                             cfg.block_out_channels[0]).to(temb.dtype)
                ce = self.class_embedding
                temb = temb + ce.linear_2(silu(ce.linear_1(cemb)))
            else:
                temb = temb + self.class_embedding.weight[class_labels].to(temb.dtype)

        def attn(mod, x, layer):
            return mod(x, context, layer, mode, num_views, cache, ref_scale, mva_scale, mva_masks,
                       ip_context, ip_scale)

        x = self.conv_in(sample)
        residuals = [x]
        for i, blk in enumerate(self.down_blocks):
            for j, r in enumerate(blk.resnets):
                x = r(x, temb, g, eps=1e-5)
                if len(blk.attentions):
                    x = attn(blk.attentions[j], x, f"down_{i}_{j}")
                residuals.append(x)
            if hasattr(blk, "downsamplers"):
                # diffusers UNet Downsample2D pads symmetrically by 1
                x = blk.downsamplers[0].conv(x, stride=2, padding=1)
                residuals.append(x)
        if ctrl_down is not None:   # fp32 residuals promote the skips, as in the JAX package
            residuals = [r + c for r, c in zip(residuals, ctrl_down)]
        x = self.mid_block.resnets[0](x, temb, g, eps=1e-5)
        x = attn(self.mid_block.attentions[0], x, "mid_0")
        x = self.mid_block.resnets[1](x, temb, g, eps=1e-5)
        if ctrl_mid is not None:
            x = x + ctrl_mid
        for i, blk in enumerate(self.up_blocks):
            for j, r in enumerate(blk.resnets):
                x = r(torch.cat([x, residuals.pop()], dim=-1), temb, g, eps=1e-5)
                if len(blk.attentions):
                    x = attn(blk.attentions[j], x, f"up_{i}_{j}")
            if hasattr(blk, "upsamplers"):
                x = blk.upsamplers[0].conv(upsample_nearest2x(x))
        x = self.conv_norm_out(x, g, eps=1e-5)
        return self.conv_out(silu(x))


def plain_unet(cfg: PaintUNetConfig) -> UNetCore:
    """The SD-class UNet of the secondary pipelines (delight, upscale,
    align): no 2.5D extras, no learned text embeddings (the diffusers
    UNet2DConditionModel keys)."""
    return UNetCore(cfg, extras=False, learned_text=False)


class _Steps:
    """An open :meth:`UNet2p5D.step_graphs` scope: its thread, and the step
    graph it holds with its key."""

    __slots__ = ("thread", "graph", "key")

    def __init__(self):
        self.thread, self.graph, self.key = threading.get_ident(), None, None


def _key(sample, timestep, rest, ptr: bool) -> tuple:
    """A step graph's key: the sample's layout, the timestep's size, and the
    request-constant inputs (their layouts and, with ``ptr``, addresses;
    numbers as they are, which the capture bakes in)."""
    def sig(x, ptr=ptr):
        if isinstance(x, torch.Tensor):
            layout = (tuple(x.shape), x.stride(), x.dtype, x.device)
            return layout + (x.data_ptr(),) if ptr else layout
        if isinstance(x, dict):
            return tuple((k, sig(v)) for k, v in x.items())
        if isinstance(x, (list, tuple)):
            return tuple(sig(v) for v in x)
        return x

    t_size = timestep.numel() if isinstance(timestep, torch.Tensor) else None
    return (sig(sample, False), t_size) + sig(rest)


def _load(static, t, sample, timestep):
    """A call's sample and timestep into a step graph's static buffers; a
    number is filled on the device, with no copy from the host."""
    static.copy_(sample)
    if isinstance(timestep, torch.Tensor):
        t.copy_(timestep.reshape(-1))
    else:
        t.fill_(float(timestep))


def _first_view(sample, t, rest) -> tuple:
    """A short warm-up pass's inputs: the first view's top-left 8² latents,
    no masks, a reference scale of 1."""
    normal, position, camera, cache, _, mva_scale, _ = rest
    crop = (slice(None), slice(0, 1), slice(0, 8), slice(0, 8))
    camera = camera[:, :1] if isinstance(camera, torch.Tensor) else camera
    return sample[crop], t[:1], normal[crop], position[crop], camera, cache, 1.0, mva_scale, None


class UNet2p5D(nn.Module):
    """The full 2.5D UNet: ``unet`` (with the extras) and, with
    ``use_dual_stream``, ``unet_dual`` for the reference 'w' pass. Without
    the dual copy (single stream), ``unet`` itself runs the 'w' pass on the
    reference latents with zero control channels."""

    def __init__(self, cfg: PaintUNetConfig = DEFAULT):
        super().__init__()
        self.cfg = cfg
        self.unet = UNetCore(cfg, extras=True)
        if cfg.use_dual_stream:
            self.unet_dual = UNetCore(dual_config(cfg), extras=False)
        self._steps = None          # the open step_graphs scope
        self._graph_pool = GraphPool()      # the step graphs' memory pool, kept across scopes

    def _apply(self, fn, recurse=True):
        # .to(), .cuda(), to_empty(): the tensors may move, and a step graph
        # reads them where they were captured
        if self._steps is not None:
            self._steps.graph = None
        self._graph_pool.drop()
        return super()._apply(fn, recurse)

    @contextlib.contextmanager
    def step_graphs(self):
        """The scope of a denoise loop: inside it this thread's 'r' passes
        may replay a step graph (:meth:`forward`). Leaving it drops the
        graph and every tensor it holds; the memory pool it was captured in
        stays with the module (held by an anchor graph) for the next
        scope's capture. A scope opened while another thread's is open, or
        inside one, adds nothing."""
        if not _SCOPE_LOCK.acquire(blocking=False):
            yield
            return
        try:
            self._steps = _Steps()
            yield
        finally:
            self._steps = None
            _SCOPE_LOCK.release()

    def write_cache(self, ref_latents: torch.Tensor, camera_info_ref=None) -> Dict:
        """The reference 'w' pass: ref_latents [B, N_ref, h, w, 4] → the
        per-layer cache {layer: [B, N_ref·L, C]}. The dual copy has no camera
        embedding; the single-stream pass takes the reference camera indices
        ``camera_info_ref`` [B, N_ref] (default 0). Either pass attends to the
        main UNet's ``learned_text_clip_ref``, as the JAX package's does (the
        dual copy's own, which the checkpoint also holds, is not read)."""
        b, n_ref = ref_latents.shape[:2]
        ref = ref_latents.reshape((b * n_ref,) + ref_latents.shape[2:])
        cache: Dict[str, torch.Tensor] = {}
        if not self.cfg.use_reference_attention:
            return cache
        core, labels = getattr(self, "unet_dual", self.unet), None
        if not self.cfg.use_dual_stream:  # zero control channels, the reference cameras
            ref = torch.cat([ref, torch.zeros_like(ref), torch.zeros_like(ref)], dim=-1)
            if self.cfg.use_camera_embedding:
                cam = torch.zeros(b, n_ref) if camera_info_ref is None else camera_info_ref
                labels = torch.as_tensor(cam, dtype=torch.long, device=ref.device).reshape(-1)
        ctx = self.unet.learned_text_clip_ref.to(ref.dtype).expand(b * n_ref, -1, -1)
        core(ref, torch.zeros(b * n_ref, device=ref.device), ctx, labels, "w", n_ref, cache)
        return cache

    def forward(self, sample, timestep, normal_latents, position_latents, camera_info_gen,
                cache: Dict, ref_scale=1.0, mva_scale=1.0, mva_masks=None) -> torch.Tensor:
        """The 'r' pass: sample / normal / position latents
        [B, N_gen, H, W, 4], camera_info_gen [B, N_gen] int → noise
        prediction [B, N_gen, H, W, 4]. ``ref_scale`` is a number or one
        value per batch row ([B], CFG's [0, 1]), applied in fp32.

        Inside this thread's :meth:`step_graphs` scope, a call that passes
        ``utils/cuda_graphs.py``'s gate (the mechanism is that module's),
        its request-constant tensors on the card too, replays the scope's
        step graph, cut at each attention call that the flash gate admits
        (``use_flash``): those run eagerly through the module's
        ``attention`` / ``masked_attention``. A new key (:func:`_key`: the
        request-constant inputs by layout and address) captures again. Each
        replay adds 1 to the request's "Paint/graph_replays", each capture 1
        to "Paint/graph_captures". Any other call runs the eager body."""
        rest = (normal_latents, position_latents, camera_info_gen, cache, ref_scale, mva_scale,
                mva_masks)
        if self._graphable(sample, rest):
            return self._replay(sample, timestep, rest)
        t = torch.as_tensor(timestep, dtype=torch.float32, device=sample.device).reshape(-1)
        return self._forward(sample, t, *rest)

    def _graphable(self, sample, rest) -> bool:
        steps = self._steps
        if steps is None or steps.thread != threading.get_ident():
            return False
        normal, position, camera, cache, ref_scale, _, masks = rest
        # a graph reads these where they lie
        read = [normal, position, *cache.values(), *(masks or {}).values()]
        if self.cfg.use_camera_embedding:
            read.append(camera)
        if not isinstance(ref_scale, (int, float)):
            read.append(ref_scale)
        return graphable(self, sample, *read)

    def _replay(self, sample, timestep, rest) -> torch.Tensor:
        steps = self._steps
        key = _key(sample, timestep, rest, ptr=True)
        if steps.graph is None or steps.key != key:
            steps.graph = None          # its tensors return to the pool before the capture
            steps.graph, steps.key = self._capture(sample, timestep, rest), key
        graph = steps.graph
        _load(graph.args[0], graph.args[1], sample, timestep)
        out = graph.replay().clone()
        timer.add(GRAPH_REPLAYS, 1)
        return out

    def _capture(self, sample, timestep, rest):
        """A step graph on a static sample and timestep."""
        static = torch.empty_like(sample, memory_format=torch.contiguous_format)
        t = torch.empty(timestep.numel() if isinstance(timestep, torch.Tensor) else 1,
                        dtype=torch.float32, device=sample.device)
        _load(static, t, sample, timestep)
        graph = self._graph_pool.capture(self._forward, (static, t, *rest),
                                         _first_view(static, t, rest),
                                         _key(sample, timestep, rest, ptr=False))
        timer.add(GRAPH_CAPTURES, 1)
        return graph

    def _forward(self, sample, t, normal_latents, position_latents, camera_info_gen, cache,
                 ref_scale, mva_scale, mva_masks) -> torch.Tensor:
        """The eager body of :meth:`forward`, ``t`` the timestep as float32
        [1] (or [B·N_gen]) on the device."""
        cfg = self.cfg
        b, n_gen = sample.shape[:2]
        x = torch.cat([sample, normal_latents, position_latents], dim=-1)
        x = x.reshape((b * n_gen,) + x.shape[2:])
        ctx = self.unet.learned_text_clip_gen.to(x.dtype).expand(b * n_gen, -1, -1)
        t = t.expand(b * n_gen)
        labels = (camera_info_gen + 5).reshape(-1) if cfg.use_camera_embedding else None
        if not isinstance(ref_scale, (int, float)):
            rs = torch.as_tensor(ref_scale, dtype=torch.float32, device=x.device)
            ref_scale = rs.repeat_interleave(n_gen).reshape(-1, 1, 1) if rs.ndim == 1 else rs
        out = self.unet(x, t, ctx, labels, "r", n_gen, cache, ref_scale, mva_scale, mva_masks)
        return out.reshape(b, n_gen, *out.shape[1:])


# ---------------------------------------------------------------------------
# analytic FLOPs (the paint stage's utilization)
# ---------------------------------------------------------------------------
def flops(cfg: PaintUNetConfig, h: int, w: int, num_views: int = 6, num_ref: int = 1,
          batch: int = 1, mode: str = "r") -> float:
    """Matmul and conv FLOPs of one :class:`UNetCore` pass over
    ``batch · num_views`` samples at latent size (h, w): 2·k²·c_in·c_out
    a pixel per conv, 2·c_in·c_out a row per linear, 4·T·S·d per attention;
    norms and elementwise work are not counted. The walk is the modules'
    (the same block loops, resolution halving and doubling, 77 text tokens,
    the reference and multiview attentions in 'r' mode only). Attention is
    counted dense: the key tiles that the masked kernel skips under the
    turbo voxel mask are counted too. Returns the JAX package's float for
    the same config fields (hunyuan3d2_tpu/models/paint_unet.py ``flops``)
    and ``torch.utils.flop_counter``'s count of the port's pass."""
    bn = batch * num_views
    ted = cfg.time_embed_dim

    def conv(cin, cout, k, pix):
        return 2.0 * k * k * cin * cout * pix * bn

    def lin(cin, cout, tokens_total):
        return 2.0 * cin * cout * tokens_total

    def res(cin, cout, pix):
        r = conv(cin, cout, 3, pix) + conv(cout, cout, 3, pix)
        r += lin(ted, cout, bn)                                   # time_emb_proj
        if cin != cout:
            r += conv(cin, cout, 1, pix)
        return r

    def t2d(ch, hh, ww):
        t = hh * ww
        tt = t * bn
        x = 2 * lin(ch, ch, tt)                                   # proj_in, proj_out
        x += 4 * lin(ch, ch, tt) + 4.0 * t * t * ch * bn          # attn1
        x += 2 * lin(ch, ch, tt)                                  # attn2 q, out
        x += 2 * lin(cfg.cross_attention_dim, ch, 77 * bn)        # attn2 k, v
        x += 4.0 * t * 77 * ch * bn
        if mode == "r" and cfg.use_reference_attention:
            s = num_ref * t
            x += 2 * lin(ch, ch, tt) + 2 * lin(ch, ch, s * bn)
            x += 4.0 * t * s * ch * bn
        if mode == "r" and cfg.use_multiview_attention and num_views > 1:
            seq = num_views * t
            x += 4 * lin(ch, ch, seq * batch) + 4.0 * seq * seq * ch * batch
        x += lin(ch, 8 * ch, tt) + lin(4 * ch, ch, tt)            # GEGLU feed-forward
        return x

    chs = cfg.block_out_channels
    n = len(chs)
    hh, ww = h, w
    f = conv(cfg.in_channels, chs[0], 3, hh * ww)
    f += lin(chs[0], ted, bn) + lin(ted, ted, bn)                 # time MLP
    c_in = chs[0]
    for i, c_out in enumerate(chs):
        for j in range(cfg.layers_per_block):
            f += res(c_in if j == 0 else c_out, c_out, hh * ww)
            if cfg.is_cross(i, down=True):
                f += t2d(c_out, hh, ww)
        if i < n - 1:
            hh, ww = hh // 2, ww // 2
            f += conv(c_out, c_out, 3, hh * ww)                   # stride-2 downsample
        c_in = c_out
    f += 2 * res(chs[-1], chs[-1], hh * ww) + t2d(chs[-1], hh, ww)
    rev = list(reversed(chs))
    for i, c_out in enumerate(rev):
        prev = rev[max(i - 1, 0)]
        skip_src = rev[min(i + 1, n - 1)]
        for j in range(cfg.layers_per_block + 1):
            res_skip = prev if j == 0 else c_out
            skip_ch = c_out if j < cfg.layers_per_block else skip_src
            f += res(res_skip + skip_ch, c_out, hh * ww)
            if cfg.is_cross(i, down=False):
                f += t2d(c_out, hh, ww)
        if i < n - 1:
            hh, ww = hh * 2, ww * 2
            f += conv(c_out, c_out, 3, hh * ww)                   # post-upsample conv
    f += conv(chs[0], cfg.out_channels, 3, hh * ww)
    return f


def apply_flops(cfg: PaintUNetConfig, h: int, w: int, num_views: int = 6, num_ref: int = 1,
                batch: int = 1):
    """(the 'r' pass's FLOPs, one a denoise step; the 'w' pass's, once a
    call: :meth:`UNet2p5D.write_cache`) at latent size (h, w); ``batch`` is
    2 under CFG."""
    r = flops(cfg, h, w, num_views, num_ref, batch, mode="r")
    wr = 0.0
    if cfg.use_reference_attention:
        dcfg = dual_config(cfg) if cfg.use_dual_stream else cfg
        wr = flops(dcfg, h, w, num_ref, num_ref, batch, mode="w")
    return r, wr
