"""HunyuanDiT, the text → image latent diffusion transformer of the text-to-3D
front end (port of hunyuan3d2_tpu/models/hunyuan_dit.py).

The diffusers ``HunyuanDiT2DModel`` (v1.0 and v1.1 classes): a patch-2
embed, U-ViT blocks whose second half takes long skips from the first,
per-head LayerNorm on q and k, 2-D rotary embeddings with interleaved pairs
on the image tokens, a joint text context CLIP [77, 1024] ⊕ projected mT5
[256, 2048 → 1024] with learned rows where the text mask is 0, a timestep
embedding plus the T5 attention pool (and, in v1.0, the image-meta-size and
style embeddings), an AdaLN-continuous head and 8 output channels
(prediction | variance). Modules carry the diffusers state-dict names, so a
``transformer/diffusion_pytorch_model.safetensors`` loads as it is.

The block stack runs as a Python loop where the JAX package scans. The
perturbed-attention branch (PAG) replaces the self-attention output of the
``pag_layers`` by V, so that attention is not computed there. Attention
goes through ``ops.attention.attention``: at head size 88 (1408 / 16) the
flash kernel's gate refuses it, as the JAX package's does, and the plain
``sdpa`` computes it. Matmuls take bf16 activations with fp32 accumulation;
norms are fp32.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from hunyuan3d2_tpu_torch.ops.attention import attention, merge_heads, split_heads
from hunyuan3d2_tpu_torch.ops.conv import Conv2d
from hunyuan3d2_tpu_torch.ops.embeddings import timestep_embedding
from hunyuan3d2_tpu_torch.ops.nn import Linear, LayerNorm, dense, gelu_tanh, layer_norm, silu


@dataclasses.dataclass(frozen=True)
class HunyuanDiTConfig:
    in_channels: int = 4
    out_channels: int = 8          # first 4 = prediction, last 4 = variance
    patch_size: int = 2
    hidden_size: int = 1408
    num_heads: int = 16
    depth: int = 40
    mlp_ratio: float = 4.0
    text_dim: int = 1024           # CLIP (Chinese BERT) hidden
    text_len: int = 77
    t5_dim: int = 2048             # mT5 encoder hidden
    t5_len: int = 256
    pooled_dim: int = 1024         # T5 attention-pool output
    style_classes: int = 1         # v1.0 style embedding table size
    meta_dims: int = 6             # image_meta_size: (h, w, th, tw, cx, cy)
    # diffusers use_style_cond_and_image_meta_size: True for v1.0, False for
    # v1.1 / v1.2 (the extra conditioning is the pooled text alone)
    use_style_meta: bool = True
    pag_layers: tuple = (16, 17, 18, 19)  # the reference's pag_applied_layers

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def mlp_hidden(self) -> int:
        return int(self.hidden_size * self.mlp_ratio)

    @property
    def n_pre(self) -> int:
        """Blocks before the skip-consuming stack (layers 0..depth//2)."""
        return self.depth // 2 + 1

    @property
    def n_skip(self) -> int:
        return self.depth - self.n_pre


FULL = HunyuanDiTConfig()
V1_1 = dataclasses.replace(FULL, use_style_meta=False)   # HunyuanDiT-v1.1(-Distilled)
TINY = HunyuanDiTConfig(hidden_size=64, num_heads=2, depth=4, text_dim=32, text_len=8, t5_dim=48,
                        t5_len=12, pooled_dim=32, pag_layers=(1,))


# ---------------------------------------------------------------------------
# rotary
# ---------------------------------------------------------------------------
def rope_2d(head_dim: int, gh: int, gw: int, device=None):
    """Axial 2-D rotary tables (cos, sin), each [gh*gw, head_dim] fp32: half
    the head dims rotate with the row, half with the column, and adjacent
    (even, odd) channels form a pair (diffusers get_2d_rotary_pos_embed)."""
    def axis(dim, n):
        freqs = 1.0 / (10000.0 ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                                 device=device) / dim))
        ang = torch.outer(torch.arange(n, dtype=torch.float32, device=device), freqs)
        return (torch.repeat_interleave(torch.cos(ang), 2, dim=-1),
                torch.repeat_interleave(torch.sin(ang), 2, dim=-1))

    hcos, hsin = axis(head_dim // 2, gh)
    wcos, wsin = axis(head_dim // 2, gw)
    cos = torch.cat([torch.repeat_interleave(hcos, gw, dim=0), wcos.repeat(gh, 1)], dim=-1)
    sin = torch.cat([torch.repeat_interleave(hsin, gw, dim=0), wsin.repeat(gh, 1)], dim=-1)
    return cos, sin


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [B, H, S, D]; interleaved pairs (x0, x1) → (x0 c - x1 s, x1 c + x0 s),
    in x's dtype."""
    x2 = x.reshape(x.shape[:-1] + (-1, 2))
    rot = torch.stack([-x2[..., 1], x2[..., 0]], dim=-1).reshape(x.shape)
    return x * cos.to(x.dtype) + rot * sin.to(x.dtype)


# ---------------------------------------------------------------------------
# modules (diffusers HunyuanDiT2DModel names)
# ---------------------------------------------------------------------------
class Attention(nn.Module):
    """to_q / to_k / to_v / to_out.0 with per-head LayerNorm (eps 1e-6) on q
    and k; ``kv_dim`` is the context width of a cross-attention."""

    def __init__(self, dim: int, kv_dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        hd = dim // num_heads
        self.to_q = Linear(dim, dim)
        self.to_k = Linear(kv_dim, dim)
        self.to_v = Linear(kv_dim, dim)
        self.to_out = nn.ModuleList([Linear(dim, dim)])
        self.norm_q = LayerNorm(hd)
        self.norm_k = LayerNorm(hd)

    def forward(self, x, cos, sin, ctx=None, perturbed: bool = False):
        """Self-attention (``ctx`` None: rotary on q and k; ``perturbed``: the
        PAG branch, whose output is V) or cross-attention over ``ctx``
        (rotary on the image queries only)."""
        kv = x if ctx is None else ctx
        v = split_heads(self.to_v(kv), self.num_heads)
        if perturbed:
            return self.to_out[0](merge_heads(v))
        q = self.norm_q(split_heads(self.to_q(x), self.num_heads))
        k = self.norm_k(split_heads(self.to_k(kv), self.num_heads))
        q = apply_rope(q, cos, sin)
        if ctx is None:
            k = apply_rope(k, cos, sin)
        return self.to_out[0](merge_heads(attention(q, k, v)))


class AdaLayerNormShift(nn.Module):
    """LayerNorm (affine) plus a shift from SiLU → Linear(temb)."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = LayerNorm(dim)
        self.linear = Linear(dim, dim)

    def forward(self, x, temb):
        return self.norm(x) + self.linear(silu(temb))[:, None]


class _Proj(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.proj = Linear(cin, cout)


class FeedForward(nn.Module):
    """ff.net.0.proj → tanh-GELU → ff.net.2 (index 1 is diffusers' dropout)."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.net = nn.ModuleList([_Proj(dim, hidden), nn.Identity(), Linear(hidden, dim)])

    def forward(self, x):
        return self.net[2](gelu_tanh(self.net[0].proj(x)))


class HunyuanDiTBlock(nn.Module):
    def __init__(self, cfg: HunyuanDiTConfig, skip: bool):
        super().__init__()
        h = cfg.hidden_size
        self.norm1 = AdaLayerNormShift(h)
        self.attn1 = Attention(h, h, cfg.num_heads)
        self.norm2 = LayerNorm(h)
        self.attn2 = Attention(h, cfg.text_dim, cfg.num_heads)
        self.norm3 = LayerNorm(h)
        self.ff = FeedForward(h, cfg.mlp_hidden)
        if skip:
            self.skip_norm = LayerNorm(2 * h)
            self.skip_linear = Linear(2 * h, h)

    def forward(self, x, ctx, temb, cos, sin, perturbed: bool = False, skip=None):
        if skip is not None:
            x = self.skip_linear(self.skip_norm(torch.cat([x, skip], dim=-1)))
        x = x + self.attn1(self.norm1(x, temb), cos, sin, perturbed=perturbed)
        x = x + self.attn2(self.norm2(x), cos, sin, ctx=ctx)
        return x + self.ff(self.norm3(x))


class _MLP2(nn.Module):
    """linear_1 → SiLU → linear_2."""

    def __init__(self, cin: int, hidden: int, cout: int):
        super().__init__()
        self.linear_1 = Linear(cin, hidden)
        self.linear_2 = Linear(hidden, cout)

    def forward(self, x):
        return self.linear_2(silu(self.linear_1(x)))


class AttentionPool(nn.Module):
    """CLIP-style attention pool over the T5 stream (8 heads), in fp32."""

    def __init__(self, seq_len: int, dim: int, out_dim: int, num_heads: int = 8):
        super().__init__()
        self.num_heads = num_heads
        self.positional_embedding = nn.Parameter(torch.empty(seq_len + 1, dim))
        self.q_proj = Linear(dim, dim)
        self.k_proj = Linear(dim, dim)
        self.v_proj = Linear(dim, dim)
        self.c_proj = Linear(dim, out_dim)

    def init_random_(self, generator):
        dim = self.positional_embedding.shape[1]
        self.positional_embedding.normal_(generator=generator).div_(dim ** 0.5)

    def forward(self, t5):
        """t5 [B, L, dim] → [B, out_dim] fp32."""
        x = t5.float()
        x = torch.cat([x.mean(dim=1, keepdim=True), x], dim=1) + self.positional_embedding[None]
        q, k, v = (split_heads(a, self.num_heads)
                   for a in (self.q_proj(x[:, :1]), self.k_proj(x), self.v_proj(x)))
        return self.c_proj(merge_heads(attention(q, k, v))[:, 0])


class _Embedding(nn.Module):
    def __init__(self, n: int, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(n, dim))

    def init_random_(self, generator):
        self.weight.normal_(generator=generator).mul_(0.02)


class TimeExtraEmbedding(nn.Module):
    """time_extra_emb: timestep embedder, T5 pooler, extra embedder (and, with
    ``use_style_meta``, the style table)."""

    def __init__(self, cfg: HunyuanDiTConfig):
        super().__init__()
        h = cfg.hidden_size
        self.timestep_embedder = _MLP2(256, h, h)
        self.pooler = AttentionPool(cfg.t5_len, cfg.t5_dim, cfg.pooled_dim)
        if cfg.use_style_meta:
            self.style_embedder = _Embedding(cfg.style_classes, 128)
        pooled_in = cfg.pooled_dim + ((256 * cfg.meta_dims + 128) if cfg.use_style_meta else 0)
        self.extra_embedder = _MLP2(pooled_in, 4 * h, h)


class PatchEmbed(nn.Module):
    """pos_embed.proj: the patch-stride conv [h, C, p, p], applied as one
    product over flattened (p_row, p_col, C) patches."""

    def __init__(self, cfg: HunyuanDiTConfig):
        super().__init__()
        self.patch = cfg.patch_size
        self.proj = Conv2d(cfg.in_channels, cfg.hidden_size, cfg.patch_size)

    def forward(self, x):
        """x [B, H, W, C] NHWC → tokens [B, (H/p)(W/p), hidden]."""
        b, hh, ww, c = x.shape
        p = self.patch
        xt = x.reshape(b, hh // p, p, ww // p, p, c).permute(0, 1, 3, 2, 4, 5)
        w = self.proj.weight.permute(0, 2, 3, 1).reshape(self.proj.weight.shape[0], -1)
        return dense(xt.reshape(b, (hh // p) * (ww // p), p * p * c), w, self.proj.bias)


class _NormOut(nn.Module):
    def __init__(self, h: int):
        super().__init__()
        self.linear = Linear(h, 2 * h)


class HunyuanDiT2DModel(nn.Module):
    def __init__(self, cfg: HunyuanDiTConfig = V1_1):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        self.pos_embed = PatchEmbed(cfg)
        self.text_embedder = _MLP2(cfg.t5_dim, 4 * cfg.t5_dim, cfg.text_dim)
        self.text_embedding_padding = nn.Parameter(
            torch.empty(cfg.text_len + cfg.t5_len, cfg.text_dim))
        self.time_extra_emb = TimeExtraEmbedding(cfg)
        self.blocks = nn.ModuleList([HunyuanDiTBlock(cfg, skip=i >= cfg.n_pre)
                                     for i in range(cfg.depth)])
        self.norm_out = _NormOut(h)
        self.proj_out = Linear(h, cfg.patch_size ** 2 * cfg.out_channels)

    def init_random_(self, generator):
        self.text_embedding_padding.normal_(generator=generator).mul_(0.02)

    def build_context(self, clip_states, clip_mask, t5_states, t5_mask):
        """Joint text context [B, text_len + t5_len, text_dim] fp32 with the
        learned padding rows where the mask is 0, and the pooled T5 [B,
        pooled_dim] fp32."""
        t5_proj = self.text_embedder(t5_states.float())
        ctx = torch.cat([clip_states.float(), t5_proj], dim=1)
        mask = torch.cat([clip_mask, t5_mask], dim=1)[..., None]
        ctx = torch.where(mask > 0, ctx, self.text_embedding_padding[None].float())
        return ctx, self.time_extra_emb.pooler(t5_states)

    def forward(self, x: torch.Tensor, t: torch.Tensor, ctx: torch.Tensor, pooled: torch.Tensor,
                image_meta_size: Optional[torch.Tensor] = None,
                style: Optional[torch.Tensor] = None, pag: bool = False) -> torch.Tensor:
        """One denoise step. x [B, H, W, C] latents (NHWC, its dtype is the
        working dtype); t [B] integer timesteps; ctx [B, 333, text_dim];
        pooled [B, pooled_dim]; image_meta_size [B, 6]; style [B] int.
        ``pag``: the perturbed branch (V as the self-attention output in
        ``cfg.pag_layers``). → [B, H, W, out_channels]."""
        cfg, te = self.cfg, self.time_extra_emb
        b, hh, ww, _ = x.shape
        p = cfg.patch_size
        gh, gw = hh // p, ww // p
        h = self.pos_embed(x)
        # integer DDPM timesteps: time_factor 1, [cos | sin]
        temb = te.timestep_embedder(timestep_embedding(t, 256, time_factor=1.0).to(h.dtype))
        if cfg.use_style_meta:
            meta = (image_meta_size if image_meta_size is not None
                    else torch.zeros(b, cfg.meta_dims, device=x.device))
            meta_emb = timestep_embedding(meta.reshape(-1), 256, time_factor=1.0).reshape(
                b, cfg.meta_dims * 256)
            idx = style if style is not None else torch.zeros(b, dtype=torch.long, device=x.device)
            extra = torch.cat([pooled.float(), meta_emb, te.style_embedder.weight[idx].float()],
                              dim=-1).to(h.dtype)
        else:
            extra = pooled.to(h.dtype)
        temb = temb + te.extra_embedder(extra)
        cos, sin = rope_2d(cfg.head_dim, gh, gw, device=x.device)
        ctx = ctx.to(h.dtype)

        stack = []
        for i, blk in enumerate(self.blocks):
            perturbed = pag and i in cfg.pag_layers
            if i < cfg.n_pre:
                h = blk(h, ctx, temb, cos, sin, perturbed)
                stack.append(h)
            else:  # the skip stack takes layers n_pre-3 .. 0, in that order
                h = blk(h, ctx, temb, cos, sin, perturbed, skip=stack[2 * cfg.n_pre - 3 - i])
        # AdaLayerNormContinuous: (scale, shift), in that order
        scale, shift = self.norm_out.linear(silu(temb)).chunk(2, dim=-1)
        h = (1.0 + scale[:, None]) * layer_norm(h) + shift[:, None]
        out = self.proj_out(h).reshape(b, gh, gw, p, p, cfg.out_channels)
        return out.permute(0, 1, 3, 2, 4, 5).reshape(b, hh, ww, cfg.out_channels)
