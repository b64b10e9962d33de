"""DINOv2 ViT image encoder (port of hunyuan3d2_tpu/models/dinov2.py).

Giant: 1536 hidden, 40 layers, 24 heads, patch 14, SwiGLU FFN, LayerScale
(the conditioner of every Hunyuan3D-2 shape model). With
``use_swiglu_ffn=False`` the FFN is the plain MLP of the HF ViT-S/B/L
configs: fc1 → exact GELU → fc2, ``mlp_ratio`` × hidden wide.
Modules carry the HF ``Dinov2Model`` parameter names, so a checkpoint's
state dict loads as it is. The patch embedding is one matmul over patches
flattened channel-major (c, py, px), the order of the conv weight's
``reshape(hidden, c*p*p)``. The public function takes NHWC pixels, as the
JAX one does.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from hunyuan3d2_tpu_torch.ops.attention import attention, merge_heads, split_heads
from hunyuan3d2_tpu_torch.ops.nn import LayerNorm, Linear, dense, gelu_exact, silu


@dataclasses.dataclass(frozen=True)
class DinoConfig:
    hidden_size: int = 1536
    num_layers: int = 40
    num_heads: int = 24
    patch_size: int = 14
    image_size: int = 518
    swiglu_hidden: int = 4096
    num_channels: int = 3
    use_swiglu_ffn: bool = True
    mlp_ratio: int = 4

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def seq_len(self) -> int:
        return self.num_patches + 1  # +CLS


GIANT = DinoConfig()


class _Module(nn.Module):
    """Attribute bag for the checkpoint's intermediate name levels."""


class _PatchEmbeddings(nn.Module):
    def __init__(self, cfg: DinoConfig):
        super().__init__()
        self.projection = _Module()
        c, p, h = cfg.num_channels, cfg.patch_size, cfg.hidden_size
        self.projection.weight = nn.Parameter(torch.empty(h, c, p, p, dtype=torch.bfloat16))
        self.projection.bias = nn.Parameter(torch.empty(h, dtype=torch.bfloat16))


class Embeddings(nn.Module):
    def __init__(self, cfg: DinoConfig):
        super().__init__()
        self.cls_token = nn.Parameter(torch.empty(1, 1, cfg.hidden_size))
        self.position_embeddings = nn.Parameter(torch.empty(1, cfg.seq_len, cfg.hidden_size))
        self.patch_embeddings = _PatchEmbeddings(cfg)


class SwiGLUFFN(nn.Module):
    def __init__(self, cfg: DinoConfig):
        super().__init__()
        self.weights_in = Linear(cfg.hidden_size, 2 * cfg.swiglu_hidden)
        self.weights_out = Linear(cfg.swiglu_hidden, cfg.hidden_size)

    def forward(self, x):
        x1, x2 = self.weights_in(x).chunk(2, dim=-1)
        return self.weights_out(silu(x1) * x2)


class Mlp(nn.Module):
    """The plain FFN (HF ``Dinov2MLP``): fc1 → exact (erf) GELU → fc2."""

    def __init__(self, cfg: DinoConfig):
        super().__init__()
        self.fc1 = Linear(cfg.hidden_size, cfg.mlp_ratio * cfg.hidden_size)
        self.fc2 = Linear(cfg.mlp_ratio * cfg.hidden_size, cfg.hidden_size)

    def forward(self, x):
        return self.fc2(gelu_exact(self.fc1(x)))


class LayerScale(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.lambda1 = nn.Parameter(torch.empty(dim))


class Layer(nn.Module):
    def __init__(self, cfg: DinoConfig):
        super().__init__()
        h = cfg.hidden_size
        self.num_heads = cfg.num_heads
        self.norm1 = LayerNorm(h)
        self.attention = _Module()
        self.attention.attention = _Module()
        self.attention.attention.query = Linear(h, h)
        self.attention.attention.key = Linear(h, h)
        self.attention.attention.value = Linear(h, h)
        self.attention.output = _Module()
        self.attention.output.dense = Linear(h, h)
        self.layer_scale1 = LayerScale(h)
        self.norm2 = LayerNorm(h)
        self.mlp = SwiGLUFFN(cfg) if cfg.use_swiglu_ffn else Mlp(cfg)
        self.layer_scale2 = LayerScale(h)

    def forward(self, x):
        att = self.attention.attention
        h = self.norm1(x)
        q = split_heads(att.query(h), self.num_heads)
        k = split_heads(att.key(h), self.num_heads)
        v = split_heads(att.value(h), self.num_heads)
        a = merge_heads(attention(q, k, v))
        x = x + self.attention.output.dense(a) * self.layer_scale1.lambda1.to(x.dtype)
        return x + self.mlp(self.norm2(x)) * self.layer_scale2.lambda1.to(x.dtype)


class Encoder(nn.Module):
    def __init__(self, cfg: DinoConfig):
        super().__init__()
        self.layer = nn.ModuleList([Layer(cfg) for _ in range(cfg.num_layers)])


def patchify(x: torch.Tensor, patch: int) -> torch.Tensor:
    """[B, H, W, C] → [B, (H/p)*(W/p), C*p*p], flattened (c, py, px)."""
    b, h, w, c = x.shape
    gh, gw = h // patch, w // patch
    x = x.reshape(b, gh, patch, gw, patch, c).permute(0, 1, 3, 5, 2, 4)
    return x.reshape(b, gh * gw, c * patch * patch)


class Dinov2Model(nn.Module):
    def __init__(self, cfg: DinoConfig = GIANT):
        super().__init__()
        self.cfg = cfg
        self.embeddings = Embeddings(cfg)
        self.encoder = Encoder(cfg)
        self.layernorm = LayerNorm(cfg.hidden_size)

    @torch.no_grad()
    def init_random_(self, generator: torch.Generator):
        """Conv and token parameters in the JAX package's scheme (Linear
        layers are drawn by ops.nn.init_random_)."""
        proj = self.embeddings.patch_embeddings.projection
        bound = 1.0 / (proj.weight[0].numel() ** 0.5)
        proj.weight.uniform_(-bound, bound, generator=generator)
        proj.bias.uniform_(-bound, bound, generator=generator)
        self.embeddings.cls_token.normal_(0.0, 0.02, generator=generator)
        self.embeddings.position_embeddings.normal_(0.0, 0.02, generator=generator)
        for layer in self.encoder.layer:
            layer.layer_scale1.lambda1.fill_(1.0)
            layer.layer_scale2.lambda1.fill_(1.0)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """pixel_values [B, H, W, C] normalized → last_hidden_state
        [B, 1 + num_patches, hidden]."""
        cfg = self.cfg
        emb = self.embeddings
        proj = emb.patch_embeddings.projection
        tokens = dense(patchify(pixel_values, cfg.patch_size),
                       proj.weight.reshape(cfg.hidden_size, -1), proj.bias)
        cls = emb.cls_token.to(tokens.dtype).expand(tokens.shape[0], 1, cfg.hidden_size)
        x = torch.cat([cls, tokens], dim=1) + emb.position_embeddings.to(tokens.dtype)
        for layer in self.encoder.layer:
            x = layer(x)
        return self.layernorm(x)
