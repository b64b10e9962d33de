"""CLIP vision transformer, the additional tower of the Dual conditioner
(port of hunyuan3d2_tpu/models/clip_vit.py).

Pre-LN ViT with quick-GELU MLPs; returns ``last_hidden_state``, the encoder
output without the final post-LayerNorm (HF semantics). Modules carry the HF
``CLIPVisionModel`` parameter names under ``vision_model.``, so a checkpoint's
state dict loads as it is. The patch embedding is one matmul over patches
flattened channel-major (c, py, px), the conv weight's order.

Attention at head size 64 or 128 goes to the flash kernel
(``ops/flash_attention.py``, kernel 1) directly: ViT-L/14 at 224 has 257
tokens, under the 512-token gate of ``ops.attention.attention``, which the
kernel does not need. Its scale, 1/sqrt(64), is a power of two, so folding
it into q rounds nothing. Other head sizes take ``ops.attention.sdpa``.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from hunyuan3d2_tpu_torch.ops.attention import merge_heads, sdpa, split_heads
from hunyuan3d2_tpu_torch.ops.flash_attention import flash_attention
from hunyuan3d2_tpu_torch.ops.nn import LayerNorm, Linear, dense


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    patch_size: int = 14
    image_size: int = 224
    intermediate_size: int = 4096
    ln_eps: float = 1e-5

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def seq_len(self) -> int:
        return self.num_patches + 1


LARGE = CLIPVisionConfig()
TINY = CLIPVisionConfig(hidden_size=64, num_layers=2, num_heads=4, patch_size=14, image_size=56,
                        intermediate_size=128)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class _Module(nn.Module):
    """Attribute bag for the checkpoint's intermediate name levels."""


class Embeddings(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        h, p = cfg.hidden_size, cfg.patch_size
        self.class_embedding = nn.Parameter(torch.empty(h))
        self.patch_embedding = _Module()
        self.patch_embedding.weight = nn.Parameter(torch.empty(h, 3, p, p, dtype=torch.bfloat16))
        self.position_embedding = _Module()
        self.position_embedding.weight = nn.Parameter(torch.empty(cfg.seq_len, h))


class EncoderLayer(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        h = cfg.hidden_size
        self.num_heads = cfg.num_heads
        self.layer_norm1 = LayerNorm(h, cfg.ln_eps)
        self.self_attn = _Module()
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            setattr(self.self_attn, n, Linear(h, h))
        self.layer_norm2 = LayerNorm(h, cfg.ln_eps)
        self.mlp = _Module()
        self.mlp.fc1 = Linear(h, cfg.intermediate_size)
        self.mlp.fc2 = Linear(cfg.intermediate_size, h)

    def forward(self, x):
        att = self.self_attn
        h = self.layer_norm1(x)
        q, k, v = (split_heads(p(h), self.num_heads).contiguous()
                   for p in (att.q_proj, att.k_proj, att.v_proj))
        a = flash_attention(q, k, v) if q.shape[-1] in (64, 128) else sdpa(q, k, v)
        x = x + att.out_proj(merge_heads(a))
        return x + self.mlp.fc2(quick_gelu(self.mlp.fc1(self.layer_norm2(x))))


class VisionTransformer(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.embeddings = Embeddings(cfg)
        self.pre_layrnorm = LayerNorm(cfg.hidden_size, cfg.ln_eps)  # sic: HF's name
        self.encoder = _Module()
        self.encoder.layers = nn.ModuleList([EncoderLayer(cfg) for _ in range(cfg.num_layers)])


class CLIPVisionModel(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig = LARGE):
        super().__init__()
        self.cfg = cfg
        self.vision_model = VisionTransformer(cfg)

    @torch.no_grad()
    def init_random_(self, generator: torch.Generator):
        """Patch and token parameters in the JAX package's scheme (Linear
        and LayerNorm parameters are set by ops.nn.init_random_)."""
        emb = self.vision_model.embeddings
        w = emb.patch_embedding.weight
        bound = 1.0 / (w[0].numel() ** 0.5)
        w.uniform_(-bound, bound, generator=generator)
        emb.class_embedding.normal_(0.0, 0.02, generator=generator)
        emb.position_embedding.weight.normal_(0.0, 0.02, generator=generator)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """pixel_values [B, H, W, 3] CLIP-normalised → last_hidden_state
        [B, 1 + num_patches, hidden]."""
        from hunyuan3d2_tpu_torch.models.dinov2 import patchify

        cfg, vm = self.cfg, self.vision_model
        emb = vm.embeddings
        tokens = dense(patchify(pixel_values, cfg.patch_size),
                       emb.patch_embedding.weight.reshape(cfg.hidden_size, -1))
        cls = emb.class_embedding.to(tokens.dtype).expand(tokens.shape[0], 1, cfg.hidden_size)
        x = torch.cat([cls, tokens], dim=1) + emb.position_embedding.weight.to(tokens.dtype)
        x = vm.pre_layrnorm(x)
        for layer in vm.encoder.layers:
            x = layer(x)
        return x
