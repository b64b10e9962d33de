"""Timestep and Fourier embeddings (port of hunyuan3d2_tpu/ops/embeddings.py).

* timestep_embedding — reference hunyuan3ddit.py:39-69 with the production
  quirk kept: the DiT passes time_factor=1000 into the ``max_period`` slot,
  so callers pass ``max_period=cfg.time_factor``. Layout [cos | sin].
* fourier_embed — reference FourierEmbedder: cat(x, sin(x·2^k), cos(x·2^k)),
  frequencies interleaved per input channel.
* sincos_1d_pos_embed — the multiview conditioner's view embedding.
"""

from __future__ import annotations

import math

import torch


def timestep_embedding(t: torch.Tensor, dim: int = 256, max_period: int = 10000,
                       time_factor: float = 1000.0) -> torch.Tensor:
    """t: [B] float → [B, dim] fp32, cos half first."""
    t = t.float() * time_factor
    half = dim // 2
    ar = torch.arange(half, dtype=torch.float32, device=t.device)
    freqs = torch.exp(-math.log(max_period) * ar / half)
    args = t[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


def fourier_embed(x: torch.Tensor, num_freqs: int = 8, include_pi: bool = False) -> torch.Tensor:
    """x: [..., D] → [..., D*(2*num_freqs+1)] = cat(x, sin(e), cos(e)) with
    e = (x[..., None] * 2^k).reshape(..., -1), computed in fp32 and cast to
    x.dtype."""
    freqs = 2.0 ** torch.arange(num_freqs, dtype=torch.float32, device=x.device)
    if include_pi:
        freqs = freqs * math.pi
    e = (x[..., None].float() * freqs).reshape(*x.shape[:-1], -1)
    return torch.cat([x, torch.sin(e).to(x.dtype), torch.cos(e).to(x.dtype)], dim=-1)


def fourier_out_dim(input_dim: int = 3, num_freqs: int = 8) -> int:
    return input_dim * (2 * num_freqs + 1)


def sincos_1d_pos_embed(embed_dim: int, pos: torch.Tensor) -> torch.Tensor:
    """1-D sin-cos position embedding, sin half first (the reference's
    get_1d_sincos_pos_embed_from_grid): pos [M] → [M, embed_dim] fp32."""
    if embed_dim % 2:
        raise ValueError(f"embed_dim must be even, got {embed_dim}")
    omega = torch.arange(embed_dim // 2, dtype=torch.float32, device=pos.device) / (embed_dim / 2.0)
    omega = 1.0 / 10000 ** omega
    out = pos.float()[:, None] * omega[None]
    return torch.cat([torch.sin(out), torch.cos(out)], dim=-1)
