"""Attention primitives (port of hunyuan3d2_tpu/ops/attention.py).

``sdpa`` is the plain scaled-dot-product attention with an fp32 softmax.
``attention`` takes the JAX package's gate (no mask, Lq >= 512, D in
{64, 128}) and sends CUDA tensors that pass it to the hand-written flash
kernel (ops/flash_attention.py); everything else goes to ``sdpa``.
``masked_attention`` does the same with a [B, Lq, Lk] mask shared across
heads, through the masked kernel. A kernel that fails to build or launch
raises: there is no fallback around it.
"""

from __future__ import annotations

from typing import Optional

import torch

from hunyuan3d2_tpu_torch.ops.flash_attention import flash_attention, flash_attention_masked


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: Optional[float] = None,
         mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q [B, H, Lq, D], k/v [B, H, Lk, D] → [B, H, Lq, D] in q.dtype.

    Products in fp32 (inputs upcast: bf16 products are exact in fp32), scale
    applied to the fp32 logits, fp32 softmax, probabilities rounded to the
    input dtype before the P·V product."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if mask is not None:
        logits = torch.where(mask, logits, torch.finfo(torch.float32).min)
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", w.float(), v.float()).to(q.dtype)


def use_flash(q: torch.Tensor) -> bool:
    """The JAX package's flash gate (ops/attention.py:62), on CUDA tensors."""
    return q.is_cuda and q.shape[-2] >= 512 and q.shape[-1] in (64, 128)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              scale: Optional[float] = None) -> torch.Tensor:
    """Unmasked attention: the flash kernel where the gate admits it, else
    :func:`sdpa`."""
    if use_flash(q):
        return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), scale=scale)
    return sdpa(q, k, v, scale=scale)


def masked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor,
                     scale: Optional[float] = None) -> torch.Tensor:
    """Attention under a per-batch bool mask [B, Lq, Lk] shared across heads
    (the paint UNet's voxel-locality mask): the masked flash kernel where the
    gate admits it, else :func:`sdpa` with the mask."""
    if use_flash(q):
        return flash_attention_masked(q.contiguous(), k.contiguous(), v.contiguous(), mask,
                                      scale=scale)
    return sdpa(q, k, v, scale=scale, mask=mask[:, None])


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """[B, H, L, D] → [B, L, H*D]."""
    b, h, l, d = x.shape
    return x.transpose(1, 2).reshape(b, l, h * d)


def split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[B, L, H*D] → [B, H, L, D]."""
    b, l, hd = x.shape
    return x.reshape(b, l, num_heads, hd // num_heads).transpose(1, 2)


def split_qkv_fused(qkv: torch.Tensor, num_heads: int):
    """Split a fused qkv projection laid out as (K=3, H, D) on the last axis
    into q, k, v each [B, H, L, D]."""
    b, l, w = qkv.shape
    d = w // (3 * num_heads)
    x = qkv.reshape(b, l, 3, num_heads, d)
    return tuple(x[:, :, i].transpose(1, 2) for i in range(3))
