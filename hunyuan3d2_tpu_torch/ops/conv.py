"""Convolution, GroupNorm and resnet primitives for the paint UNet and the SD
VAE (port of hunyuan3d2_tpu/ops/conv.py).

Activations are NHWC, as in the JAX package. A convolution runs on the
NCHW view ``x.permute(0, 3, 1, 2)`` of an NHWC tensor, which is NCHW in
``channels_last`` memory order: cuDNN takes it as it is and returns
channels_last, whose permute back to NHWC is again free. Weights keep
torch's [out, in, kh, kw] layout and the diffusers names (``weight``,
``bias``). Dtype policy as in ops/nn.py: bf16 weights, fp32 accumulation,
GroupNorm in fp32.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from hunyuan3d2_tpu_torch.ops.nn import PARAM_DTYPE, Linear, silu


def conv2d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, stride: int = 1,
           padding="same") -> torch.Tensor:
    """NHWC x, [out, in, k, k] w → NHWC in x.dtype; bias added in fp32
    before the single cast, as the JAX package's Conv2d.apply does.

    ``padding``: "same" (odd kernels, stride 1), "valid", or an int for
    symmetric padding. The weight is rounded to the activations' dtype
    first, as the JAX package casts it. On the card, with a bias of the
    activations' dtype, cuDNN runs the product in that dtype with an fp32
    accumulator and adds the bias before its one rounding. Otherwise (on the
    CPU, or an fp32 bias under bf16 activations) the product of those
    rounded operands is taken in fp32 explicitly, which is exact per term,
    and the fp32 bias is added before the one cast: the JAX package's
    rounding."""
    xc = x.permute(0, 3, 1, 2)
    pad = 0 if padding == "valid" else (w.shape[-1] // 2 if padding == "same" else padding)
    if x.is_cuda and b.dtype == x.dtype:
        y = F.conv2d(xc, w.to(x.dtype), b, stride=stride, padding=pad)
    else:
        y = F.conv2d(xc.float(), w.to(x.dtype).float(), b.float(), stride=stride,
                     padding=pad).to(x.dtype)
    return y.permute(0, 2, 3, 1)


class Conv2d(nn.Module):
    """[out, in, k, k] conv with a bias (diffusers names), bf16 unless
    ``dtype`` says otherwise. The weight is rounded to the activations'
    dtype for the product either way; an fp32 ``dtype`` keeps the bias's
    precision, added in fp32 before the output's one rounding (conv2d)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3, dtype=PARAM_DTYPE):
        super().__init__()
        self.in_ch, self.kernel = in_ch, kernel
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, kernel, kernel, dtype=dtype))
        self.bias = nn.Parameter(torch.empty(out_ch, dtype=dtype))

    def init_random_(self, generator: torch.Generator):
        bound = 1.0 / math.sqrt(self.in_ch * self.kernel * self.kernel)
        self.weight.uniform_(-bound, bound, generator=generator)
        self.bias.uniform_(-bound, bound, generator=generator)

    def forward(self, x, stride: int = 1, padding="same"):
        return conv2d(x, self.weight, self.bias, stride, padding)


def group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, num_groups: int = 32,
               eps: float = 1e-6) -> torch.Tensor:
    """GroupNorm over channel groups of an NHWC tensor, fp32 inside."""
    b, h, w, c = x.shape
    x32 = x.float().reshape(b, h * w, num_groups, c // num_groups)
    mean = x32.mean(dim=(1, 3), keepdim=True)
    var = (x32 - mean).square().mean(dim=(1, 3), keepdim=True)
    y = ((x32 - mean) * torch.rsqrt(var + eps)).reshape(b, h, w, c)
    return (y * scale.float() + bias.float()).to(x.dtype)


class GroupNorm(nn.Module):
    """fp32 ``weight``/``bias`` (diffusers names); the group count and eps are
    given by the caller, as in the JAX package."""

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c, dtype=torch.float32))
        self.bias = nn.Parameter(torch.empty(c, dtype=torch.float32))

    def init_random_(self, generator: torch.Generator):
        self.weight.fill_(1.0)
        self.bias.zero_()

    def forward(self, x, num_groups: int = 32, eps: float = 1e-6):
        return group_norm(x, self.weight, self.bias, num_groups, eps)


class ResnetBlock(nn.Module):
    """diffusers ResnetBlock2D: GN→silu→conv → (+time proj) → GN→silu→conv,
    1×1 ``conv_shortcut`` on a channel change."""

    def __init__(self, in_ch: int, out_ch: int, temb_ch: int = 0):
        super().__init__()
        self.norm1 = GroupNorm(in_ch)
        self.conv1 = Conv2d(in_ch, out_ch, 3)
        if temb_ch:
            self.time_emb_proj = Linear(temb_ch, out_ch)
        self.norm2 = GroupNorm(out_ch)
        self.conv2 = Conv2d(out_ch, out_ch, 3)
        if in_ch != out_ch:
            self.conv_shortcut = Conv2d(in_ch, out_ch, 1)

    def forward(self, x, temb: Optional[torch.Tensor] = None, num_groups: int = 32,
                eps: float = 1e-6):
        # eps: 1e-6 for the SD VAE, 1e-5 for UNet2DConditionModel
        h = self.conv1(silu(self.norm1(x, num_groups, eps)))
        if temb is not None and hasattr(self, "time_emb_proj"):
            h = h + self.time_emb_proj(silu(temb))[:, None, None, :].to(h.dtype)
        h = self.conv2(silu(self.norm2(h, num_groups, eps)))
        if hasattr(self, "conv_shortcut"):
            x = self.conv_shortcut(x)
        return x + h


def upsample_nearest2x(x: torch.Tensor) -> torch.Tensor:
    """NHWC nearest-neighbour ×2."""
    b, h, w, c = x.shape
    return x[:, :, None, :, None, :].expand(b, h, 2, w, 2, c).reshape(b, 2 * h, 2 * w, c)


class Attention2d(nn.Module):
    """Single-head (VAE-style) spatial self-attention block, diffusers names
    ``group_norm``, ``to_q``, ``to_k``, ``to_v``, ``to_out.0``. The product
    stays a plain einsum, as in the JAX package (one head of C=512)."""

    def __init__(self, c: int):
        super().__init__()
        self.group_norm = GroupNorm(c)
        self.to_q = Linear(c, c)
        self.to_k = Linear(c, c)
        self.to_v = Linear(c, c)
        self.to_out = nn.ModuleList([Linear(c, c)])

    def forward(self, x, num_groups: int = 32):
        b, h, w, c = x.shape
        y = self.group_norm(x, num_groups).reshape(b, h * w, c)
        q, k, v = self.to_q(y), self.to_k(y), self.to_v(y)
        logits = torch.einsum("bqc,bkc->bqk", q.float(), k.float()) * (c ** -0.5)
        attn = torch.softmax(logits, dim=-1).to(y.dtype)
        o = torch.einsum("bqk,bkc->bqc", attn.float(), v.float()).to(y.dtype)
        return x + self.to_out[0](o).reshape(b, h, w, c)

