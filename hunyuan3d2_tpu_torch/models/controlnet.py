"""ControlNet for the SD-class UNets, NHWC (port of
hunyuan3d2_tpu/models/controlnet.py).

diffusers ControlNetModel as the reference's alignment helpers build it
('control_v11f1p_sd15_depth' on SD1.5): a copy of the UNet's conv_in, time
embedding, down blocks and mid block, plus

* the conditioning embedder (``controlnet_cond_embedding``): conv_in, then
  pairs of a stride-1 conv (SAME padding) and a stride-2 conv (padding 1)
  taking the [0, 1] control image down 8× to the latent size, and a
  zero-initialised conv_out;
* a zero-initialised 1×1 conv per skip (``controlnet_down_blocks``) and one
  for the mid output (``controlnet_mid_block``), their outputs scaled by
  ``conditioning_scale``.

At init every residual is 0, so a UNet fed them gives its plain output. The
embedder's conv_out and the zero convs hold fp32 weights, as the JAX
package's loader keeps them. Their weights are rounded to the activations'
dtype (bf16) for each product, as in the JAX package, so the fp32 storage
keeps only the bias's precision: it is added in fp32 before the output's one
rounding (ops/conv.conv2d), on the card as on the CPU. The scaled residuals
come out in fp32.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from hunyuan3d2_tpu_torch.models.paint_unet import (
    PaintUNetConfig,
    _Mid,
    _TimestepEmbedding,
    _UpDownBlock,
    dual_config,
    sd_timestep_embedding,
)
from hunyuan3d2_tpu_torch.ops.conv import Conv2d
from hunyuan3d2_tpu_torch.ops.nn import silu

# SD1.5-class ControlNet: 4-channel sample, cross 768, 8 heads a block, the
# plain UNet's flags (no 2.5D attentions)
SD15 = dataclasses.replace(dual_config(PaintUNetConfig()), cross_attention_dim=768, num_heads=8)
TINY = dataclasses.replace(
    dual_config(PaintUNetConfig(block_out_channels=(32, 64), layers_per_block=1,
                                cross_attention_dim=32, attention_head_dim=8, norm_num_groups=8)),
    num_heads=2)

# diffusers ControlNetConditioningEmbedding's default channel ladder
COND_CHANNELS = (16, 32, 96, 256)


class ZeroConv2d(Conv2d):
    """An fp32 conv whose random init is zero."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 1):
        super().__init__(in_ch, out_ch, kernel, dtype=torch.float32)

    def init_random_(self, generator):
        self.weight.zero_()
        self.bias.zero_()


class CondEmbedding(nn.Module):
    def __init__(self, cond_channels: int, out_ch: int):
        super().__init__()
        c = COND_CHANNELS
        self.conv_in = Conv2d(cond_channels, c[0], 3)
        self.blocks = nn.ModuleList([Conv2d(c[i // 2], c[(i + 1) // 2], 3)
                                     for i in range(2 * (len(c) - 1))])
        self.conv_out = ZeroConv2d(c[-1], out_ch, 3)

    def forward(self, cond_image: torch.Tensor) -> torch.Tensor:
        """[B, H, W, C] in [0, 1] → [B, H/8, W/8, out_ch]."""
        x = silu(self.conv_in(cond_image))
        for i, conv in enumerate(self.blocks):
            x = silu(conv(x, stride=2, padding=1) if i % 2 else conv(x))
        return self.conv_out(x)


class ControlNet(nn.Module):
    def __init__(self, cfg: PaintUNetConfig = SD15, cond_channels: int = 3):
        super().__init__()
        self.cfg = cfg
        chs = cfg.block_out_channels
        n = len(chs)
        self.conv_in = Conv2d(cfg.in_channels, chs[0], 3)
        self.time_embedding = _TimestepEmbedding(chs[0], cfg.time_embed_dim)
        self.controlnet_cond_embedding = CondEmbedding(cond_channels, chs[0])
        down, zero, c_in = [], [ZeroConv2d(chs[0], chs[0])], chs[0]
        for i, c_out in enumerate(chs):
            down.append(_UpDownBlock(
                cfg, [(c_in if j == 0 else c_out, c_out) for j in range(cfg.layers_per_block)],
                c_out if cfg.is_cross(i, down=True) else None, False,
                "downsamplers" if i < n - 1 else ""))
            zero += [ZeroConv2d(c_out, c_out)
                     for _ in range(cfg.layers_per_block + (1 if i < n - 1 else 0))]
            c_in = c_out
        self.down_blocks = nn.ModuleList(down)
        self.mid_block = _Mid(cfg, chs[-1], False)
        self.controlnet_down_blocks = nn.ModuleList(zero)
        self.controlnet_mid_block = ZeroConv2d(chs[-1], chs[-1])

    def forward(self, sample, t, context, cond_image, conditioning_scale=1.0, ip_context=None,
                ip_scale=1.0):
        """sample [B, h, w, C_in] (scaled by the scheduler), t [B], context
        [B, 77, D], cond_image [B, 8h, 8w, C] in [0, 1] → (down residuals,
        one per skip of the UNet, and the mid residual), fp32, for
        ``UNetCore.forward(ctrl_down=…, ctrl_mid=…)``."""
        cfg = self.cfg
        g = cfg.norm_num_groups
        temb = sd_timestep_embedding(t, cfg.block_out_channels[0]).to(sample.dtype)
        temb = self.time_embedding.linear_2(silu(self.time_embedding.linear_1(temb)))
        x = self.conv_in(sample)
        x = x + self.controlnet_cond_embedding(cond_image.to(sample.dtype)).to(x.dtype)

        def attn(mod, x, layer):
            return mod(x, context, layer, "r", 1, {}, 1.0, 1.0, None, ip_context, ip_scale)

        residuals = [x]
        for i, blk in enumerate(self.down_blocks):
            for j, r in enumerate(blk.resnets):
                x = r(x, temb, g, eps=1e-5)
                if len(blk.attentions):
                    x = attn(blk.attentions[j], x, f"down_{i}_{j}")
                residuals.append(x)
            if hasattr(blk, "downsamplers"):
                x = blk.downsamplers[0].conv(x, stride=2, padding=1)
                residuals.append(x)
        x = self.mid_block.resnets[0](x, temb, g, eps=1e-5)
        x = attn(self.mid_block.attentions[0], x, "mid_0")
        x = self.mid_block.resnets[1](x, temb, g, eps=1e-5)
        s = float(conditioning_scale)
        down = [zc(r).float() * s for zc, r in zip(self.controlnet_down_blocks, residuals)]
        return down, self.controlnet_mid_block(x).float() * s
