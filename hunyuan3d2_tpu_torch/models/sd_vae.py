"""SD image VAE (AutoencoderKL), NHWC (port of
hunyuan3d2_tpu/models/sd_vae.py).

Encoder with block_out (128, 256, 512, 512) × 2 resnets + a mid attention →
2·4 latent moments; decoder mirror; scaling factor 0.18215. Modules carry
the diffusers AutoencoderKL state-dict names (encoder.down_blocks.N.resnets.M,
encoder.down_blocks.N.downsamplers.0.conv, quant_conv, post_quant_conv,
decoder.up_blocks.N.upsamplers.0.conv, ...).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from hunyuan3d2_tpu_torch.ops.conv import (
    Attention2d,
    Conv2d,
    GroupNorm,
    ResnetBlock,
    upsample_nearest2x,
)
from hunyuan3d2_tpu_torch.ops.nn import silu


@dataclasses.dataclass(frozen=True)
class SDVAEConfig:
    in_channels: int = 3
    latent_channels: int = 4
    block_out_channels: tuple = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    scaling_factor: float = 0.18215


DEFAULT = SDVAEConfig()
TINY = SDVAEConfig(block_out_channels=(32, 32), layers_per_block=1)


class _Sampler(nn.Module):
    """Holds the ``conv`` of a diffusers Downsample2D / Upsample2D."""

    def __init__(self, c: int):
        super().__init__()
        self.conv = Conv2d(c, c, 3)


class _Block(nn.Module):
    def __init__(self, chans, down: bool, sample: bool):
        super().__init__()
        self.resnets = nn.ModuleList([ResnetBlock(a, b) for a, b in chans])
        if sample:
            setattr(self, "downsamplers" if down else "upsamplers",
                    nn.ModuleList([_Sampler(chans[-1][1])]))


class _Mid(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.resnets = nn.ModuleList([ResnetBlock(c, c), ResnetBlock(c, c)])
        self.attentions = nn.ModuleList([Attention2d(c)])

    def forward(self, x, g: int):
        x = self.resnets[0](x, num_groups=g)
        x = self.attentions[0](x, g)
        return self.resnets[1](x, num_groups=g)


class Encoder(nn.Module):
    def __init__(self, cfg: SDVAEConfig):
        super().__init__()
        chs = cfg.block_out_channels
        self.conv_in = Conv2d(cfg.in_channels, chs[0], 3)
        blocks, c_in = [], chs[0]
        for i, c_out in enumerate(chs):
            blocks.append(_Block([(c_in if j == 0 else c_out, c_out)
                                  for j in range(cfg.layers_per_block)],
                                 down=True, sample=i < len(chs) - 1))
            c_in = c_out
        self.down_blocks = nn.ModuleList(blocks)
        self.mid_block = _Mid(c_in)
        self.conv_norm_out = GroupNorm(c_in)
        self.conv_out = Conv2d(c_in, 2 * cfg.latent_channels, 3)


class Decoder(nn.Module):
    def __init__(self, cfg: SDVAEConfig):
        super().__init__()
        chs = cfg.block_out_channels
        self.conv_in = Conv2d(cfg.latent_channels, chs[-1], 3)
        self.mid_block = _Mid(chs[-1])
        blocks, c_in = [], chs[-1]
        for i, c_out in enumerate(reversed(chs)):
            blocks.append(_Block([(c_in if j == 0 else c_out, c_out)
                                  for j in range(cfg.layers_per_block + 1)],
                                 down=False, sample=i < len(chs) - 1))
            c_in = c_out
        self.up_blocks = nn.ModuleList(blocks)
        self.conv_norm_out = GroupNorm(c_in)
        self.conv_out = Conv2d(c_in, cfg.in_channels, 3)


class AutoencoderKL(nn.Module):
    def __init__(self, cfg: SDVAEConfig = DEFAULT):
        super().__init__()
        self.cfg = cfg
        lc = cfg.latent_channels
        self.encoder = Encoder(cfg)
        self.quant_conv = Conv2d(2 * lc, 2 * lc, 1)
        self.post_quant_conv = Conv2d(lc, lc, 1)
        self.decoder = Decoder(cfg)

    def encode_moments(self, images: torch.Tensor) -> torch.Tensor:
        """images [B, H, W, 3] in [-1, 1] → moments [B, h, w, 2·latent]
        (mean | logvar)."""
        e, g = self.encoder, self.cfg.norm_num_groups
        x = e.conv_in(images)
        for blk in e.down_blocks:
            for r in blk.resnets:
                x = r(x, num_groups=g)
            if hasattr(blk, "downsamplers"):
                # diffusers pads (0, 1, 0, 1) then a stride-2 VALID conv
                x = F.pad(x, (0, 0, 0, 1, 0, 1))
                x = blk.downsamplers[0].conv(x, stride=2, padding="valid")
        x = e.mid_block(x, g)
        x = e.conv_out(silu(e.conv_norm_out(x, g)))
        return self.quant_conv(x)

    def encode(self, images: torch.Tensor) -> torch.Tensor:
        """→ scaled latents [B, h, w, latent], the mode (mean) of the
        posterior."""
        mean = self.encode_moments(images)[..., :self.cfg.latent_channels]
        return mean * self.cfg.scaling_factor

    def decode(self, latents: torch.Tensor) -> torch.Tensor:
        """Scaled latents [B, h, w, latent] → images [B, H, W, 3] in [-1, 1]."""
        d, g = self.decoder, self.cfg.norm_num_groups
        x = self.post_quant_conv(latents / self.cfg.scaling_factor)
        x = d.conv_in(x)
        x = d.mid_block(x, g)
        for blk in d.up_blocks:
            for r in blk.resnets:
                x = r(x, num_groups=g)
            if hasattr(blk, "upsamplers"):
                x = blk.upsamplers[0].conv(upsample_nearest2x(x))
        return d.conv_out(silu(d.conv_norm_out(x, g)))


def flops(cfg: SDVAEConfig, h: int, w: int, batch: int = 1, direction: str = "encode") -> float:
    """Conv and attention FLOPs of one :meth:`AutoencoderKL.encode` (h, w the
    image size) or :meth:`AutoencoderKL.decode` (h, w the latent size) of
    ``batch`` images: 2·k²·c_in·c_out a pixel per conv, 4·T²·c for the
    single-head mid attention; norms and elementwise work are not counted.
    The JAX package's float for the same config fields
    (hunyuan3d2_tpu/models/sd_vae.py ``flops``)."""
    chs = cfg.block_out_channels
    n = len(chs)

    def conv(cin, cout, k, pix):
        return 2.0 * k * k * cin * cout * pix * batch

    def res(cin, cout, pix):
        r = conv(cin, cout, 3, pix) + conv(cout, cout, 3, pix)
        if cin != cout:
            r += conv(cin, cout, 1, pix)
        return r

    def attn(c, pix):
        return 4 * conv(c, c, 1, pix) + 4.0 * pix * pix * c * batch

    pix = h * w
    if direction == "encode":
        f = conv(cfg.in_channels, chs[0], 3, pix)
        c_in = chs[0]
        for i, c_out in enumerate(chs):
            for j in range(cfg.layers_per_block):
                f += res(c_in if j == 0 else c_out, c_out, pix)
            if i < n - 1:
                pix //= 4
                f += conv(c_out, c_out, 3, pix)
            c_in = c_out
        f += 2 * res(c_in, c_in, pix) + attn(c_in, pix)
        f += conv(c_in, 2 * cfg.latent_channels, 3, pix)
        f += conv(2 * cfg.latent_channels, 2 * cfg.latent_channels, 1, pix)
    else:
        f = conv(cfg.latent_channels, cfg.latent_channels, 1, pix)
        f += conv(cfg.latent_channels, chs[-1], 3, pix)
        f += 2 * res(chs[-1], chs[-1], pix) + attn(chs[-1], pix)
        c_in = chs[-1]
        for i, c_out in enumerate(reversed(chs)):
            for j in range(cfg.layers_per_block + 1):
                f += res(c_in if j == 0 else c_out, c_out, pix)
            if i < n - 1:
                pix *= 4
                f += conv(c_out, c_out, 3, pix)
            c_in = c_out
        f += conv(c_in, cfg.in_channels, 3, pix)
    return f
