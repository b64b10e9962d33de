"""x4 super-resolution diffusion pipeline (port of
hunyuan3d2_tpu/pipelines/upscale.py).

The reference's Image_Super_Net stage: diffusers
StableDiffusionUpscalePipeline ('stabilityai/stable-diffusion-x4-upscaler'),
5 steps, empty prompt. The low-res image in [-1, 1] is DDPM-noised at
``noise_level`` (20) with the low-res scheduler's own ᾱ table and
concatenated in pixel space onto the 4 noise latents (7-channel conv_in);
the noise level is the UNet's class label; CFG 9.0 over a batch of 2; DDIM
(from the checkpoint's scheduler config); the f = 4 VAE decode gives the 4×
image. The UNet has 512-channel levels with 8 heads (head size 64), whose
attention goes through the flash kernel on the card.

Randomness comes from an explicit ``torch.Generator`` seeded by ``seed``
(the low-res noise, then the initial latents); ``lowres_noise`` and
``init_latents`` replace its draws (the tests inject the JAX package's).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from hunyuan3d2_tpu_torch.models import paint_unet, sd_vae
from hunyuan3d2_tpu_torch.ops.nn import build
from hunyuan3d2_tpu_torch.pipelines.paint_schedulers import DDIMScheduler, draw
from hunyuan3d2_tpu_torch.utils import timer
from hunyuan3d2_tpu_torch.utils.timer import timed_scope

# stabilityai/stable-diffusion-x4-upscaler UNet: 7-channel conv_in (4 latent
# + 3 image), no attention in the first down block, noise-level class labels
X4_UNET = dataclasses.replace(
    paint_unet.dual_config(paint_unet.DEFAULT), in_channels=7,
    block_out_channels=(256, 512, 512, 1024), cross_attention_dim=1024, num_heads=8,
    down_cross=(False, True, True, True), use_camera_embedding=True, class_embed_type="table",
    num_class_embeds=1000)
X4_UNET_TINY = dataclasses.replace(
    X4_UNET, block_out_channels=(32, 64), layers_per_block=1, cross_attention_dim=32,
    num_heads=2, down_cross=(False, True), norm_num_groups=8)

# the f = 4 VAE (3 blocks, 2 downsamples), scaling 0.08333
X4_VAE = dataclasses.replace(sd_vae.DEFAULT, block_out_channels=(128, 256, 512),
                             scaling_factor=0.08333)
X4_VAE_TINY = dataclasses.replace(sd_vae.TINY, block_out_channels=(32, 32, 32),
                                  scaling_factor=0.08333)


class UpscalePipeline:
    """Low-res image → 4× image; the diffusion backend of
    utils/imagesuper.Image_Super_Net (PIL → PIL), on ``device``."""

    def __init__(self, unet: paint_unet.UNetCore, vae: sd_vae.AutoencoderKL, text_embed,
                 uncond_embed=None, num_inference_steps: int = 5, guidance_scale: float = 9.0,
                 noise_level: int = 20, scheduler: Optional[DDIMScheduler] = None,
                 low_res_alphas_cumprod=None, device=None):
        self.unet = unet
        self.vae = vae
        self.device = torch.device(device if device is not None else "cuda")
        self.text_embed = torch.as_tensor(np.array(text_embed, np.float32), device=self.device)
        self.uncond_embed = (self.text_embed if uncond_embed is None else torch.as_tensor(
            np.array(uncond_embed, np.float32), device=self.device))
        self.num_inference_steps = num_inference_steps
        self.guidance_scale = guidance_scale
        self.noise_level = noise_level
        self.scheduler = scheduler if scheduler is not None else DDIMScheduler()
        # without the low_res_scheduler's config, the denoise scheduler's ᾱ
        self.low_res_alphas_cumprod = np.asarray(
            self.scheduler.alphas_cumprod() if low_res_alphas_cumprod is None
            else low_res_alphas_cumprod, np.float32)

    @classmethod
    def init_random(cls, size: str = "tiny", num_inference_steps: int = 5, device=None,
                    seed: int = 0):
        """Random weights from torch Generators seeded from ``seed``:
        ``X4_UNET`` and ``X4_VAE`` for ``size="full"``, their TINY configs
        for ``size="tiny"``; a random [77, cross] text embedding."""
        device = torch.device(device if device is not None else "cuda")
        ucfg = X4_UNET if size == "full" else X4_UNET_TINY
        vcfg = X4_VAE if size == "full" else X4_VAE_TINY

        def gen(i):
            return torch.Generator(device=device).manual_seed(seed * 3 + i)

        text = torch.randn(77, ucfg.cross_attention_dim, generator=gen(2), device=device) * 0.02
        return cls(build(paint_unet.plain_unet, ucfg, device=device, generator=gen(0)),
                   build(sd_vae.AutoencoderKL, vcfg, device=device, generator=gen(1)),
                   text.cpu().numpy(), num_inference_steps=num_inference_steps, device=device)

    @torch.no_grad()
    def denoise(self, image: torch.Tensor, lowres_noise=None, init_latents=None,
                generator=None) -> torch.Tensor:
        """image [1, h, w, 3] in [-1, 1] → the 4× image [1, 4h, 4w, 3] in
        [-1, 1], fp32."""
        dev, sched = self.device, self.scheduler
        timesteps, ac = sched.make_tables(self.num_inference_steps)
        ac = torch.from_numpy(ac).to(dev)
        lr_ac = torch.from_numpy(self.low_res_alphas_cumprod).to(dev)
        noise = draw(lowres_noise, tuple(image.shape), generator, dev)
        img = sched.add_noise(image, noise, int(self.noise_level), lr_ac)
        img2 = torch.cat([img, img])
        labels = torch.full((2,), int(self.noise_level), dtype=torch.long, device=dev)
        # the empty prompt: text and uncond are the same embedding; CFG is
        # still applied, as the reference does
        ctx2 = self.text_embed[None].expand(2, -1, -1).to(torch.bfloat16)
        b, h, w, _ = image.shape
        lat = draw(init_latents, (b, h, w, self.vae.cfg.latent_channels), generator, dev)
        for i, t in enumerate(timesteps):
            t_prev = int(timesteps[i + 1]) if i + 1 < len(timesteps) else -1
            inp = torch.cat([lat.expand(2, -1, -1, -1), img2], dim=-1).to(torch.bfloat16)
            out2 = self.unet(inp, torch.full((2,), float(t), device=dev), ctx2, labels, "r", 1,
                             {}).float()
            e_unc, e_txt = out2.chunk(2)
            lat, _ = sched.step(e_unc + self.guidance_scale * (e_txt - e_unc), lat, int(t),
                                t_prev, ac)
        out = self.vae.decode((lat * self.vae.cfg.scaling_factor).to(torch.bfloat16))
        return out.float().clamp(-1.0, 1.0)

    @timer.request("Upscale")
    def __call__(self, image, prompt: str = "", seed: int = 0, lowres_noise=None,
                 init_latents=None):
        """PIL → PIL at 4× (the reference's Image_Super_Net call). The prompt
        is not encoded: the reference always passes ""."""
        from PIL import Image

        x = np.asarray(image.convert("RGB"), np.float32) / 255.0 * 2.0 - 1.0
        generator = torch.Generator(device=self.device).manual_seed(int(seed))
        with timed_scope("Upscale Denoising"):
            out = self.denoise(torch.from_numpy(x)[None].to(self.device), lowres_noise,
                               init_latents, generator)
        out01 = (out[0].cpu().numpy() + 1.0) / 2.0
        return Image.fromarray((np.clip(out01, 0, 1) * 255).astype(np.uint8))
