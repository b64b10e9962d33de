"""De-lighting diffusion pipeline, InstructPix2Pix-class (port of
hunyuan3d2_tpu/pipelines/delight.py).

The reference's Light_Shadow_Remover stage: an SD1.5 UNet with an
8-channel conv_in (4 noise latents + 4 unscaled image latents), EulerAncestral
sampling (epsilon, leading spacing), prompt "", guidance 1.0 and image
guidance 1.5 at 512². Each step runs the triple-CFG batch [text | image |
uncond] through the UNet as one batch-3 call, the image latents zeroed on
the uncond row; the guidance combine and the step are fp32, the UNet bf16.
The text context is a constant [77, 768] embedding of "" (computed once at
load through ``transformers``' CLIPTextModel, or random for tests).

Randomness comes from an explicit ``torch.Generator`` seeded by ``seed``;
``init_latents`` and ``step_noises`` replace its draws (the tests inject the
JAX package's).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from hunyuan3d2_tpu_torch.models import paint_unet, sd_vae
from hunyuan3d2_tpu_torch.ops.nn import build
from hunyuan3d2_tpu_torch.pipelines.paint_schedulers import (
    EulerAncestralDiscreteScheduler,
    draw,
    init_noise_sigma,
)
from hunyuan3d2_tpu_torch.utils import timer
from hunyuan3d2_tpu_torch.utils.timer import timed_scope

# SD1.5 InstructPix2Pix UNet: 8-channel conv_in, cross 768, 8 heads a block
IP2P_UNET = dataclasses.replace(paint_unet.dual_config(paint_unet.DEFAULT), in_channels=8,
                                cross_attention_dim=768, num_heads=8)
IP2P_UNET_TINY = dataclasses.replace(paint_unet.dual_config(paint_unet.TINY), in_channels=8,
                                     cross_attention_dim=32, num_heads=2)

# the stock SD1.5 EulerAncestral config: epsilon, leading spacing with
# steps_offset 1, no zero-SNR rescale
IP2P_SCHEDULER = EulerAncestralDiscreteScheduler(
    prediction_type="epsilon", timestep_spacing="leading", rescale_betas_zero_snr=False,
    steps_offset=1)


class DelightPipeline:
    """Image → evenly lit image; the diffusion backend of
    utils/dehighlight.Light_Shadow_Remover (rgb01 array → rgb01 array), on
    ``device``."""

    def __init__(self, unet: paint_unet.UNetCore, vae: sd_vae.AutoencoderKL, text_embed,
                 num_inference_steps: int = 50, guidance_scale: float = 1.0,
                 image_guidance_scale: float = 1.5, resolution: int = 512, device=None):
        self.unet = unet
        self.vae = vae
        self.device = torch.device(device if device is not None else "cuda")
        self.text_embed = torch.as_tensor(np.array(text_embed, np.float32), device=self.device)
        self.num_inference_steps = num_inference_steps
        self.guidance_scale = guidance_scale
        self.image_guidance_scale = image_guidance_scale
        self.resolution = resolution

    @classmethod
    def init_random(cls, size: str = "tiny", resolution: int = 64,
                    num_inference_steps: int = 50, device=None, seed: int = 0):
        """Random weights from torch Generators seeded from ``seed``:
        ``IP2P_UNET`` (≈ 0.86 B parameters) and the SD VAE ``DEFAULT`` for
        ``size="full"``, their TINY configs for ``size="tiny"``; a random
        [77, cross] text embedding."""
        device = torch.device(device if device is not None else "cuda")
        ucfg = IP2P_UNET if size == "full" else IP2P_UNET_TINY
        vcfg = sd_vae.DEFAULT if size == "full" else sd_vae.TINY

        def gen(i):
            return torch.Generator(device=device).manual_seed(seed * 3 + i)

        text = torch.randn(77, ucfg.cross_attention_dim, generator=gen(2), device=device) * 0.02
        return cls(build(paint_unet.plain_unet, ucfg, device=device, generator=gen(0)),
                   build(sd_vae.AutoencoderKL, vcfg, device=device, generator=gen(1)),
                   text.cpu().numpy(), num_inference_steps=num_inference_steps,
                   resolution=resolution, device=device)

    @classmethod
    def from_pretrained(cls, ckpt_path: str, device=None, **kwargs):
        """A diffusers InstructPix2Pix directory (``unet/``, ``vae/``,
        ``text_encoder/``, ``tokenizer/``) on ``device`` (``cuda`` unless the
        caller passes another); the "" embedding is computed once through
        ``transformers``."""
        from hunyuan3d2_tpu_torch.io import checkpoints

        return checkpoints.load_delight_pipeline(cls, ckpt_path, device=device, **kwargs)

    @torch.no_grad()
    def denoise(self, image: torch.Tensor, init_latents=None, step_noises=None,
                generator=None) -> torch.Tensor:
        """image [1, r, r, 3] in [-1, 1] → the delit image [1, r, r, 3] in
        [-1, 1], fp32."""
        dev = self.device
        sched = IP2P_SCHEDULER
        timesteps, sigmas = sched.make_tables(self.num_inference_steps)
        # IP2P conditions on the unscaled posterior mean (diffusers
        # prepare_image_latents: .mode(), no scaling_factor)
        lc = self.vae.cfg.latent_channels
        img_lat = self.vae.encode_moments(image.to(torch.bfloat16)).float()[..., :lc]
        img_lat3 = torch.cat([img_lat, img_lat, torch.zeros_like(img_lat)])
        ctx3 = self.text_embed[None].expand(3, -1, -1).to(torch.bfloat16)
        lat = draw(init_latents, tuple(img_lat.shape), generator, dev)
        lat = lat * init_noise_sigma(sigmas[0])
        g, gi = self.guidance_scale, self.image_guidance_scale
        for i, t in enumerate(timesteps):
            lmi = sched.scale_model_input(lat.expand(3, -1, -1, -1), sigmas[i])
            inp = torch.cat([lmi, img_lat3], dim=-1).to(torch.bfloat16)
            eps3 = self.unet(inp, torch.full((3,), float(t), device=dev), ctx3, None, "r", 1,
                             {}).float()
            e_txt, e_img, e_unc = eps3.chunk(3)
            eps = e_unc + g * (e_txt - e_img) + gi * (e_img - e_unc)
            noise = draw(None if step_noises is None else step_noises[i], tuple(lat.shape),
                          generator, dev)
            lat, _ = sched.step(eps, lat, sigmas[i], sigmas[i + 1], noise)
        out = self.vae.decode((lat * self.vae.cfg.scaling_factor).to(torch.bfloat16))
        return out.float().clamp(-1.0, 1.0)

    @timer.request("Delight")
    def __call__(self, rgb01: np.ndarray, seed: int = 42, init_latents=None,
                 step_noises=None) -> np.ndarray:
        """rgb01 [H, W, 3] float in [0, 1] → the delit rgb01 [H, W, 3]: a
        LANCZOS resize to ``resolution``², the diffusion, and a LANCZOS
        resize back."""
        from PIL import Image

        r = self.resolution
        img = Image.fromarray((np.clip(rgb01, 0, 1) * 255).astype(np.uint8))
        img = img.resize((r, r), Image.LANCZOS)
        x = torch.from_numpy(np.asarray(img, np.float32) / 255.0 * 2.0 - 1.0)[None]
        generator = torch.Generator(device=self.device).manual_seed(int(seed))
        with timed_scope("Delight Denoising"):
            out = self.denoise(x.to(self.device), init_latents, step_noises, generator)
        out01 = (out[0].cpu().numpy() + 1.0) / 2.0
        if rgb01.shape[:2] != (r, r):
            pil = Image.fromarray((np.clip(out01, 0, 1) * 255).astype(np.uint8))
            pil = pil.resize((rgb01.shape[1], rgb01.shape[0]), Image.LANCZOS)
            out01 = np.asarray(pil, np.float32) / 255.0
        return np.clip(out01, 0.0, 1.0)
