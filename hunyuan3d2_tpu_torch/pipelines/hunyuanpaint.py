"""HunyuanPaint multiview diffusion, the paint-turbo path (port of
hunyuan3d2_tpu/pipelines/hunyuanpaint.py).

Reference image + normal / position control maps are encoded through the
SD VAE; the reference branch ('w' pass of the dual UNet) runs once and its
per-layer cache is read by every step; the LCM loop is a plain Python loop
over the 2.5D UNet with the voxel-locality multiview masks built once; the
views are decoded one at a time and quantised to uint8 on the device.

Randomness comes from an explicit ``torch.Generator``; ``init_latents`` and
``step_noises`` replace its draws (the tests inject the JAX package's).
The standard (EulerAncestral + CFG) loop is not ported yet.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from hunyuan3d2_tpu_torch.models import paint_unet, sd_vae
from hunyuan3d2_tpu_torch.ops.nn import build
from hunyuan3d2_tpu_torch.pipelines.paint_schedulers import LCMScheduler
from hunyuan3d2_tpu_torch.utils.timer import timed_scope


def _reference_array(image, size: int) -> np.ndarray:
    """A PIL reference image as uint8 RGB [size, size, 3]: alpha composited
    on white, then a bilinear resize to size²."""
    from PIL import Image

    if image.mode != "RGB":
        arr = np.asarray(image.convert("RGBA")).astype(np.float32)
        alpha = arr[..., 3:] / 255.0
        image = Image.fromarray((arr[..., :3] * alpha + 255 * (1 - alpha)).astype(np.uint8))
    if image.size != (size, size):
        image = image.resize((size, size), Image.BILINEAR)
    return np.asarray(image)


class PaintResult:
    def __init__(self, images):
        self.images = images


class HunyuanPaintPipeline:
    """The 2.5D UNet, the SD VAE and the turbo sampler, on ``device``."""

    def __init__(self, unet: paint_unet.UNet2p5D, vae: sd_vae.AutoencoderKL,
                 view_size: int = 512, device=None):
        self.unet = unet
        self.vae = vae
        self.view_size = view_size
        self.device = torch.device(device if device is not None else "cuda")
        self.is_turbo = False
        self.scheduler = LCMScheduler()

    @classmethod
    def init_random(cls, size: str = "tiny", view_size: int = 64, device=None, seed: int = 0):
        """Random weights from torch Generators seeded from ``seed``: the paint
        UNet ``DEFAULT`` (with its dual copy) and SD VAE ``DEFAULT`` for
        ``size="default"``, their ``TINY`` configs for ``size="tiny"``."""
        device = torch.device(device if device is not None else "cuda")
        ucfg = {"tiny": paint_unet.TINY, "default": paint_unet.DEFAULT}[size]
        vcfg = {"tiny": sd_vae.TINY, "default": sd_vae.DEFAULT}[size]

        def gen(i):
            return torch.Generator(device=device).manual_seed(seed * 2 + i)

        return cls(build(paint_unet.UNet2p5D, ucfg, device=device, generator=gen(0)),
                   build(sd_vae.AutoencoderKL, vcfg, device=device, generator=gen(1)),
                   view_size=view_size, device=device)

    def set_turbo(self, turbo: bool = True):
        self.is_turbo = turbo

    def encode_images(self, images_u8: torch.Tensor) -> torch.Tensor:
        """[B, N, H, W, 3] uint8 → scaled latents [B, N, h, w, 4] fp32 (×2−1
        in bf16, then the mode of the VAE posterior)."""
        b, n = images_u8.shape[:2]
        flat = images_u8.reshape((b * n,) + tuple(images_u8.shape[2:])).to(self.device)
        flat = flat.to(torch.bfloat16) / 255.0
        lat = self.vae.encode(flat * 2.0 - 1.0)
        return lat.reshape((b, n) + tuple(lat.shape[1:])).float()

    @torch.no_grad()
    def denoise_lcm(self, ref_latents, normal_latents, position_latents, cam_gen,
                    timesteps: np.ndarray, alphas_cumprod: np.ndarray,
                    position_u8: Optional[torch.Tensor] = None, mask_grids=(),
                    init_latents: Optional[torch.Tensor] = None, step_noises=None,
                    generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """The turbo loop: LCM consistency sampling, no CFG. Latents
        [B, N, h, w, 4] (bf16 into the UNet), position_u8 [B, N, H, W, 3]
        for the voxel masks → views [N, H, W, 3] uint8 on the device."""
        dev = self.device
        masks = None
        if position_u8 is not None and mask_grids:
            pos = position_u8.to(dev).float() / 255.0
            masks = {}
            for g in mask_grids:
                m = paint_unet.compute_voxel_grid_mask(pos, g)
                masks[int(m.shape[1])] = m
        shape = tuple(normal_latents.shape[:4]) + (4,)
        if init_latents is None:
            latents = torch.randn(shape, generator=generator, device=dev)
        else:
            latents = torch.as_tensor(init_latents, dtype=torch.float32).to(dev).reshape(shape)
        cache = self.unet.write_cache(ref_latents)
        ac = torch.from_numpy(np.asarray(alphas_cumprod, np.float32)).to(dev)
        steps = [int(t) for t in timesteps]
        for i, t in enumerate(steps):
            t_next = steps[i + 1] if i + 1 < len(steps) else 0
            pred = self.unet(latents.to(normal_latents.dtype), float(t), normal_latents,
                             position_latents, cam_gen, cache, mva_masks=masks)
            if step_noises is None:
                noise = torch.randn(shape, generator=generator, device=dev)
            else:
                noise = torch.as_tensor(step_noises[i], dtype=torch.float32).to(dev).reshape(shape)
            latents, _ = self.scheduler.step(pred.float(), latents, t, t_next, ac, noise)
        # one view at a time: the 512² decoder activations of six views at
        # once would take several GB for the same total work
        views = torch.stack([self.vae.decode(z[None].to(torch.bfloat16))[0] for z in latents[0]])
        return torch.round((views.float() / 2 + 0.5).clamp(0.0, 1.0) * 255.0).to(torch.uint8)

    @torch.no_grad()
    def __call__(self, image, *, normal_imgs: torch.Tensor, position_imgs: torch.Tensor,
                 camera_info_gen: List[List[int]], num_inference_steps: int = 30,
                 width: Optional[int] = None, output_type: str = "pil", seed: int = 0,
                 init_latents=None, step_noises=None):
        """Reference image(s) + normal / position control maps (uint8
        [N, size, size, 3] tensors) → the N views, as PIL images or
        (``output_type="device"``) a uint8 [N, size, size, 3] tensor."""
        if not self.is_turbo:
            raise NotImplementedError("the standard EulerAncestral + CFG paint loop is not "
                                      "ported yet (ROADMAP queue A): call set_turbo()")
        size = width or self.view_size
        images = image if isinstance(image, list) else [image]
        ref = torch.from_numpy(np.stack([_reference_array(im, size) for im in images])[None])
        normal, position = normal_imgs[None], position_imgs[None]
        with timed_scope("Paint VAE Encode"):
            ref_latents = self.encode_images(ref).to(torch.bfloat16)
            normal_latents = self.encode_images(normal).to(torch.bfloat16)
            position_latents = self.encode_images(position).to(torch.bfloat16)
        cam_gen = torch.as_tensor(camera_info_gen, dtype=torch.long, device=self.device)
        timesteps, ac = self.scheduler.make_tables(min(num_inference_steps, 10))
        # voxel-locality multiview masks at the grids that divide the view
        grids = tuple(g for g in (32, 16, 8) if position.shape[3] % g == 0)
        with timed_scope("Paint Denoising (turbo)"):
            views = self.denoise_lcm(
                ref_latents, normal_latents, position_latents, cam_gen, timesteps, ac,
                position, grids, init_latents, step_noises,
                torch.Generator(device=self.device).manual_seed(seed))
        if output_type == "device":
            return PaintResult(views)
        if output_type != "pil":
            raise ValueError(f"output_type is 'pil' or 'device', got {output_type!r}")
        from PIL import Image

        return PaintResult([Image.fromarray(v) for v in views.cpu().numpy()])
