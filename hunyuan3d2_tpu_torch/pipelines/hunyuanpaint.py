"""HunyuanPaint multiview diffusion (port of
hunyuan3d2_tpu/pipelines/hunyuanpaint.py).

Reference image + normal / position control maps are encoded through the
SD VAE; the reference branch ('w' pass of the dual UNet) runs once and its
per-layer cache is read by every step. Two samplers, each a plain Python
loop over the 2.5D UNet:
  * standard (EulerAncestral, zero-terminal SNR, v-prediction): classifier-
    free guidance packs [uncond | cond] on the batch axis, the uncond branch
    with zero reference latents and a reference-attention scale of 0;
  * turbo (LCM, no CFG): the voxel-locality multiview masks are built once.
The views are decoded one at a time and quantised to uint8 on the device.

Randomness comes from an explicit ``torch.Generator``; ``init_latents`` and
``step_noises`` replace its draws (the tests inject the JAX package's).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from hunyuan3d2_tpu_torch.models import paint_unet, sd_vae
from hunyuan3d2_tpu_torch.ops.nn import build
from hunyuan3d2_tpu_torch.pipelines.paint_schedulers import (
    EulerAncestralDiscreteScheduler,
    LCMScheduler,
    draw,
)
from hunyuan3d2_tpu_torch.utils.timer import timed_scope


def _reference_array(image, size: int) -> np.ndarray:
    """A PIL reference image as uint8 RGB [size, size, 3]: alpha composited
    on white, then a bilinear resize to size²."""
    from PIL import Image

    if image.mode != "RGB":
        arr = np.asarray(image.convert("RGBA")).astype(np.float32)
        alpha = arr[..., 3:] / 255.0
        image = Image.fromarray((arr[..., :3] * alpha + 255 * (1 - alpha)).astype(np.uint8))
    return _control_array(image, size)


def _control_array(img, size: int) -> np.ndarray:
    """A control image (PIL, or an array in [0, 1] or uint8) as uint8 RGB:
    a bilinear resize to size², grey replicated to three channels, RGBA
    composited on white in integers; a two-level (mode "1") image gives
    0 / 255."""
    from PIL import Image

    if isinstance(img, Image.Image):
        if img.size != (size, size):
            img = img.resize((size, size), Image.BILINEAR)
        arr = np.asarray(img)
        if arr.dtype == bool:
            arr = arr.astype(np.uint8) * 255
    else:
        arr = np.asarray(img)
        if arr.dtype != np.uint8:
            arr = (np.clip(arr, 0, 1) * 255).astype(np.uint8)
    if arr.ndim == 2:
        arr = np.stack([arr] * 3, -1)
    if arr.shape[-1] == 4:
        a = arr[..., 3:].astype(np.uint32)
        arr = ((arr[..., :3].astype(np.uint32) * a + 255 * (255 - a)) // 255).astype(np.uint8)
    return arr


def _stack_views(views, size: int) -> torch.Tensor:
    """Control views → uint8 [1, N, size, size, 3]: a uint8 [N, H, W, 3]
    tensor (the device cond maps) as it is, or a list (or a list holding one
    list) of images."""
    if isinstance(views, torch.Tensor):
        return views[None]
    views = views[0] if isinstance(views[0], list) else views
    return torch.from_numpy(np.stack([_control_array(v, size) for v in views])[None])


class PaintResult:
    def __init__(self, images):
        self.images = images


class HunyuanPaintPipeline:
    """The 2.5D UNet, the SD VAE and a sampler (the standard one unless
    ``set_turbo``), on ``device``."""

    def __init__(self, unet: paint_unet.UNet2p5D, vae: sd_vae.AutoencoderKL,
                 view_size: int = 512, device=None):
        self.unet = unet
        self.vae = vae
        self.view_size = view_size
        self.device = torch.device(device if device is not None else "cuda")
        self.set_turbo(False)

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
        """Sample with the paint-turbo LCM loop, or (``turbo=False``) the
        standard EulerAncestral + CFG loop."""
        self.is_turbo = turbo
        self.scheduler = LCMScheduler() if turbo else EulerAncestralDiscreteScheduler()

    def encode_images(self, images_u8: torch.Tensor) -> torch.Tensor:
        """[B, N, H, W, 3] uint8 → scaled latents [B, N, h, w, 4] fp32 (×2−1
        in bf16, then the mode of the VAE posterior)."""
        b, n = images_u8.shape[:2]
        flat = images_u8.reshape((b * n,) + tuple(images_u8.shape[2:])).to(self.device)
        flat = flat.to(torch.bfloat16) / 255.0
        lat = self.vae.encode(flat * 2.0 - 1.0)
        return lat.reshape((b, n) + tuple(lat.shape[1:])).float()

    def _decode_views(self, latents: torch.Tensor) -> torch.Tensor:
        """Latents [1, N, h, w, 4] → views [N, H, W, 3] uint8 on the device,
        one view at a time: the 512² decoder activations of six views at
        once would take several GB for the same total work."""
        views = torch.stack([self.vae.decode(z[None].to(torch.bfloat16))[0] for z in latents[0]])
        return torch.round((views.float() / 2 + 0.5).clamp(0.0, 1.0) * 255.0).to(torch.uint8)

    @torch.no_grad()
    def denoise(self, ref_latents, normal_latents, position_latents, cam_gen, cam_ref,
                timesteps: np.ndarray, sigmas: np.ndarray, guidance_scale: float = 2.0,
                init_latents=None, step_noises=None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """The standard loop: EulerAncestral from x_T = σ₀·(unit draw), with
        classifier-free guidance when ``guidance_scale`` > 1. Latents
        [1, N, h, w, 4] (bf16 into the UNet; the scaling, the guidance
        combine and the step in fp32), camera indices [1, N] → views
        [N, H, W, 3] uint8 on the device."""
        dev = self.device
        do_cfg = guidance_scale > 1.0
        if do_cfg:  # [uncond | cond]: the uncond branch sees zero reference latents
            ref_latents = torch.cat([torch.zeros_like(ref_latents), ref_latents])
            normal_latents, position_latents, cam_gen, cam_ref = (
                torch.cat([x, x]) for x in (normal_latents, position_latents, cam_gen, cam_ref))
        shape = (1,) + tuple(normal_latents.shape[1:4]) + (4,)
        latents = draw(init_latents, shape, generator, dev) * float(sigmas[0])
        ref_scale = torch.tensor([0.0, 1.0], device=dev) if do_cfg else 1.0
        cache = self.unet.write_cache(ref_latents, cam_ref)
        sched = self.scheduler
        for i, t in enumerate(timesteps):
            lat_in = torch.cat([latents, latents]) if do_cfg else latents
            lat_in = sched.scale_model_input(lat_in, sigmas[i])
            pred = self.unet(lat_in.to(normal_latents.dtype), float(t), normal_latents,
                             position_latents, cam_gen, cache, ref_scale=ref_scale).float()
            if do_cfg:
                uncond, cond = pred.chunk(2)
                pred = uncond + guidance_scale * (cond - uncond)
            noise = draw(None if step_noises is None else step_noises[i], shape, generator, dev)
            latents, _ = sched.step(pred, latents, sigmas[i], sigmas[i + 1], noise)
        return self._decode_views(latents)

    @torch.no_grad()
    def denoise_lcm(self, ref_latents, normal_latents, position_latents, cam_gen,
                    timesteps: np.ndarray, alphas_cumprod: np.ndarray,
                    position_u8: Optional[torch.Tensor] = None, mask_grids=(),
                    init_latents=None, step_noises=None,
                    generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """The turbo loop: LCM consistency sampling, no CFG. Latents
        [B, N, h, w, 4] (bf16 into the UNet), position_u8 [B, N, H, W, 3]
        for the voxel masks → views [N, H, W, 3] uint8 on the device."""
        dev = self.device
        masks = None
        if position_u8 is not None and mask_grids:
            masks = paint_unet.compute_multi_resolution_mask(
                position_u8.to(dev).float() / 255.0, mask_grids)
        shape = tuple(normal_latents.shape[:4]) + (4,)
        latents = draw(init_latents, shape, generator, dev)
        cache = self.unet.write_cache(ref_latents)
        ac = torch.from_numpy(np.asarray(alphas_cumprod, np.float32)).to(dev)
        steps = [int(t) for t in timesteps]
        for i, t in enumerate(steps):
            t_next = steps[i + 1] if i + 1 < len(steps) else 0
            pred = self.unet(latents.to(normal_latents.dtype), float(t), normal_latents,
                             position_latents, cam_gen, cache, mva_masks=masks)
            noise = draw(None if step_noises is None else step_noises[i], shape, generator, dev)
            latents, _ = self.scheduler.step(pred.float(), latents, t, t_next, ac, noise)
        return self._decode_views(latents)

    @torch.no_grad()
    def __call__(self, image, *, normal_imgs, position_imgs, camera_info_gen: List[List[int]],
                 camera_info_ref: Optional[List[List[int]]] = None,
                 num_inference_steps: int = 30, guidance_scale: float = 2.0,
                 num_in_batch: Optional[int] = None, seed: int = 0,
                 width: Optional[int] = None, height: Optional[int] = None,
                 output_type: str = "pil", init_latents=None, step_noises=None, **kwargs):
        """Reference image(s) + normal / position control maps → the N views.

        The control maps are uint8 [N, size, size, 3] tensors (the device
        cond maps) or lists of images. ``camera_info_ref`` (default [[0]])
        matters only to a single-stream UNet; ``num_in_batch`` and
        ``height`` are accepted for the reference's signature (the views are
        width² and N is the maps' count), and so are extra keywords. The
        views come back as PIL images
        (``"pil"``), a uint8 [N, size, size, 3] tensor on the device
        (``"device"``), or otherwise a float32 numpy array in [0, 1]."""
        size = width or self.view_size
        images = image if isinstance(image, list) else [image]
        ref = torch.from_numpy(np.stack([_reference_array(im, size) for im in images])[None])
        normal, position = _stack_views(normal_imgs, size), _stack_views(position_imgs, size)
        with timed_scope("Paint VAE Encode"):
            ref_latents = self.encode_images(ref).to(torch.bfloat16)
            normal_latents = self.encode_images(normal).to(torch.bfloat16)
            position_latents = self.encode_images(position).to(torch.bfloat16)
        cam_gen = torch.as_tensor(camera_info_gen, dtype=torch.long, device=self.device)
        generator = torch.Generator(device=self.device).manual_seed(seed)
        if self.is_turbo:
            timesteps, ac = self.scheduler.make_tables(min(num_inference_steps, 10))
            # voxel-locality multiview masks at the grids that divide the view
            grids = tuple(g for g in (32, 16, 8) if position.shape[3] % g == 0)
            with timed_scope("Paint Denoising (turbo)"):
                views = self.denoise_lcm(
                    ref_latents, normal_latents, position_latents, cam_gen, timesteps, ac,
                    position, grids, init_latents, step_noises, generator)
        else:
            cam_ref = torch.as_tensor([[0]] if camera_info_ref is None else camera_info_ref,
                                      dtype=torch.long, device=self.device)
            timesteps, sigmas = self.scheduler.make_tables(num_inference_steps)
            with timed_scope("Paint Denoising"):
                views = self.denoise(ref_latents, normal_latents, position_latents, cam_gen,
                                     cam_ref, timesteps, sigmas, guidance_scale, init_latents,
                                     step_noises, generator)
        if output_type == "device":
            return PaintResult(views)
        views = views.cpu().numpy()
        if output_type == "pil":
            from PIL import Image

            return PaintResult([Image.fromarray(v) for v in views])
        return PaintResult(views.astype(np.float32) / 255.0)
