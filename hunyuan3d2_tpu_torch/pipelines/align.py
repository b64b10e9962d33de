"""ControlNet + IP-Adapter texture-alignment pipelines (port of
hunyuan3d2_tpu/pipelines/align.py).

The reference's alignment helpers: Img2img_Control_Ip_adapter (SD1.5 +
depth ControlNet 'control_v11f1p_sd15_depth' + IP-Adapter-plus at scale 0.7,
EulerAncestral, 20 steps, guidance 8.0, text-to-image conditioned on a depth
render) and HesModel (depth-ControlNet img2img at strength 0.8; the
reference's SDXL base is another backbone, the call contract and the
img2img / ControlNet semantics are these).

Each step runs the ControlNet, then the UNet with the IP tokens and the
ControlNet's residuals, on the [uncond | cond] CFG pair as one batch-2 call
each, then the ancestral step in fp32. The IP tokens are resampled once per
call; the uncond branch's from zero hidden states. img2img starts at
``N − int(N·strength)`` from the VAE-encoded init image noised to that
step's σ; the steps before it are skipped.

Randomness comes from an explicit ``torch.Generator`` seeded by ``seed``;
``init_noise`` and ``step_noises`` (one per step, skipped ones included)
replace its draws (the tests inject the JAX package's).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from hunyuan3d2_tpu_torch.models import controlnet as cn
from hunyuan3d2_tpu_torch.models import ip_adapter, paint_unet, sd_vae
from hunyuan3d2_tpu_torch.ops.nn import build
from hunyuan3d2_tpu_torch.pipelines.paint_schedulers import (
    EulerAncestralDiscreteScheduler,
    draw,
    init_noise_sigma,
)
from hunyuan3d2_tpu_torch.utils import timer
from hunyuan3d2_tpu_torch.utils.timer import timed_scope

# the align stack's SD1.5 UNet: plain 4-channel conv_in, cross 768, 8 heads
SD15_UNET = cn.SD15
TINY_UNET = cn.TINY

# the stock SD1.5 EulerAncestral: epsilon, leading spacing, steps_offset 1
SD15_SCHEDULER = EulerAncestralDiscreteScheduler(
    prediction_type="epsilon", timestep_spacing="leading", rescale_betas_zero_snr=False,
    steps_offset=1)


class ControlNetSDPipeline:
    """SD-class text-to-image / img2img with a depth ControlNet and an
    IP-Adapter image prompt, on ``device``. ``image_encoder`` (PIL → [1, T,
    embedding_dim] CLIP hidden states) and ``encode_text`` (str → [77, D])
    are optional."""

    def __init__(self, unet: paint_unet.UNetCore, controlnet: cn.ControlNet,
                 vae: sd_vae.AutoencoderKL, resampler: ip_adapter.Resampler, text_embed,
                 uncond_embed, image_encoder=None, encode_text=None, resolution: int = 512,
                 device=None):
        self.unet = unet
        self.controlnet = controlnet
        self.vae = vae
        self.resampler = resampler
        self.device = torch.device(device if device is not None else "cuda")
        self.text_embed = torch.as_tensor(np.array(text_embed, np.float32), device=self.device)
        self.uncond_embed = torch.as_tensor(np.array(uncond_embed, np.float32),
                                            device=self.device)
        self.image_encoder = image_encoder
        self.encode_text = encode_text
        self.resolution = resolution

    @classmethod
    def init_random(cls, size: str = "tiny", resolution: int = 64, device=None, seed: int = 0):
        """Random weights from torch Generators seeded from ``seed``: the
        SD1.5 UNet with the zero IP-Adapter graft, the SD1.5 ControlNet
        (zero convs) and the ``PLUS_SD15`` resampler for ``size="full"``,
        their TINY configs for ``size="tiny"``; a random text embedding and a
        zero uncond one."""
        device = torch.device(device if device is not None else "cuda")
        ucfg = SD15_UNET if size == "full" else TINY_UNET
        vcfg = sd_vae.DEFAULT if size == "full" else sd_vae.TINY
        rcfg = dataclasses.replace(ip_adapter.PLUS_SD15 if size == "full" else ip_adapter.TINY,
                                   output_dim=ucfg.cross_attention_dim)

        def gen(i):
            return torch.Generator(device=device).manual_seed(seed * 5 + i)

        unet = build(paint_unet.plain_unet, ucfg, device=device, generator=gen(0))
        ip_adapter.add_ip_adapter(unet, ucfg.cross_attention_dim)
        text = torch.randn(77, ucfg.cross_attention_dim, generator=gen(3), device=device) * 0.02
        text = text.cpu().numpy()
        return cls(unet, build(cn.ControlNet, ucfg, device=device, generator=gen(1)),
                   build(sd_vae.AutoencoderKL, vcfg, device=device, generator=gen(2)),
                   build(ip_adapter.Resampler, rcfg, device=device, generator=gen(4)),
                   text, np.zeros_like(text), resolution=resolution, device=device)

    @classmethod
    def from_pretrained(cls, sd_path: str, controlnet_path: str, ip_adapter_path: str = None,
                        device=None, **kwargs):
        """An SD1.5 diffusers directory, a ControlNetModel directory and an
        optional IP-Adapter file (without one, the zero graft) on ``device``
        (``cuda`` unless the caller passes another)."""
        from hunyuan3d2_tpu_torch.io import checkpoints

        return checkpoints.load_align_pipeline(cls, sd_path, controlnet_path, ip_adapter_path,
                                               device=device, **kwargs)

    def _embed(self, prompt, negative_prompt) -> torch.Tensor:
        if self.encode_text is not None:
            pe, ne = (torch.as_tensor(np.array(self.encode_text(p or ""), np.float32),
                                      device=self.device) for p in (prompt, negative_prompt))
            return torch.stack([ne, pe])
        return torch.stack([self.uncond_embed, self.text_embed])

    def _pil01(self, image, size: int) -> torch.Tensor:
        from PIL import Image

        img = image.convert("RGB").resize((size, size), Image.LANCZOS)
        return torch.from_numpy(np.asarray(img, np.float32) / 255.0)[None].to(self.device)

    @torch.no_grad()
    def denoise(self, context2, cond_image, image_hidden, init_latent, t_start: int,
                num_inference_steps: int, guidance_scale, controlnet_scale, ip_scale,
                init_noise=None, step_noises=None, generator=None) -> torch.Tensor:
        """The ControlNet + IP-Adapter loop → the image [1, H, W, 3] in
        [-1, 1], fp32. ``init_latent`` [1, h, w, 4] is the scaled latent of
        the init image (zeros for text-to-image)."""
        dev = self.device
        sched = SD15_SCHEDULER
        timesteps, sigmas = sched.make_tables(num_inference_steps)
        ip_cond = self.resampler(image_hidden.float())
        # the uncond IP tokens: the resampled zero hidden states (diffusers
        # encode_image passes zeros_like for the negative branch)
        ip_unc = self.resampler(torch.zeros_like(image_hidden, dtype=torch.float32))
        ip2 = torch.cat([ip_unc, ip_cond]).to(torch.bfloat16)
        ctx2 = context2.to(torch.bfloat16)
        cond2 = torch.cat([cond_image, cond_image])
        noise0 = draw(init_noise, tuple(init_latent.shape), generator, dev)
        if t_start == 0:
            lat = noise0 * init_noise_sigma(sigmas[0])
        else:   # img2img: x_t = x0 + σ_t·ε (EulerAncestral add_noise)
            lat = torch.add(init_latent, noise0, alpha=float(sigmas[t_start]))
        ip_scale = float(ip_scale)
        for i in range(t_start, num_inference_steps):
            tt = torch.full((2,), float(timesteps[i]), device=dev)
            lmi = sched.scale_model_input(lat.expand(2, -1, -1, -1),
                                          sigmas[i]).to(torch.bfloat16)
            down, mid = self.controlnet(lmi, tt, ctx2, cond2, conditioning_scale=controlnet_scale,
                                        ip_context=ip2, ip_scale=ip_scale)
            eps2 = self.unet(lmi, tt, ctx2, None, "r", 1, {}, ip_context=ip2, ip_scale=ip_scale,
                             ctrl_down=down, ctrl_mid=mid).float()
            e_unc, e_cond = eps2.chunk(2)
            noise = draw(None if step_noises is None else step_noises[i], tuple(lat.shape),
                          generator, dev)
            lat, _ = sched.step(e_unc + guidance_scale * (e_cond - e_unc), lat, sigmas[i],
                                sigmas[i + 1], noise)
        # lat is in the scaled-latent space: decode divides by the factor
        return self.vae.decode(lat.to(torch.bfloat16)).float().clamp(-1.0, 1.0)

    @timer.request("Align")
    def __call__(self, prompt="", control_image=None, ip_adapter_image=None, negative_prompt="",
                 init_image=None, strength: float = 1.0, num_inference_steps: int = 20,
                 guidance_scale: float = 8.0, controlnet_conditioning_scale: float = 1.0,
                 ip_adapter_scale: float = 0.7, seed: int = 42, height: int = None,
                 width: int = None, output_type: str = "pil", init_noise=None,
                 step_noises=None):
        from PIL import Image

        if control_image is None:
            raise ValueError("ControlNet needs a control image")
        r = height or self.resolution
        # the VAE's pixel → latent factor (8 for the SD VAE, 2 for TINY); the
        # conditioning embedder always downsamples 8×, so the control image is
        # sized to 8 × latent
        hw = r // 2 ** (len(self.vae.cfg.block_out_channels) - 1)
        cond = self._pil01(control_image, hw * 8)
        if self.image_encoder is not None and ip_adapter_image is not None:
            hidden = torch.as_tensor(np.array(self.image_encoder(ip_adapter_image), np.float32),
                                     device=self.device)
        else:   # zero hidden states: with the zero graft the image branch adds 0
            hidden = torch.zeros(1, 8, self.resampler.cfg.embedding_dim, device=self.device)
        lc = self.vae.cfg.latent_channels
        if init_image is not None and strength < 1.0:
            x = self._pil01(init_image, r) * 2.0 - 1.0
            with torch.no_grad():
                moments = self.vae.encode_moments(x.to(torch.bfloat16))
            init_lat = moments.float()[..., :lc] * self.vae.cfg.scaling_factor
            t_start = max(num_inference_steps - int(num_inference_steps * strength), 0)
        else:
            init_lat = torch.zeros(1, hw, hw, lc, device=self.device)
            t_start = 0
        generator = torch.Generator(device=self.device).manual_seed(int(seed))
        with timed_scope("Align Denoising"):
            out = self.denoise(self._embed(prompt, negative_prompt), cond, hidden, init_lat,
                               t_start, num_inference_steps, guidance_scale,
                               controlnet_conditioning_scale, ip_adapter_scale, init_noise,
                               step_noises, generator)
        arr = (out[0].cpu().numpy() + 1.0) / 2.0
        if output_type == "pil":
            return Image.fromarray((np.clip(arr, 0, 1) * 255).astype(np.uint8))
        return arr


class Img2img_Control_Ip_adapter:
    """The reference call contract: prompt + control (depth) image +
    IP-Adapter image → aligned image. Without a pipeline, a TINY random one
    on ``device`` (``cuda`` unless the caller passes another)."""

    def __init__(self, device=None, pipeline: ControlNetSDPipeline = None):
        self.pipeline = pipeline or ControlNetSDPipeline.init_random(device=device)

    def __call__(self, prompt, control_image, ip_adapter_image, negative_prompt, height=512,
                 width=512, num_inference_steps=20, guidance_scale=8.0,
                 controlnet_conditioning_scale=1.0, output_type="pil", init_noise=None,
                 step_noises=None, **kwargs):
        """Other keywords of the reference's call are accepted and unused."""
        return self.pipeline(
            prompt=prompt, control_image=control_image, ip_adapter_image=ip_adapter_image,
            negative_prompt=negative_prompt, height=height, width=width,
            num_inference_steps=num_inference_steps, guidance_scale=guidance_scale,
            controlnet_conditioning_scale=controlnet_conditioning_scale, ip_adapter_scale=0.7,
            output_type=output_type, init_noise=init_noise, step_noises=step_noises)


class HesModel:
    """The reference call contract: img2img with the depth ControlNet and
    the IP-Adapter at strength 0.8. Without a pipeline, a TINY random one on
    ``device``."""

    def __init__(self, pipeline: ControlNetSDPipeline = None, device=None):
        self.pipeline = pipeline or ControlNetSDPipeline.init_random(device=device)

    def __call__(self, init_image, control_image, ip_adapter_image=None, prompt="3D image",
                 negative_prompt="2D image", seed=42, strength=0.8, num_inference_steps=40,
                 guidance_scale=7.5, controlnet_conditioning_scale=0.5, init_noise=None,
                 step_noises=None, **kwargs):
        """Other keywords of the reference's call are accepted and unused."""
        return self.pipeline(
            prompt=prompt, control_image=control_image, ip_adapter_image=ip_adapter_image,
            negative_prompt=negative_prompt, init_image=init_image, strength=strength,
            num_inference_steps=num_inference_steps, guidance_scale=guidance_scale,
            controlnet_conditioning_scale=controlnet_conditioning_scale, ip_adapter_scale=0.7,
            seed=seed, init_noise=init_noise, step_noises=step_noises)
