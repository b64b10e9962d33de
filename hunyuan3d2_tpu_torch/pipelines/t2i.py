"""HunyuanDiT text → image pipeline, the text-to-3D front end (port of
hunyuan3d2_tpu/pipelines/t2i.py).

The reference's diffusers HunyuanDiT v1.1 Distilled pipeline with PAG on
blocks 16-19: DDPM (v-prediction, leading spacing), 25 steps, guidance
5.0, PAG scale 1.3, 1024². Each step runs the [uncond | cond] pair as one
batch-2 call of the transformer and the perturbed branch as a batch-1
call; the guidance combine and the DDPM step are fp32, the transformer
bf16. The latents are decoded by the SD VAE and quantised to uint8.

Text encoding plugs in as ``encode_text(prompt, negative) → (neg, pos)``,
each (clip [1, 77, 1024], clip_mask, t5 [1, 256, 2048], t5_mask) as numpy
arrays; without it the pipeline conditions on pseudo-random embeddings
drawn from a generator seeded by ``zlib.crc32`` of the prompt. Randomness
comes from an explicit ``torch.Generator``; ``init_latents`` and
``step_noises`` replace its draws (the tests inject the JAX package's).
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Callable, Optional

import numpy as np
import torch

from hunyuan3d2_tpu_torch.models import hunyuan_dit, sd_vae
from hunyuan3d2_tpu_torch.ops.nn import build
from hunyuan3d2_tpu_torch.pipelines.paint_schedulers import draw
from hunyuan3d2_tpu_torch.utils import timer
from hunyuan3d2_tpu_torch.utils.timer import timed_scope


@dataclasses.dataclass(frozen=True)
class DDPMConfig:
    """diffusers DDPMScheduler as HunyuanDiT configures it: scaled_linear
    betas 0.00085 → 0.03 over 1000 steps, v-prediction, leading timestep
    spacing with steps_offset 1, fixed-small variance, no clipping."""
    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.03
    prediction_type: str = "v_prediction"
    steps_offset: int = 1


def ddpm_alphas_cumprod(cfg: DDPMConfig) -> np.ndarray:
    betas = np.linspace(cfg.beta_start ** 0.5, cfg.beta_end ** 0.5, cfg.num_train_timesteps,
                        dtype=np.float64) ** 2
    return np.cumprod(1.0 - betas).astype(np.float32)


def ddpm_timesteps(cfg: DDPMConfig, n_steps: int) -> np.ndarray:
    """Leading spacing: t_i = i · (T // n) + offset, descending."""
    ratio = cfg.num_train_timesteps // n_steps
    t = (np.arange(n_steps) * ratio).round()[::-1].astype(np.int64)
    return (t + cfg.steps_offset).clip(0, cfg.num_train_timesteps - 1)


def ddpm_step(pred: torch.Tensor, t: int, t_prev: int, sample: torch.Tensor,
              acp: torch.Tensor, noise: torch.Tensor, prediction_type: str = "v_prediction",
              clip_sample: bool = False) -> torch.Tensor:
    """One ancestral DDPM step (DDPMScheduler.step, variance 'fixed_small'),
    in fp32; ``t_prev`` < 0 is the last step, which returns x0. ``acp`` is
    the fp32 alphas_cumprod table on the sample's device."""
    a_t = acp[t]
    a_prev = acp[t_prev] if t_prev >= 0 else torch.ones_like(a_t)
    beta_t = 1.0 - a_t / a_prev
    sq_at, sq_1mat = torch.sqrt(a_t), torch.sqrt(1.0 - a_t)
    if prediction_type == "v_prediction":
        x0 = sq_at * sample - sq_1mat * pred
        eps = sq_at * pred + sq_1mat * sample
    else:
        eps = pred
        x0 = (sample - sq_1mat * eps) / sq_at
    if clip_sample:
        x0 = x0.clamp(-1.0, 1.0)
    if t_prev < 0:
        return x0
    c_x0 = torch.sqrt(a_prev) * beta_t / (1.0 - a_t)
    c_xt = torch.sqrt(a_t / a_prev) * (1.0 - a_prev) / (1.0 - a_t)
    var = (beta_t * (1.0 - a_prev) / (1.0 - a_t)).clamp_min(1e-20)
    return c_x0 * x0 + c_xt * sample + torch.sqrt(var) * noise


class HunyuanDiTTorchPipeline:
    """``pipe(prompt, seed) → PIL.Image`` at ``resolution``², on ``device``."""

    def __init__(self, transformer: hunyuan_dit.HunyuanDiT2DModel, vae: sd_vae.AutoencoderKL,
                 encode_text: Optional[Callable] = None, resolution: int = 1024,
                 num_inference_steps: int = 25, guidance_scale: float = 5.0,
                 pag_scale: Optional[float] = 1.3, sched: DDPMConfig = DDPMConfig(), device=None):
        self.transformer = transformer
        self.vae = vae
        self.encode_text = encode_text
        self.resolution = resolution
        self.num_inference_steps = num_inference_steps
        self.guidance_scale = guidance_scale
        self.pag_scale = pag_scale
        self.sched = sched
        self.device = torch.device(device if device is not None else "cuda")
        self.from_checkpoint = False   # set by the loader: gates the pseudo-embedding warning

    @property
    def dit_cfg(self) -> hunyuan_dit.HunyuanDiTConfig:
        return self.transformer.cfg

    @classmethod
    def init_random(cls, size: str = "tiny", resolution: int = 64, num_inference_steps: int = 4,
                    device=None, seed: int = 0):
        """Random weights from torch Generators seeded from ``seed``: the v1.1
        transformer (``FULL`` without style and image-meta conditioning) and
        the t2i SD VAE (scaling factor 0.13025) for ``size="full"``, their
        ``TINY`` configs for ``size="tiny"``."""
        device = torch.device(device if device is not None else "cuda")
        dcfg = {"tiny": hunyuan_dit.TINY, "full": hunyuan_dit.V1_1}[size]
        vcfg = {"tiny": sd_vae.TINY,
                "full": dataclasses.replace(sd_vae.DEFAULT, scaling_factor=0.13025)}[size]

        def gen(i):
            return torch.Generator(device=device).manual_seed(seed * 2 + i)

        return cls(build(hunyuan_dit.HunyuanDiT2DModel, dcfg, device=device, generator=gen(0)),
                   build(sd_vae.AutoencoderKL, vcfg, device=device, generator=gen(1)),
                   resolution=resolution, num_inference_steps=num_inference_steps, device=device)

    @classmethod
    def from_pretrained(cls, ckpt_path: str, device=None, **kwargs):
        """A diffusers HunyuanDiT directory (``transformer/`` and ``vae/``, text
        encoders through ``transformers`` when both are present) on
        ``device`` (``cuda`` unless the caller passes another)."""
        from hunyuan3d2_tpu_torch.io import checkpoints

        return checkpoints.load_t2i_pipeline(cls, ckpt_path, device=device, **kwargs)

    def _text_states(self, prompt: str, negative_prompt: str):
        if self.encode_text is not None:
            return self.encode_text(prompt, negative_prompt)
        if self.from_checkpoint:
            from hunyuan3d2_tpu_torch.utils.logger import get_logger

            get_logger("hunyuan3d2_tpu_torch.t2i").warning(
                "t2i: no text encoders loaded (text_encoder/ or transformers missing): "
                "conditioning on PSEUDO-RANDOM embeddings; the prompt does not steer the image")
        c = self.dit_cfg

        def emb(s, salt):
            gen = torch.Generator().manual_seed(zlib.crc32(f"{salt}:{s}".encode()) & 0x7FFFFFFF)
            clip = torch.randn(1, c.text_len, c.text_dim, generator=gen).numpy()
            t5 = torch.randn(1, c.t5_len, c.t5_dim, generator=gen).numpy()
            ones = (np.ones((1, n), np.float32) for n in (c.text_len, c.t5_len))
            return clip, next(ones), t5, next(ones)

        return emb(negative_prompt, 0), emb(prompt, 1)

    def context(self, prompt: str, negative_prompt: str = ""):
        """The transformer's text inputs for [uncond | cond | cond]: ctx
        [3, 333, text_dim] and pooled [3, pooled_dim], fp32 on the device."""
        neg, pos = self._text_states(prompt, negative_prompt)
        ctxs, pools = [], []
        for states in (neg, pos):
            ctx, pooled = self.transformer.build_context(
                *(torch.as_tensor(np.asarray(a, np.float32), device=self.device) for a in states))
            ctxs.append(ctx)
            pools.append(pooled)
        return torch.cat(ctxs + ctxs[1:]), torch.cat(pools + pools[1:])

    @torch.no_grad()
    def denoise(self, ctx, pooled, gh: int, gw: int, init_latents=None, step_noises=None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """The DDPM loop from a unit draw: latents [1, gh, gw, 4] fp32."""
        dev, c = self.device, self.dit_cfg
        r = self.resolution
        meta = torch.tensor([[r, r, r, r, 0, 0]], dtype=torch.float32, device=dev).repeat(3, 1)
        ts = [int(t) for t in ddpm_timesteps(self.sched, self.num_inference_steps)]
        acp = torch.from_numpy(ddpm_alphas_cumprod(self.sched)).to(dev)
        use_pag = self.pag_scale is not None and bool(c.pag_layers)
        shape = (1, gh, gw, 4)
        lat = draw(init_latents, shape, generator, dev)
        for i, t in enumerate(ts):
            t_prev = ts[i + 1] if i + 1 < len(ts) else -1
            tt = torch.full((2,), float(t), device=dev)
            pair = torch.cat([lat, lat]).to(torch.bfloat16)
            out = self.transformer(pair, tt, ctx[:2], pooled[:2], meta[:2])[..., :4].float()
            uncond, cond = out[:1], out[1:2]
            pred = uncond + self.guidance_scale * (cond - uncond)
            if use_pag:
                pag_out = self.transformer(lat.to(torch.bfloat16), tt[:1], ctx[2:3], pooled[2:3],
                                           meta[2:3], pag=True)[..., :4].float()
                pred = pred + self.pag_scale * (cond - pag_out)
            noise = draw(None if step_noises is None else step_noises[i], shape, generator, dev)
            lat = ddpm_step(pred, t, t_prev, lat, acp, noise, self.sched.prediction_type)
        return lat

    @timer.request("Text to Image")
    @torch.no_grad()
    def __call__(self, prompt: str, seed: int = 0, negative_prompt: str = "",
                 init_latents=None, step_noises=None):
        """The prompt is encoded verbatim: the reference's 60-character cut and
        its prompt templates belong to utils/text2image.HunyuanDiTPipeline."""
        from PIL import Image

        with timed_scope("T2I Text States"):
            ctx, pooled = self.context(prompt, negative_prompt)
        # the VAE's spatial factor is 2^(levels - 1): 8 for the SD VAE, 2 for TINY
        gh = gw = self.resolution // 2 ** (len(self.vae.cfg.block_out_channels) - 1)
        generator = torch.Generator(device=self.device).manual_seed(int(seed))
        with timed_scope("T2I Denoising"):
            lat = self.denoise(ctx, pooled, gh, gw, init_latents, step_noises, generator)
        with timed_scope("T2I VAE Decode"):
            img = self.vae.decode(lat.to(torch.bfloat16))[0]
            img = torch.round((img.float() / 2 + 0.5).clamp(0.0, 1.0) * 255.0).to(torch.uint8)
        return Image.fromarray(img.cpu().numpy())
