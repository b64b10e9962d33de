"""De-lighting (shadow and highlight removal) of input images (port of
hunyuan3d2_tpu/utils/dehighlight.py).

The reference's Light_Shadow_Remover: an InstructPix2Pix diffusion pass
(pipelines/delight.py), then an RGB moment-matching recorrection and alpha
compositing on white. Without a pipeline the statistics-only stage runs, a
no-op composite. A checkpoint that is asked for (``config
.light_remover_ckpt_path``) and fails to load raises; the reference's
diffusers construction is not ported.
"""

from __future__ import annotations

import numpy as np
from PIL import Image


def recorrect_rgb(src: np.ndarray, target: np.ndarray, alpha_channel=None,
                  central_factor: float = 0.8) -> np.ndarray:
    """Match src's per-channel mean and std to target's over the central
    crop (over its alpha > 0.5 pixels when ``alpha_channel`` is given)."""
    h, w = src.shape[:2]
    cy0, cy1 = int(h * (1 - central_factor) / 2), int(h * (1 + central_factor) / 2)
    cx0, cx1 = int(w * (1 - central_factor) / 2), int(w * (1 + central_factor) / 2)
    out = src.astype(np.float32).copy()
    sc = src[cy0:cy1, cx0:cx1].reshape(-1, src.shape[-1])
    tc = target[cy0:cy1, cx0:cx1].reshape(-1, target.shape[-1])
    if alpha_channel is not None:
        sel = alpha_channel[cy0:cy1, cx0:cx1].reshape(-1) > 0.5
        if sel.any():
            sc, tc = sc[sel], tc[sel]
    mu_s, std_s = sc.mean(0), sc.std(0) + 1e-6
    mu_t, std_t = tc.mean(0), tc.std(0) + 1e-6
    out = (out - mu_s) / std_s * std_t + mu_t
    return np.clip(out, 0.0, 1.0)


class Light_Shadow_Remover:
    """``config.light_remover_ckpt_path`` (a diffusers InstructPix2Pix
    directory) loads a DelightPipeline on ``config.device`` (``cuda`` when
    the config names none); ``pipeline`` injects one (rgb01 → rgb01)."""

    def __init__(self, config=None, pipeline=None):
        self.config = config
        self.pipeline = pipeline
        ckpt = getattr(config, "light_remover_ckpt_path", None) if config else None
        if pipeline is None and ckpt:
            from hunyuan3d2_tpu_torch.pipelines.delight import DelightPipeline

            self.pipeline = DelightPipeline.from_pretrained(ckpt,
                                                            device=getattr(config, "device", None))

    def __call__(self, image: Image.Image) -> Image.Image:
        rgba = np.asarray(image.convert("RGBA")).astype(np.float32) / 255.0
        rgb, alpha = rgba[..., :3], rgba[..., 3]
        if self.pipeline is not None:
            out = recorrect_rgb(self.pipeline(rgb), rgb, alpha)
        else:
            out = rgb
        out = out * alpha[..., None] + (1 - alpha[..., None])
        return Image.fromarray((np.clip(out, 0, 1) * 255).astype(np.uint8))
