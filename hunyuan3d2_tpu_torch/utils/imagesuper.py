"""Super-resolution of generated views (port of
hunyuan3d2_tpu/utils/imagesuper.py).

The reference's Image_Super_Net: the SD x4 upscaler (pipelines/upscale.py)
when a checkpoint or pipeline is given, else a LANCZOS ×4 resize with an
unsharp mask. A checkpoint that is asked for (``config
.super_res_ckpt_path``) and fails to load raises; the reference's diffusers
construction (``use_diffusion`` without a checkpoint) is not ported and
raises.
"""

from __future__ import annotations

from PIL import Image, ImageFilter


class Image_Super_Net:
    def __init__(self, config=None, pipeline=None, scale: int = 4, use_diffusion: bool = False):
        self.pipeline = pipeline
        self.scale = scale
        ckpt = getattr(config, "super_res_ckpt_path", None) if config else None
        if pipeline is None and ckpt:
            from hunyuan3d2_tpu_torch.io.checkpoints import load_upscale_pipeline
            from hunyuan3d2_tpu_torch.pipelines.upscale import UpscalePipeline

            self.pipeline = load_upscale_pipeline(UpscalePipeline, ckpt,
                                                  device=getattr(config, "device", None))
        if self.pipeline is None and use_diffusion:
            raise ValueError("Image_Super_Net(use_diffusion=True) needs a pipeline or "
                             "config.super_res_ckpt_path (an x4-upscaler directory): the "
                             "reference's diffusers construction is not ported")

    def __call__(self, image: Image.Image, prompt: str = "") -> Image.Image:
        if self.pipeline is not None:
            return self.pipeline(image, prompt=prompt)
        w, h = image.size
        up = image.resize((w * self.scale, h * self.scale), Image.LANCZOS)
        return up.filter(ImageFilter.UnsharpMask(radius=2, percent=60, threshold=2))
