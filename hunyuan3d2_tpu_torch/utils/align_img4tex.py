"""Img2img / ControlNet texture-alignment helpers (port of
hunyuan3d2_tpu/utils/align_img4tex.py): the reference's import path for the
stacks of pipelines/align.py, plus the legacy ``backend`` keyword.
"""

from __future__ import annotations

from PIL import Image

from hunyuan3d2_tpu_torch.pipelines.align import ControlNetSDPipeline, HesModel
from hunyuan3d2_tpu_torch.pipelines.align import Img2img_Control_Ip_adapter as _Img2img

__all__ = ["Img2img_Control_Ip_adapter", "HesModel", "ControlNetSDPipeline"]


class Img2img_Control_Ip_adapter(_Img2img):
    """With ``backend`` (a callable (image, control, prompt, …) → image)
    calls go to it instead of the pipeline."""

    def __init__(self, device=None, backend=None, pipeline=None):
        self.backend = backend
        if backend is None:
            super().__init__(device=device, pipeline=pipeline)

    def __call__(self, prompt, control_image, ip_adapter_image=None, negative_prompt="",
                 **kwargs) -> Image.Image:
        if self.backend is not None:
            return self.backend(image=ip_adapter_image, control=control_image, prompt=prompt,
                                **kwargs)
        return super().__call__(prompt, control_image, ip_adapter_image, negative_prompt,
                                **kwargs)
