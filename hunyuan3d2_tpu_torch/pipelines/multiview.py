"""Multiview diffusion wrapper (port of hunyuan3d2_tpu/pipelines/multiview.py).

Resizes the inputs to the view size, packs the normal + position control
maps (device tensors, or the reference's list of PIL images) and the camera
indices into the paint pipeline's call, and seeds the sampler with 0, as
the reference does. The sampler is the standard one, or paint-turbo for the
turbo checkpoint.
"""

from __future__ import annotations

from typing import List

from hunyuan3d2_tpu_torch.pipelines.hunyuanpaint import HunyuanPaintPipeline


class Multiview_Diffusion_Net:
    def __init__(self, pipeline: HunyuanPaintPipeline, view_size: int = 512,
                 num_inference_steps: int = 30):
        self.pipeline = pipeline
        self.view_size = view_size
        self.num_inference_steps = num_inference_steps

    @classmethod
    def from_pretrained(cls, config, device=None):
        """The paint stack of ``config.multiview_ckpt_path`` /
        ``config.subfolder_name`` at 512² views; the turbo sampler when the
        config's ``pipe_name`` says so, else the standard one."""
        from hunyuan3d2_tpu_torch.io import checkpoints

        pipeline = checkpoints.load_paint_pipeline(config.multiview_ckpt_path,
                                                   config.subfolder_name, view_size=512,
                                                   device=device)
        if config.pipe_name == "hunyuanpaint-turbo":
            pipeline.set_turbo(True)
        return cls(pipeline)

    @classmethod
    def init_random(cls, size: str = "tiny", view_size: int = 64, num_inference_steps: int = 30,
                    device=None, seed: int = 0):
        return cls(HunyuanPaintPipeline.init_random(size=size, view_size=view_size,
                                                    device=device, seed=seed),
                   view_size, num_inference_steps)

    def __call__(self, input_images, control_images, camera_info: List[int],
                 output_type: str = "pil", init_latents=None, step_noises=None):
        """``control_images``: the (normal, position) cond maps as uint8
        tensors [N, size, size, 3] on the device, or a list of 2N images,
        the N normal maps then the N position maps (each resized to the view
        size; a grey "L" image becomes two-level, 255 above 1)."""
        if not isinstance(input_images, list):
            input_images = [input_images]
        size = self.view_size
        input_images = [im.resize((size, size)) for im in input_images]
        if isinstance(control_images, tuple):
            normal, position = control_images
            if normal.shape[1:3] != (size, size):
                raise ValueError(f"control maps are {tuple(normal.shape[1:3])}, the view size "
                                 f"is {size}²")
            num_view = normal.shape[0]
        else:
            control = []
            for im in control_images:
                im = im.resize((size, size))
                if im.mode == "L":
                    im = im.point(lambda x: 255 if x > 1 else 0, mode="1")
                control.append(im)
            num_view = len(control) // 2
            normal, position = [control[:num_view]], [control[num_view:2 * num_view]]
        return self.pipeline(
            input_images, width=size, height=size, num_in_batch=num_view,
            camera_info_gen=[camera_info], camera_info_ref=[[0]], normal_imgs=normal,
            position_imgs=position, num_inference_steps=self.num_inference_steps, seed=0,
            output_type=output_type, init_latents=init_latents, step_noises=step_noises).images
