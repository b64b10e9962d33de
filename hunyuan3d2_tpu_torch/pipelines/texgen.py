"""Texture generation: mesh + image → textured mesh (port of
hunyuan3d2_tpu/pipelines/texgen.py, the device texture path).

Six candidate cameras (azims [0, 90, 180, 270, 0, 180], elevs
[0, 0, 0, 0, 90, −90], weights [1, .1, .5, .1, .05, .05]), render 2048,
texture 2048, bake exponent 4. Stages: the UV unwrap (host) runs in the host
worker process (utils/host_worker.py) from the start of the call, while the
device computes the cond maps (device raster) and the multiview diffusion
(the standard EulerAncestral + CFG sampler, or paint-turbo); then, with the
unwrapped mesh, bake geometry (device) → bake (device) → inpaint (host). The
result is the serial order's bit for bit. A failure raises: there is no
host-bake fallback, and an unwrap that fails in the worker is not run again
in-process. The host renders and bake are public stage methods
(``render_normal_multiview``, ``render_position_multiview``,
``bake_from_multiview``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from hunyuan3d2_tpu_torch.geometry.render import MeshRender
from hunyuan3d2_tpu_torch.geometry.render_device import (
    bake_prepared,
    cond_maps,
    prepare_bake,
    upload_mesh,
)
from hunyuan3d2_tpu_torch.geometry.mesh import Mesh
from hunyuan3d2_tpu_torch.geometry.uv import mesh_uv_wrap_arrays
from hunyuan3d2_tpu_torch.pipelines.multiview import Multiview_Diffusion_Net
from hunyuan3d2_tpu_torch.utils import host_worker
from hunyuan3d2_tpu_torch.utils.timer import LAST_TIMINGS, timed_scope


class Hunyuan3DTexGenConfig:
    """``subfolder_name`` picks the sampler: the turbo (LCM) loop for
    ``hunyuan3d-paint-v2-0-turbo``, the standard (EulerAncestral + CFG) one
    otherwise. ``light_remover_ckpt_path`` is accepted for the reference's
    signature; the delight stage is not on this path."""

    def __init__(self, light_remover_ckpt_path=None, multiview_ckpt_path=None,
                 subfolder_name: str = "hunyuan3d-paint-v2-0-turbo"):
        self.light_remover_ckpt_path = light_remover_ckpt_path
        self.multiview_ckpt_path = multiview_ckpt_path
        self.subfolder_name = subfolder_name
        self.candidate_camera_azims = [0, 90, 180, 270, 0, 180]
        self.candidate_camera_elevs = [0, 0, 0, 0, 90, -90]
        self.candidate_view_weights = [1, 0.1, 0.5, 0.1, 0.05, 0.05]
        self.render_size = 2048
        self.texture_size = 2048
        self.bake_exp = 4
        self.pipe_dict = {"hunyuan3d-paint-v2-0": "hunyuanpaint",
                          "hunyuan3d-paint-v2-0-turbo": "hunyuanpaint-turbo"}
        self.pipe_name = self.pipe_dict.get(subfolder_name, "hunyuanpaint")


def camera_info_index(azim: int, elev: int) -> int:
    """The reference's camera-index formula."""
    div = {-20: 1, 0: 1, 20: 1, -90: 3, 90: 3}[elev]
    off = {-20: 0, 0: 12, 20: 24, -90: 36, 90: 40}[elev]
    return (((azim // 30) + 9) % 12) // div + off


class Hunyuan3DPaintPipeline:
    """mesh + image → textured mesh, on ``device``."""

    def __init__(self, models: dict, config: Optional[Hunyuan3DTexGenConfig] = None,
                 device=None):
        self.config = config or Hunyuan3DTexGenConfig()
        self.models = models  # {'multiview_model': Multiview_Diffusion_Net}
        self.device = torch.device(device if device is not None else "cuda")
        self.render = MeshRender(default_resolution=self.config.render_size,
                                 texture_size=self.config.texture_size)
        self.unwrap_pid = None   # the process that ran the last call's unwrap

    def shard(self, mesh=None):
        """Distribute the multiview diffusion stack over a (dp, tp)
        ``DeviceMesh`` (see HunyuanPaintPipeline.shard); the renders and
        the bake run whole on every rank."""
        self.models["multiview_model"].pipeline.shard(mesh)
        return self

    @classmethod
    def from_pretrained(cls, model_path: str, subfolder: str = "hunyuan3d-paint-v2-0-turbo",
                        device=None, **kwargs):
        """The paint stack of the diffusers-layout directory
        ``{model_path}/{subfolder}`` (``unet/`` and ``vae/``; local, or under
        ``$HY3DGEN_MODELS``) on ``device`` (``cuda`` unless the caller passes
        another); the turbo sampler when ``subfolder`` is the turbo model's,
        else the standard one.
        Other keywords are accepted for the reference's signature."""
        config = Hunyuan3DTexGenConfig(multiview_ckpt_path=model_path, subfolder_name=subfolder)
        return cls({"multiview_model": Multiview_Diffusion_Net.from_pretrained(config, device)},
                   config, device)

    @classmethod
    def init_random(cls, size: str = "tiny", view_size: int = 64, render_size: int = 256,
                    texture_size: int = 256, num_inference_steps: int = 30, device=None,
                    seed: int = 0):
        """Random-weight paint stack (``size`` "default" or "tiny", see
        HunyuanPaintPipeline.init_random) with the standard sampler, on
        ``device`` (``cuda`` unless the caller passes another)."""
        device = torch.device(device if device is not None else "cuda")
        config = Hunyuan3DTexGenConfig()
        config.render_size = render_size
        config.texture_size = texture_size
        mv = Multiview_Diffusion_Net.init_random(size, view_size, num_inference_steps, device,
                                                 seed)
        return cls({"multiview_model": mv}, config, device)

    def set_turbo(self, turbo: bool = True):
        """Sample with the paint-turbo LCM loop, or (``turbo=False``) the
        standard EulerAncestral + CFG loop."""
        self.models["multiview_model"].pipeline.set_turbo(turbo)
        return self

    def recenter_image(self, image, border_ratio: float = 0.2):
        """Crop to the alpha bbox, pad each side by border_ratio of the
        cropped size, paste centred on a square transparent canvas."""
        from PIL import Image

        if not isinstance(image, Image.Image):
            image = Image.fromarray(np.asarray(image))
        if image.mode == "RGB":
            return image
        if image.mode == "L":
            return image.convert("RGB")
        image = image.convert("RGBA")
        alpha = np.asarray(image)[:, :, 3]
        nz = np.argwhere(alpha > 0)
        if nz.size == 0:
            raise ValueError("Image is fully transparent")
        min_row, min_col = nz.min(axis=0)
        max_row, max_col = nz.max(axis=0)
        cropped = image.crop((min_col, min_row, max_col + 1, max_row + 1))
        width, height = cropped.size
        bw, bh = int(width * border_ratio), int(height * border_ratio)
        square = max(width + 2 * bw, height + 2 * bh)
        canvas = Image.new("RGBA", (square, square), (255, 255, 255, 0))
        canvas.paste(cropped, ((square - width - 2 * bw) // 2 + bw,
                               (square - height - 2 * bh) // 2 + bh))
        return canvas

    def render_normal_multiview(self, camera_elevs, camera_azims, use_abs_coor=True,
                                resolution=None):
        """Host normal maps of the loaded mesh, one uint8 PIL image a view."""
        from PIL import Image

        out = []
        for elev, azim in zip(camera_elevs, camera_azims):
            nm = self.render.render_normal(elev, azim, use_abs_coor=use_abs_coor,
                                           resolution=resolution, return_type="np")
            out.append(Image.fromarray((np.clip(nm[..., :3], 0, 1) * 255).astype(np.uint8)))
        return out

    def render_position_multiview(self, camera_elevs, camera_azims, resolution=None):
        """Host position maps of the loaded mesh, one uint8 PIL image a view."""
        from PIL import Image

        out = []
        for elev, azim in zip(camera_elevs, camera_azims):
            pm = self.render.render_position(elev, azim, resolution=resolution, return_type="np")
            out.append(Image.fromarray((np.clip(pm[..., :3], 0, 1) * 255).astype(np.uint8)))
        return out

    def bake_from_multiview(self, views, camera_elevs, camera_azims, view_weights,
                            method: str = "fast"):
        """The host bake of the views into the loaded mesh's UV space →
        (texture, trust mask): the fused per-view merge, the same arithmetic
        as back_project of each view then fast_bake_texture."""
        if method != "fast":
            raise ValueError(f"no method {method}")
        return self.render.bake_texture_fused(views, camera_elevs, camera_azims,
                                              exp=self.config.bake_exp,
                                              weights=list(view_weights))

    def texture_inpaint(self, texture: np.ndarray, mask: np.ndarray):
        return self.render.uv_inpaint(texture, mask)

    @torch.no_grad()
    def __call__(self, mesh, image, init_latents=None, step_noises=None):
        """Texture ``mesh`` from ``image`` (a PIL image, a path, or a list).
        ``init_latents`` / ``step_noises`` replace the sampler's draws."""
        from PIL import Image

        # the unwrap needs only the mesh: the host worker runs it while the
        # device computes the cond maps and the diffusion (a mesh that has
        # UVs is kept as it is)
        unwrap = None if mesh.uv is not None else host_worker.submit(
            mesh_uv_wrap_arrays, mesh.vertices, mesh.faces)
        images = image if isinstance(image, list) else [image]
        images = [self.recenter_image(Image.open(im) if isinstance(im, str) else im)
                  for im in images]
        elevs = self.config.candidate_camera_elevs
        azims = self.config.candidate_camera_azims
        weights = self.config.candidate_view_weights
        mv_net = self.models["multiview_model"]
        dev = self.device

        # cond maps need only positions and normals: the raw mesh's (the
        # unwrap splits seam vertices but moves none)
        self.render.load_mesh(mesh)
        dev_geo = upload_mesh(self.render, dev)
        mats = [self.render._mvp(e, a) for e, a in zip(elevs, azims)]
        mvs = torch.from_numpy(np.stack([m[0] for m in mats]).astype(np.float32)).to(dev)
        mvps = torch.from_numpy(np.stack([m[1] for m in mats]).astype(np.float32)).to(dev)
        with timed_scope("Cond Maps (device)"):
            normal_dev, position_dev = cond_maps(dev_geo, mvps, mv_net.view_size)
        camera_info = [camera_info_index(a, e) for a, e in zip(azims, elevs)]
        with timed_scope("Multiview Diffusion (device)"):
            views = mv_net(images, (normal_dev, position_dev), camera_info,
                           output_type="device", init_latents=init_latents,
                           step_noises=step_noises)
        del normal_dev, position_dev
        if unwrap is None:
            wrapped = mesh
        else:
            with timed_scope("UV Unwrap (wait)"):
                (nv, nf, uv), seconds, self.unwrap_pid = unwrap.result()
            LAST_TIMINGS["UV Unwrap (overlaps denoise)"] = seconds
            wrapped = Mesh(nv, nf, uv=uv)
        self.render.load_mesh(wrapped)
        dev_mesh = upload_mesh(self.render, dev, need_uv=True)
        render_res = max(self.render.default_resolution)
        tex_res = self.render.texture_size[0]
        # the bake samples the views through a render_res-matched upsample
        up_res = min(render_res, 4 * mv_net.view_size)
        with timed_scope("Bake Geometry (device)"):
            geom = prepare_bake(dev_mesh, mvs, mvps, weights, render_res=render_res,
                                tex_res=tex_res, up_res=up_res, exp=float(self.config.bake_exp))
        with timed_scope("Texture Baking (device)"):
            texture, trust = bake_prepared(geom, views, tex_res, up_res)
            texture = texture.cpu().numpy()
            mask = ((trust > 1e-8).cpu().numpy() * 255).astype(np.uint8)
        del geom
        with timed_scope("Texture Inpaint"):
            texture = self.texture_inpaint(texture, mask)
        self.render.set_texture(texture)
        return self.render.save_mesh()
