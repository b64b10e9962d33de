"""MeshRender: the mesh, camera and texture state of the paint pipeline
(the part of hunyuan3d2_tpu/geometry/render.py that the device texture path
uses, copied).

Loading applies the reference's axis remap (x, y, z) → (−x, z, −y), the
V-flip of uv and the bounding-sphere rescale to scale_factor 1.15; cameras
are orthographic (ortho scale 1.2) at distance 1.45. The rasterizing and
baking itself runs on the device (geometry/render_device.py); the host keeps
the vertex normals, the texture inpaint (native vertex-graph inpaint +
push-pull fill) and the export.
"""

from __future__ import annotations

import numpy as np

from hunyuan3d2_tpu_torch import native
from hunyuan3d2_tpu_torch.geometry import camera as cam
from hunyuan3d2_tpu_torch.geometry.mesh import Mesh


def mean_vertex_normals(n_vertices: int, faces: np.ndarray,
                        face_normals: np.ndarray) -> np.ndarray:
    vn = np.zeros((n_vertices, 3), np.float64)
    for k in range(3):
        np.add.at(vn, faces[:, k], face_normals)
    lens = np.linalg.norm(vn, axis=1, keepdims=True)
    return (vn / np.maximum(lens, 1e-12)).astype(np.float32)


class MeshRender:
    def __init__(self, camera_distance: float = 1.45, default_resolution: int = 1024,
                 texture_size: int = 1024):
        self.camera_distance = camera_distance
        self.default_resolution = (default_resolution, default_resolution) \
            if isinstance(default_resolution, int) else tuple(default_resolution)
        self.texture_size = (texture_size, texture_size) \
            if isinstance(texture_size, int) else tuple(texture_size)
        s = 1.2 * 0.5
        self.camera_proj_mat = cam.ortho_projection(-s, s, -s, s, 0.1, 100)
        self.vtx_pos = None
        self.pos_idx = None
        self.vtx_uv = None
        self.uv_idx = None
        self.tex = None
        self._vn_cache = None

    # -- mesh management -------------------------------------------------------
    def load_mesh(self, mesh: Mesh, scale_factor: float = 1.15, auto_center: bool = True):
        uv = mesh.uv
        self.set_mesh(mesh.vertices, mesh.faces, vtx_uv=uv,
                      uv_idx=mesh.faces if uv is not None else None,
                      scale_factor=scale_factor, auto_center=auto_center)
        if mesh.texture is not None:
            self.set_texture(mesh.texture)

    def set_mesh(self, vtx_pos, pos_idx, vtx_uv=None, uv_idx=None,
                 scale_factor: float = 1.15, auto_center: bool = True):
        v = np.asarray(vtx_pos, np.float32).copy()
        # axis remap: negate x, y then swap y and z → (x, y, z) → (−x, z, −y)
        v[:, [0, 1]] = -v[:, [0, 1]]
        v[:, [1, 2]] = v[:, [2, 1]]
        self.vtx_pos = v
        self.pos_idx = np.asarray(pos_idx, np.int32)
        if vtx_uv is not None and uv_idx is not None:
            uv = np.asarray(vtx_uv, np.float32).copy()
            uv[:, 1] = 1.0 - uv[:, 1]
            self.vtx_uv = uv
            self.uv_idx = np.asarray(uv_idx, np.int32)
        else:
            self.vtx_uv = None
            self.uv_idx = None
        self._vn_cache = None
        if auto_center:
            vmax, vmin = v.max(0), v.min(0)
            center = (vmax + vmin) / 2
            scale = np.linalg.norm(v - center, axis=1).max() * 2.0
            self.vtx_pos = (v - center) * (scale_factor / max(scale, 1e-12))
            self.scale_factor = scale_factor

    def get_mesh(self):
        """(vtx_pos, pos_idx, vtx_uv, uv_idx) in the original coordinate
        convention (the axis remap and the uv flip undone)."""
        v = self.vtx_pos.copy()
        v[:, [1, 2]] = v[:, [2, 1]]
        v[:, [0, 1]] = -v[:, [0, 1]]
        uv = None
        if self.vtx_uv is not None:
            uv = self.vtx_uv.copy()
            uv[:, 1] = 1.0 - uv[:, 1]
        return v, self.pos_idx.copy(), uv, (None if self.uv_idx is None else self.uv_idx.copy())

    def set_texture(self, tex):
        tex = np.asarray(tex)
        if tex.dtype == np.uint8:
            tex = tex.astype(np.float32) / 255.0
        if tex.shape[:2] != self.texture_size:
            from PIL import Image

            im = Image.fromarray((np.clip(tex, 0, 1) * 255).astype(np.uint8))
            im = im.resize(self.texture_size[::-1], Image.BILINEAR)
            tex = np.asarray(im).astype(np.float32) / 255.0
        self.tex = tex[..., :3].astype(np.float32)

    def _mvp(self, elev, azim):
        mv = cam.get_mv_matrix(elev, azim, self.camera_distance)
        return mv, (self.camera_proj_mat @ mv).astype(np.float32)

    def _vertex_normals(self) -> np.ndarray:
        """World-space mean vertex normals, cached per mesh."""
        if self._vn_cache is None:
            v, f = self.vtx_pos, self.pos_idx
            fn = np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])
            fn = fn / np.maximum(np.linalg.norm(fn, axis=1, keepdims=True), 1e-12)
            self._vn_cache = mean_vertex_normals(len(v), f, fn)
        return self._vn_cache

    def uv_inpaint(self, texture, mask: np.ndarray) -> np.ndarray:
        """Vertex-graph inpaint, then the push-pull fill of what is left →
        uint8 texture."""
        texture = np.asarray(texture, np.float32)
        vtx_pos, pos_idx, vtx_uv, uv_idx = self.get_mesh()
        texture, mask = native.vertex_inpaint(texture, mask.astype(np.uint8), vtx_pos, vtx_uv,
                                              pos_idx, uv_idx)
        filled = native.pushpull_fill(texture, mask)
        return (np.clip(filled, 0, 1) * 255).astype(np.uint8)

    def save_mesh(self) -> Mesh:
        """Textured mesh in the original coordinate convention."""
        v, f, uv, _ = self.get_mesh()
        tex = None
        if self.tex is not None:
            tex = (np.clip(self.tex, 0, 1) * 255).astype(np.uint8)
        return Mesh(v, f, uv=uv, texture=tex)
