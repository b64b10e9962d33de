"""MeshRender: the host renderer and texture baker of the paint pipeline
(port of hunyuan3d2_tpu/geometry/render.py).

Loading applies the reference's axis remap (x, y, z) → (−x, z, −y), the
V-flip of uv and the bounding-sphere rescale to scale_factor 1.15; cameras
are orthographic (ortho scale 1.2) or perspective, at distance 1.45.

On the host (numpy and the native C++ runtime): the normal, position,
depth, textured-colour and UV-space renders; the back-project bake (each
view's pixels splatted into texture space, weighted by cos^exp of the angle
to the camera, with the visibility eroded and depth edges masked out) and
its merge, which skips views whose texels are > 99 % painted already; the
fused per-view bake; the texture inpaint (native vertex-graph inpaint, then
the push-pull fill); the export. Per-corner UVs (uv_idx ≠ pos_idx) are
supported. The device texture path (geometry/render_device.py) uses the
mesh, camera and texture state kept here.
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


def linear_grid_put_2d(h: int, w: int, coords: np.ndarray, values: np.ndarray,
                       out: np.ndarray = None) -> np.ndarray:
    """Bilinear scatter-add of point samples into an [h, w, C] grid,
    normalised by the splatted weight (the native splat, whose scratch is
    handed to its OpenMP workers by pointer). ``out``: an optional reused
    target buffer."""
    return native.grid_put_linear(coords, values, h, w, out)


def _dilate(mask01: np.ndarray, ksize: int) -> np.ndarray:
    """Binary dilation with a ksize × ksize ones kernel."""
    import cv2

    if ksize <= 1:
        return mask01
    kernel = np.ones((ksize, ksize), np.uint8)
    return cv2.dilate(mask01.astype(np.uint8), kernel).astype(mask01.dtype)


class MeshRender:
    def __init__(self, camera_distance: float = 1.45, camera_type: str = "orth",
                 default_resolution: int = 1024, texture_size: int = 1024,
                 bake_mode: str = "linear", raster_mode: str = "cpu", **kwargs):
        self.camera_distance = camera_distance
        self.default_resolution = (default_resolution, default_resolution) \
            if isinstance(default_resolution, int) else tuple(default_resolution)
        self.texture_size = (texture_size, texture_size) \
            if isinstance(texture_size, int) else tuple(texture_size)
        self.bake_angle_thres = 75
        self.bake_unreliable_kernel_size = int((2 / 512) * max(self.default_resolution))
        # the reference's options, kept as the JAX package keeps them: the
        # bake is the linear splat and the raster the host's
        self.bake_mode = bake_mode
        self.raster_mode = raster_mode
        self.camera_type = camera_type
        if camera_type == "orth":
            self.ortho_scale = 1.2
            s = self.ortho_scale * 0.5
            self.camera_proj_mat = cam.ortho_projection(-s, s, -s, s, 0.1, 100)
        elif camera_type == "perspective":
            self.camera_proj_mat = cam.perspective_projection(
                49.13, self.default_resolution[1] / self.default_resolution[0], 0.01, 100.0)
        else:
            raise ValueError(f"no camera type {camera_type}")
        self.vtx_pos = None
        self.pos_idx = None
        self.vtx_uv = None
        self.uv_idx = None
        self.tex = None
        self._vn_cache = None
        self._bake_bufs = {}

    # -- mesh management -------------------------------------------------------
    def load_mesh(self, mesh, scale_factor: float = 1.15, auto_center: bool = True):
        """A Mesh (or a path Mesh.load reads); its UVs share the faces'
        indices."""
        if isinstance(mesh, str):
            mesh = Mesh.load(mesh)
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

    def get_texture(self):
        return self.tex

    def set_default_render_resolution(self, r):
        self.default_resolution = (r, r) if isinstance(r, int) else tuple(r)

    def set_default_texture_resolution(self, r):
        self.texture_size = (r, r) if isinstance(r, int) else tuple(r)

    def _same_idx(self) -> bool:
        """Whether the UVs share the positions' indices (one UV per vertex)."""
        return self.uv_idx is self.pos_idx or np.array_equal(self.uv_idx, self.pos_idx)

    # -- rasterization core ------------------------------------------------------
    def _mvp(self, elev, azim, camera_distance=None, center=None):
        mv = cam.get_mv_matrix(elev, azim, self.camera_distance if camera_distance is None
                               else camera_distance, center)
        return mv, (self.camera_proj_mat @ mv).astype(np.float32)

    def _rasterize(self, pos_clip: np.ndarray, tri: np.ndarray, resolution):
        h, w = (resolution, resolution) if isinstance(resolution, int) else resolution
        return native.rasterize(pos_clip, tri, h, w)

    @staticmethod
    def _interpolate(attr: np.ndarray, face_id: np.ndarray, bary: np.ndarray,
                     idx: np.ndarray) -> np.ndarray:
        """Per-pixel interpolation of per-vertex attributes [N, C] from the
        raster's face ids and barycentrics, one corner at a time (no
        [H, W, 3, C] temporary)."""
        attr = np.ascontiguousarray(attr, np.float32)
        tri = idx[np.maximum(face_id, 0)]             # [H, W, 3]
        out = attr[tri[..., 0]] * bary[..., 0:1]
        out += attr[tri[..., 1]] * bary[..., 1:2]
        out += attr[tri[..., 2]] * bary[..., 2:3]
        out[face_id < 0] = 0
        return out

    def _vertex_normals(self) -> np.ndarray:
        """World-space mean vertex normals, cached per mesh."""
        if self._vn_cache is None:
            v, f = self.vtx_pos, self.pos_idx
            fn = np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])
            fn = fn / np.maximum(np.linalg.norm(fn, axis=1, keepdims=True), 1e-12)
            self._vn_cache = mean_vertex_normals(len(v), f, fn)
        return self._vn_cache

    def _camera_geometry(self, elev, azim, camera_distance=None, center=None):
        """(clip-space positions, camera-space positions [N, 3], camera-space
        mean vertex normals) of one view."""
        mv, mvp = self._mvp(elev, azim, camera_distance, center)
        clip = cam.transform_pos(mvp, self.vtx_pos)
        pc = cam.transform_pos(mv, self.vtx_pos)
        pc = pc[:, :3] / pc[:, 3:4]
        f = self.pos_idx
        fn = np.cross(pc[f[:, 1]] - pc[f[:, 0]], pc[f[:, 2]] - pc[f[:, 0]])
        fn = fn / np.maximum(np.linalg.norm(fn, axis=1, keepdims=True), 1e-12)
        return clip, pc, mean_vertex_normals(len(self.vtx_pos), f, fn)

    # -- rendered maps -------------------------------------------------------------
    def render_normal(self, elev, azim, camera_distance=None, center=None, resolution=None,
                      bg_color=(1, 1, 1), use_abs_coor=False, normalize_rgb=True,
                      return_type="np"):
        """Camera-space (or, with ``use_abs_coor``, world) normal map with
        its coverage as a 4th channel."""
        resolution = resolution or self.default_resolution
        if use_abs_coor:
            _, mvp = self._mvp(elev, azim, camera_distance, center)
            clip = cam.transform_pos(mvp, self.vtx_pos)
            vn = self._vertex_normals()
        else:
            clip, _, vn = self._camera_geometry(elev, azim, camera_distance, center)
        fid, bary, _ = self._rasterize(clip, self.pos_idx, resolution)
        img = self._interpolate(vn, fid, bary, self.pos_idx)
        img = img / np.maximum(np.linalg.norm(img, axis=-1, keepdims=True), 1e-12)
        mask = (fid >= 0)[..., None]
        if normalize_rgb:
            img = (img + 1.0) * 0.5
        img = img * mask + np.asarray(bg_color, np.float32) * (1 - mask)
        return self._ret(np.concatenate([img, mask.astype(np.float32)], -1), return_type)

    def render_position(self, elev, azim, camera_distance=None, center=None, resolution=None,
                        bg_color=(1, 1, 1), return_type="np"):
        """World-position map scaled to [0, 1], with its coverage."""
        resolution = resolution or self.default_resolution
        _, mvp = self._mvp(elev, azim, camera_distance, center)
        clip = cam.transform_pos(mvp, self.vtx_pos)
        fid, bary, _ = self._rasterize(clip, self.pos_idx, resolution)
        img = self._interpolate(self.vtx_pos * 0.5 + 0.5, fid, bary, self.pos_idx)
        mask = (fid >= 0)[..., None]
        img = img * mask + np.asarray(bg_color, np.float32) * (1 - mask)
        return self._ret(np.concatenate([img, mask.astype(np.float32)], -1), return_type)

    def render_normal_position(self, elev, azim, camera_distance=None, center=None,
                               resolution=None, bg_color=(1, 1, 1), normalize_rgb=True):
        """The world-normal map (``use_abs_coor``) and the [0, 1] position
        map from one fused raster + interpolation pass → (normal, position),
        each [H, W, 4] with the coverage last."""
        resolution = resolution or self.default_resolution
        h, w = (resolution, resolution) if isinstance(resolution, int) else resolution
        _, mvp = self._mvp(elev, azim, camera_distance, center)
        clip = cam.transform_pos(mvp, self.vtx_pos)
        attrs = np.concatenate([self._vertex_normals(), self.vtx_pos * 0.5 + 0.5], axis=1)
        fid, _, _, amap = native.rasterize_interp(clip, self.pos_idx, attrs, h, w)
        amap[fid < 0] = 0
        mask = (fid >= 0)[..., None]
        nrm, pos = amap[..., :3], amap[..., 3:6]
        nrm = nrm / np.maximum(np.linalg.norm(nrm, axis=-1, keepdims=True), 1e-12)
        if normalize_rgb:
            nrm = (nrm + 1.0) * 0.5
        bg = np.asarray(bg_color, np.float32)
        nrm = nrm * mask + bg * (1 - mask)
        pos = pos * mask + bg * (1 - mask)
        maskf = mask.astype(np.float32)
        return np.concatenate([nrm, maskf], -1), np.concatenate([pos, maskf], -1)

    def render_depth(self, elev, azim, camera_distance=None, center=None, resolution=None,
                     return_type="np"):
        """Camera-space depth, normalised to [0, 1] over the covered pixels."""
        resolution = resolution or self.default_resolution
        clip, pc, _ = self._camera_geometry(elev, azim, camera_distance, center)
        fid, bary, _ = self._rasterize(clip, self.pos_idx, resolution)
        img = self._interpolate(pc[:, 2:3], fid, bary, self.pos_idx)
        mask = fid >= 0
        if mask.any():
            dmax, dmin = img[mask].max(), img[mask].min()
            img = (img - dmin) / max(dmax - dmin, 1e-12)
        return self._ret(img * mask[..., None], return_type)

    def render(self, elev, azim, camera_distance=None, center=None, resolution=None, tex=None,
               keep_alpha=True, bgcolor=None, return_type="np"):
        """Textured colour render (bilinear texture sample), with the
        coverage as the last channel when ``keep_alpha``."""
        if self.vtx_uv is None:
            raise ValueError("render: the mesh has no UVs")
        resolution = resolution or self.default_resolution
        _, mvp = self._mvp(elev, azim, camera_distance, center)
        clip = cam.transform_pos(mvp, self.vtx_pos)
        fid, bary, _ = self._rasterize(clip, self.pos_idx, resolution)
        uv = self._interpolate(self.vtx_uv, fid, bary, self.uv_idx)
        texture = self.tex if tex is None else np.asarray(tex, np.float32)
        th, tw = texture.shape[:2]
        x = np.clip(uv[..., 1] * (th - 1), 0, th - 1)
        y = np.clip(uv[..., 0] * (tw - 1), 0, tw - 1)
        x0, y0 = np.floor(x).astype(int), np.floor(y).astype(int)
        x1, y1 = np.minimum(x0 + 1, th - 1), np.minimum(y0 + 1, tw - 1)
        fx, fy = (x - x0)[..., None], (y - y0)[..., None]
        img = (texture[x0, y0] * (1 - fx) * (1 - fy) + texture[x0, y1] * (1 - fx) * fy
               + texture[x1, y0] * fx * (1 - fy) + texture[x1, y1] * fx * fy)
        mask = (fid >= 0)[..., None].astype(np.float32)
        if bgcolor is None:
            bgcolor = [0.0] * img.shape[-1]
        img = img * mask + np.asarray(bgcolor, np.float32) * (1 - mask)
        return self._ret(np.concatenate([img, mask], -1) if keep_alpha else img, return_type)

    def render_uvpos(self, return_type="np"):
        return self._ret(self.uv_feature_map(self.vtx_pos * 0.5 + 0.5), return_type)

    def uv_feature_map(self, vert_feat: np.ndarray, bg=None) -> np.ndarray:
        """Per-vertex features rasterized into UV space [th, tw, C]."""
        if self.vtx_uv is None:
            raise ValueError("uv_feature_map: the mesh has no UVs")
        uvc = self.vtx_uv * 2.0 - 1.0
        clip = np.concatenate([uvc, np.zeros((len(uvc), 1), np.float32),
                               np.ones((len(uvc), 1), np.float32)], axis=1)
        clip[:, 1] = -clip[:, 1]  # uv v grows downward in texture space
        fid, bary, _ = self._rasterize(clip, self.uv_idx, self.texture_size)
        fmap = self._interpolate(vert_feat, fid, bary, self.pos_idx)
        if bg is not None:
            fmap[fid < 0] = bg
        return fmap

    def render_sketch_from_depth(self, depth_image: np.ndarray) -> np.ndarray:
        """Canny edges (30, 80) of a [0, 1] depth image → [H, W, 1] in {0, 1}."""
        import cv2

        d = depth_image[..., 0] if depth_image.ndim == 3 else depth_image
        edges = cv2.Canny((np.clip(d, 0, 1) * 255).astype(np.uint8), 30, 80)
        return (edges.astype(np.float32) / 255.0)[..., None]

    # -- baking ---------------------------------------------------------------------
    def back_project(self, image, elev, azim, camera_distance=None, center=None, method=None,
                     _bufs=None):
        """Splat one view's pixels into UV texture space with the cosine and
        reliability masks → (texture [th, tw, C], cos map [th, tw, 1],
        depth-edge map [th, tw, 1]). ``method`` is accepted for the
        reference's signature (the splat is bilinear).

        ``_bufs``: a buffer dict for the fused bake's loop; the returned
        arrays then alias buffers valid until the next call with it."""
        image = np.asarray(image)
        if image.dtype == np.uint8:
            image = image.astype(np.float32) / 255.0
        if image.ndim == 2:
            image = image[..., None]
        resolution = image.shape[:2]
        channel = image.shape[-1]
        clip, pc, vn = self._camera_geometry(elev, azim, camera_distance, center)
        if self._same_idx():
            # one fused native pass: normals(3) | uv(2) | depth(1)
            attrs = np.concatenate([vn, self.vtx_uv, pc[:, 2:3]], axis=1)
            h, w = resolution
            fid, _, _, amap = native.rasterize_interp(clip, self.pos_idx, attrs, h, w,
                                                      bufs=_bufs)
            amap[fid < 0] = 0
            normal, uv, depth = amap[..., :3], amap[..., 3:5], amap[..., 5:6]
        else:
            fid, bary, _ = self._rasterize(clip, self.pos_idx, resolution)
            normal = self._interpolate(vn, fid, bary, self.pos_idx)
            uv = self._interpolate(self.vtx_uv, fid, bary, self.uv_idx)
            depth = self._interpolate(pc[:, 2:3], fid, bary, self.pos_idx)
        visible = (fid >= 0).astype(np.float32)
        if visible.any():
            dmin, dmax = depth[visible > 0].min(), depth[visible > 0].max()
            depth_img = (depth - dmin) / max(dmax - dmin, 1e-12) * visible[..., None]
        else:
            depth_img = depth
        sketch = self.render_sketch_from_depth(depth_img)

        # cosine to the camera's look direction (camera space: −z forward)
        cosang = -normal[..., 2:3]
        cosang[cosang < np.cos(self.bake_angle_thres / 180 * np.pi)] = 0
        ksize = self.bake_unreliable_kernel_size * 2 + 1
        # erode the visibility, dilate the depth edges; drop what is unreliable
        visible_eroded = (_dilate(1 - visible, ksize) == 0).astype(np.float32)
        sketch_dilated = _dilate((sketch[..., 0] > 0).astype(np.float32), ksize)
        reliable = visible_eroded * (sketch_dilated < 0.5)
        cosang = cosang * reliable[..., None]

        sel = (reliable > 0).reshape(-1)
        th, tw = self.texture_size
        coords = uv.reshape(-1, 2)[sel][:, [1, 0]]
        # one splat of [image | cos | sketch]
        stacked = np.concatenate([image.reshape(-1, channel)[sel], cosang.reshape(-1, 1)[sel],
                                  sketch.reshape(-1, 1)[sel]], axis=1)
        out_buf = None
        if _bufs is not None:
            out_buf = native._buf(_bufs, "bp_splat", (th, tw, channel + 2), np.float32)
        outs = linear_grid_put_2d(th, tw, coords, stacked, out=out_buf)
        return outs[..., :channel], outs[..., channel:channel + 1], outs[..., channel + 1:]

    def fast_bake_texture(self, textures, cos_maps):
        """Cos-weighted merge of the views' textures, skipping a view whose
        positive-cos texels are > 99 % painted by the views before it →
        (texture, trust mask [th, tw, 1])."""
        channel = textures[0].shape[-1]
        th, tw = self.texture_size
        tex_merge = np.zeros((th, tw, channel), np.float64)
        trust = np.zeros((th, tw, 1), np.float64)
        for texture, cos_map in zip(textures, cos_maps):
            view_sum = (cos_map > 0).sum()
            painted = ((cos_map > 0) & (trust > 0)).sum()
            if view_sum > 0 and painted / view_sum > 0.99:
                continue
            tex_merge += texture.astype(np.float64) * cos_map
            trust += cos_map
        tex_merge = tex_merge / np.maximum(trust, 1e-8)
        return tex_merge.astype(np.float32), trust > 1e-8

    def bake_texture(self, colors, elevs, azims, camera_distance=None, center=None, exp=6,
                     weights=None):
        """back_project of every view, then fast_bake_texture with weight ·
        cos^exp."""
        if weights is None:
            weights = [1.0] * len(colors)
        textures, cos_maps = [], []
        for color, elev, azim, weight in zip(colors, elevs, azims, weights):
            texture, cos_map, _ = self.back_project(color, elev, azim, camera_distance, center)
            cos_maps.append(weight * (cos_map ** exp))
            textures.append(texture)
        return self.fast_bake_texture(textures, cos_maps)

    def _reliable(self, fid: np.ndarray, amap: np.ndarray, bufs: dict) -> np.ndarray:
        """The reliability mask of one view's fused raster (uint8 [H, W]):
        visible after a ksize erosion and off the ksize-dilated Canny edges
        of the normalised depth."""
        h, w = fid.shape
        ksize = self.bake_unreliable_kernel_size * 2 + 1
        visible = native._buf(bufs, "bk_vis", (h, w), np.uint8)
        np.greater_equal(fid, 0, out=visible.view(bool))
        depth = amap[..., 5]
        dsel = depth[visible > 0]
        depth_img = native._buf(bufs, "bk_depth", (h, w), np.float32)
        if dsel.size:
            dmin, dmax = dsel.min(), dsel.max()
            np.multiply(depth - dmin, visible / max(dmax - dmin, 1e-12), out=depth_img)
        else:
            depth_img[:] = 0
        sketch = self.render_sketch_from_depth(depth_img)
        inv_dilated = _dilate(1 - visible, ksize)
        sketch_dilated = _dilate((sketch[..., 0] > 0).astype(np.uint8), ksize)
        reliable = native._buf(bufs, "bk_rel", (h, w), np.uint8)
        np.logical_and(inv_dilated == 0, sketch_dilated < 0.5, out=reliable.view(bool))
        return reliable

    def _view_raster(self, elev, azim, h: int, w: int, bufs: dict, camera_distance=None,
                     center=None):
        """The fused raster of one view for the bake: ([normal | uv | depth]
        map [H, W, 6], face ids, reliability mask)."""
        clip, pc, vn = self._camera_geometry(elev, azim, camera_distance, center)
        attrs = np.concatenate([vn, self.vtx_uv, pc[:, 2:3]], axis=1)
        fid, _, _, amap = native.rasterize_interp(clip, self.pos_idx, attrs, h, w, bufs=bufs)
        return amap, fid, self._reliable(fid, amap, bufs)

    def bake_texture_fused(self, colors, elevs, azims, camera_distance=None, center=None,
                           exp=6, weights=None):
        """bake_texture one view at a time, without keeping per-view maps:
        each view's mask, splat and merge run as one native pass into the
        running texture, the > 99 % skip testing the trust of the views
        before it as fast_bake_texture does. Per-corner UVs take
        bake_texture."""
        if weights is None:
            weights = [1.0] * len(colors)
        if not self._same_idx():
            return self.bake_texture(colors, elevs, azims, camera_distance, center, exp, weights)
        th, tw = self.texture_size
        bufs = self._bake_bufs
        tex_merge = None
        trust = np.zeros((th, tw), np.float32)
        cos_thres = np.cos(self.bake_angle_thres / 180 * np.pi)
        for color, elev, azim, weight in zip(colors, elevs, azims, weights):
            raw = np.asarray(color)
            if raw.ndim == 2:
                raw = raw[..., None]
            if raw.dtype == np.uint8:
                image = native._buf(bufs, "bk_img", raw.shape, np.float32)
                np.multiply(raw, np.float32(1.0 / 255.0), out=image)
            else:
                image = raw.astype(np.float32, copy=False)
            h, w = image.shape[:2]
            if tex_merge is None:
                tex_merge = np.zeros((th, tw, image.shape[-1]), np.float32)
            amap, fid, reliable = self._view_raster(elev, azim, h, w, bufs, camera_distance,
                                                    center)
            native.bake_view(amap, fid, image, reliable, cos_thres, weight, exp, tex_merge, trust)
        if tex_merge is None:
            return np.zeros((th, tw, 3), np.float32), np.zeros((th, tw, 1), bool)
        tex_merge /= np.maximum(trust[..., None], 1e-8)
        return tex_merge, trust[..., None] > 1e-8

    def prepare_bake_geometry(self, elevs, azims, camera_distance=None, center=None,
                              resolution=None):
        """The colour-independent half of the fused bake at the bake
        resolution: per view ([normal | uv | depth] map, face ids,
        reliability mask), in per-view buffers valid until the next call.
        None for per-corner UVs (bake_texture_fused takes those)."""
        if not self._same_idx():
            return None
        h = w = resolution or max(self.default_resolution)
        return [self._view_raster(elev, azim, h, w,
                                  self._bake_bufs.setdefault(f"geom_v{vi}", {}),
                                  camera_distance, center)
                for vi, (elev, azim) in enumerate(zip(elevs, azims))]

    def bake_texture_prepared(self, views_u8, geometry, exp=6, weights=None):
        """The colour-dependent half: each uint8 view at its native size,
        sampled bilinearly at the raster's pixels, splatted and merged with
        the prepared geometry → (texture, trust mask [th, tw, 1])."""
        views_u8 = np.asarray(views_u8)
        if weights is None:
            weights = [1.0] * len(views_u8)
        th, tw = self.texture_size
        tex_merge = np.zeros((th, tw, views_u8.shape[-1]), np.float32)
        trust = np.zeros((th, tw), np.float32)
        cos_thres = np.cos(self.bake_angle_thres / 180 * np.pi)
        for (amap, fid, reliable), view, weight in zip(geometry, views_u8, weights):
            native.bake_view_u8(amap, fid, view, reliable, cos_thres, weight, exp, tex_merge,
                                trust)
        tex_merge /= np.maximum(trust[..., None], 1e-8)
        return tex_merge, trust[..., None] > 1e-8

    def uv_inpaint(self, texture, mask: np.ndarray) -> np.ndarray:
        """Vertex-graph inpaint, then the push-pull fill of what is left →
        uint8 texture."""
        texture = np.asarray(texture, np.float32)
        vtx_pos, pos_idx, vtx_uv, uv_idx = self.get_mesh()
        texture, mask = native.vertex_inpaint(texture, mask.astype(np.uint8), vtx_pos, vtx_uv,
                                              pos_idx, uv_idx)
        filled = native.pushpull_fill(texture, mask)
        return (np.clip(filled, 0, 1) * 255).astype(np.uint8)

    # -- misc -------------------------------------------------------------------------
    def save_mesh(self) -> Mesh:
        """Textured mesh in the original coordinate convention."""
        v, f, uv, _ = self.get_mesh()
        tex = None
        if self.tex is not None:
            tex = (np.clip(self.tex, 0, 1) * 255).astype(np.uint8)
        return Mesh(v, f, uv=uv, texture=tex)

    @staticmethod
    def _ret(img: np.ndarray, return_type: str):
        """``"np"`` (or ``"th"``): the float array; ``"pl"``: a PIL image."""
        if return_type in ("np", "th"):
            return img
        if return_type == "pl":
            from PIL import Image

            arr = np.clip(img, 0, 1)
            if arr.shape[-1] == 1:
                arr = arr[..., 0]
            return Image.fromarray((arr * 255).astype(np.uint8))
        raise ValueError(return_type)
