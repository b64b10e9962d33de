"""Device-resident renders and texture bake of the paint pipeline (port of
hunyuan3d2_tpu/geometry/render_tpu.py).

The bake runs in texture space as a gather:
  1. the mesh is rasterized once in UV space, giving each texel its 3D
     position and normal;
  2. each view is rasterized once (depth + coverage) for occlusion and
     reliability (visibility erosion + depth-edge exclusion);
  3. each texel is projected into each view, depth-tested against the view's
     z-buffer, and samples the upsampled view colour at its projection,
     weighted by weight·cos^exp.
Every raster (the cond maps, the UV raster, the bake views) goes through
ops/rasterize.py, which on a CUDA tensor is the hand-written kernel. The
rest is dense PyTorch: gathers, elementwise work, max-pool dilations, a
bilinear upsample. Orthographic cameras only, as in the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from hunyuan3d2_tpu_torch.ops.rasterize import interpolate, rasterize


class BakeMeshDev(NamedTuple):
    """Mesh on the device for rendering and baking (shared-corner UVs)."""
    verts: torch.Tensor            # [V, 3] float32 (render convention, rescaled)
    faces: torch.Tensor            # [F, 3] int32
    normals: torch.Tensor          # [V, 3] float32 world vertex normals
    uv: Optional[torch.Tensor]     # [V, 2] float32 (V-flipped) or None


def upload_mesh(render, device, need_uv: bool = False) -> BakeMeshDev:
    """A loaded MeshRender's mesh on ``device``. With ``need_uv`` the mesh
    must carry shared-corner UVs: the device bake takes one UV per vertex,
    and per-corner UVs (uv_idx ≠ pos_idx) take the host bake
    (``MeshRender.bake_texture_fused``)."""
    uv = None
    if render.vtx_uv is not None:
        if not render._same_idx():
            raise ValueError("upload_mesh: per-corner UVs (uv_idx ≠ pos_idx) take the host "
                             "bake, MeshRender.bake_texture_fused")
        uv = torch.from_numpy(np.asarray(render.vtx_uv, np.float32)).to(device)
    if need_uv and uv is None:
        raise ValueError("upload_mesh: the mesh has no UVs (unwrap it first)")

    def put(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device)

    return BakeMeshDev(put(render.vtx_pos, np.float32), put(render.pos_idx, np.int32),
                       put(render._vertex_normals(), np.float32), uv)


def _homogeneous(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x, torch.ones_like(x[..., :1])], dim=-1)


def _dilate_max(x: torch.Tensor, k: int) -> torch.Tensor:
    """k×k max filter of an [H, W] map with SAME padding (−inf fill), as two
    separable 1-D passes."""
    if k <= 1:
        return x
    y = F.max_pool2d(x[None, None], (k, 1), stride=1, padding=(k // 2, 0))
    return F.max_pool2d(y, (1, k), stride=1, padding=(0, k // 2))[0, 0]


def _sobel_edges(d: torch.Tensor, thresh: float) -> torch.Tensor:
    """Depth-edge map: Sobel gradient magnitude over ``thresh`` ([H, W] →
    bool), edge-replicated border."""
    dp = F.pad(d[None, None], (1, 1, 1, 1), mode="replicate")[0, 0]
    gx = (dp[1:-1, 2:] - dp[1:-1, :-2]) * 2.0 \
        + dp[:-2, 2:] - dp[:-2, :-2] + dp[2:, 2:] - dp[2:, :-2]
    gy = (dp[2:, 1:-1] - dp[:-2, 1:-1]) * 2.0 \
        + dp[2:, 2:] - dp[:-2, 2:] + dp[2:, :-2] - dp[:-2, :-2]
    return torch.sqrt(gx * gx + gy * gy) > thresh


def _to_u8(x: torch.Tensor) -> torch.Tensor:
    return torch.round(x.clamp(0.0, 1.0) * 255.0).to(torch.uint8)


def cond_maps(mesh: BakeMeshDev, mvps: torch.Tensor, res: int):
    """World-normal (mapped to [0, 1]) and position cond maps of every view:
    mvps [N, 4, 4] → (normal, position), each [N, res, res, 3] uint8 with a
    white background."""
    vh = _homogeneous(mesh.verts)
    attrs = torch.cat([mesh.normals, mesh.verts * 0.5 + 0.5], dim=1)
    normals, positions = [], []
    for mvp in mvps:
        out = rasterize(vh @ mvp.T, mesh.faces, res, res)
        amap = interpolate(out, mesh.faces, attrs)
        mask = (out.face_id >= 0)[..., None]
        nrm = amap[..., :3]
        nrm = nrm / torch.linalg.norm(nrm, dim=-1, keepdim=True).clamp_min(1e-12)
        nrm = (nrm + 1.0) * 0.5
        normals.append(_to_u8(torch.where(mask, nrm, 1.0)))
        positions.append(_to_u8(torch.where(mask, amap[..., 3:6], 1.0)))
    return torch.stack(normals), torch.stack(positions)


def _uv_geometry(mesh: BakeMeshDev, tex_res: int):
    """UV-space raster → per-texel 3D position, unit normal and validity."""
    uvc = mesh.uv * 2.0 - 1.0
    zeros = torch.zeros_like(uvc[:, 0])
    uv_clip = torch.stack([uvc[:, 0], -uvc[:, 1], zeros, zeros + 1.0], dim=1)
    uv_out = rasterize(uv_clip, mesh.faces, tex_res, tex_res)
    tex_attr = interpolate(uv_out, mesh.faces, torch.cat([mesh.verts, mesh.normals], 1))
    tex_nrm = tex_attr[..., 3:6]
    tex_nrm = tex_nrm / torch.linalg.norm(tex_nrm, dim=-1, keepdim=True).clamp_min(1e-12)
    return tex_attr[..., :3], tex_nrm, uv_out.face_id >= 0


def _bake_view_geom(mesh: BakeMeshDev, tex_pos, tex_nrm, tex_valid, mv, mvp, weight: float, *,
                    render_res: int, up_res: int, exp: float, cos_thres: float,
                    kernel_size: int, depth_bias: float, edge_thresh: float):
    """The colour-independent half of one view's bake: raster + reliability
    masks + texel projection → (per-texel weight, candidate mask, index into
    the up_res² upsampled view)."""
    r = render_res
    rout = rasterize(_homogeneous(mesh.verts) @ mvp.T, mesh.faces, r, r)
    visible = (rout.face_id >= 0).float()
    d = rout.depth
    dmin = torch.where(visible > 0, d, torch.inf).min()
    dmax = torch.where(visible > 0, d, -torch.inf).max()
    dnorm = (d - dmin) / (dmax - dmin).clamp_min(1e-12) * visible
    edges = _sobel_edges(dnorm, edge_thresh).float()
    inv_dil = _dilate_max(1.0 - visible, kernel_size)
    edge_dil = _dilate_max(edges, kernel_size)
    reliable = ((inv_dil <= 0.0) & (edge_dil < 0.5)).float()

    # project texels into the view (screen x = column, y = row)
    pclip = torch.einsum("hwc,dc->hwd", _homogeneous(tex_pos), mvp)
    pw = torch.where(pclip[..., 3] == 0.0, 1e-8, pclip[..., 3])
    sx = (pclip[..., 0] / pw * 0.5 + 0.5) * (r - 1)
    sy = (0.5 - pclip[..., 1] / pw * 0.5) * (r - 1)
    tz = (pclip[..., 2] / pw * 0.5 + 0.5).clamp(0.0, 1.0)
    inb = (sx >= 0) & (sx <= r - 1) & (sy >= 0) & (sy <= r - 1)

    # occlusion against a 3×3 max-pooled z-buffer (curvature between raster
    # samples must not self-occlude), z and reliability in one gather
    zmax = _dilate_max(torch.where(visible > 0, d, 0.0), 3)
    comb = torch.stack([zmax, reliable], dim=-1).reshape(-1, 2)
    rx = torch.round(sy).clamp(0, r - 1).long()
    ry = torch.round(sx).clamp(0, r - 1).long()
    samp = comb[(rx * r + ry).reshape(-1)].reshape(sx.shape + (2,))
    occl_ok = tz <= samp[..., 0] + depth_bias
    rel = samp[..., 1] > 0.5

    # cosine between the texel normal and the view direction (camera −z)
    cosang = -torch.einsum("hwc,c->hw", tex_nrm, mv[2, :3])
    cosang = torch.where(cosang < cos_thres, 0.0, cosang)
    ok = tex_valid & inb & occl_ok & rel
    w = torch.where(ok, weight * torch.pow(cosang, exp), 0.0)
    cand = (cosang > 0.0) & ok

    # index into the up_res² view at the texel's projection (pixel centres)
    ux = torch.round((sy + 0.5) * (up_res / r) - 0.5).clamp(0, up_res - 1).long()
    uy = torch.round((sx + 0.5) * (up_res / r) - 0.5).clamp(0, up_res - 1).long()
    return w, cand, ux * up_res + uy


def _bake_view_accum(view_u8, w, cand, idx, acc, trust, *, up_res: int):
    """The colour half of one view's bake: bilinear upsample of the view
    (half-pixel centres, as jax.image.resize), gather at the prepared
    indices, skip the view when > 99 % of its candidates are painted
    already, accumulate in place."""
    up = F.interpolate(view_u8.float().permute(2, 0, 1)[None], size=(up_res, up_res),
                       mode="bilinear", align_corners=False, antialias=False)
    up = up[0].permute(1, 2, 0).reshape(-1, view_u8.shape[-1]) / 255.0
    color = up[idx.reshape(-1)].reshape(idx.shape + (-1,))
    painted = ((trust > 0.0) & cand).sum()
    total = cand.sum().clamp_min(1)
    keep = (painted.float() / total.float()) <= 0.99
    wk = torch.where(keep, w, 0.0)
    acc += wk[..., None] * color
    trust += wk


def prepare_bake(mesh: BakeMeshDev, mvs, mvps, weights, *, render_res: int, tex_res: int,
                 up_res: int, exp: float = 4.0, cos_thres: float = 0.2588,
                 kernel_size: int = 0, depth_bias: float = 2e-4, edge_thresh: float = 0.25):
    """Phase A of the bake: UV geometry + per-view weights and sample indices
    (independent of the view colours). mvs / mvps [N, 4, 4]. kernel_size 0
    ⇒ the reference's resolution-scaled erosion 2·int(2/512·render_res)+1.
    cos_thres defaults to cos(75°)."""
    if kernel_size <= 0:
        kernel_size = 2 * int((2 / 512) * render_res) + 1
    tex_pos, tex_nrm, tex_valid = _uv_geometry(mesh, tex_res)
    return [_bake_view_geom(mesh, tex_pos, tex_nrm, tex_valid, mvs[v], mvps[v], float(weights[v]),
                            render_res=render_res, up_res=up_res, exp=float(exp),
                            cos_thres=float(cos_thres), kernel_size=kernel_size,
                            depth_bias=float(depth_bias), edge_thresh=float(edge_thresh))
            for v in range(len(mvs))]


def bake_prepared(geom, views_u8: torch.Tensor, tex_res: int, up_res: int):
    """Phase B: accumulate the views [N, vh, vw, C] uint8 through the
    prepared geometry → (texture [tex, tex, C] in [0, 1], trust [tex, tex])."""
    dev = views_u8.device
    acc = torch.zeros(tex_res, tex_res, views_u8.shape[-1], device=dev)
    trust = torch.zeros(tex_res, tex_res, device=dev)
    for v, (w, cand, idx) in enumerate(geom):
        _bake_view_accum(views_u8[v], w, cand, idx, acc, trust, up_res=up_res)
    return acc / trust.clamp_min(1e-8)[..., None], trust
