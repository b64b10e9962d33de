"""Z-buffer triangle rasterizer: the hand-written Hopper kernel and its plain
twin (port of hunyuan3d2_tpu/ops/rasterize_tpu.py).

``rasterize(verts, faces, h, w)`` draws clip-space triangles into an h×w
image with the TPU kernel's conventions: screen x = (cx/cw·0.5+0.5)·(w−1),
screen y = (0.5−cy/cw·0.5)·(h−1), pixels sampled at integer coordinates,
depth z = cz/cw·0.5+0.5 interpolated and clamped to [0, 1], coverage = all
three edge weights ≥ 0 (either winding), nearest fp32 depth wins and a
depth tie goes to the lowest face id. Cameras on the paint path are
orthographic, so the barycentrics are the screen-space edge weights.

For a CUDA tensor the whole function is the CUDA kernel ``csrc/rasterize.cu``
(:func:`rasterize_cuda`; it launches or raises): the per-face setup (screen
transform, area, edge-function records, bbox, culling of faces with
|area| < 1e-12 or entirely off screen) in the TPU kernel's fp32 operation
order, the binning to screen tiles and the per-tile z-buffer. For a CPU
tensor it is the plain twin: :func:`face_setup` (the same records in
PyTorch) and :func:`rasterize_plain`, which runs the records over every
(face, bbox pixel) pair, in chunks of faces, and reduces with the same
int64 token (float bits of z above the face id) by ``amin``.

Nothing has a capacity that can be exceeded (a tile's full list spills to a
list that every tile sweeps), so ``overflow`` stays in :class:`RasterOut`
for parity with the JAX API and is always 0.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

# (face, pixel) pairs evaluated at once by the plain twin
_PLAIN_CHUNK = 1 << 22
_EMPTY = torch.iinfo(torch.int64).max


class RasterOut(NamedTuple):
    face_id: torch.Tensor   # [h, w] int32, -1 where empty
    bary: torch.Tensor      # [h, w, 3] float32 (w0, w1, 1 - w0 - w1), 0 where empty
    depth: torch.Tensor     # [h, w] float32, 0 where empty
    overflow: torch.Tensor  # [2] int32, always 0 (no capacities to exceed)


def face_setup(verts: torch.Tensor, faces: torch.Tensor, h: int, w: int):
    """Per-face records in the TPU kernel's fp32 order (rasterize_tpu.py
    :178-215) → (recs [F, 9] = a0 b0 c0 a1 b1 c1 z0 z1 zc, bbox [F, 4]
    int32 = x0 x1 y0 y1 clipped to the image, with x0 > x1 for a culled
    face)."""
    nf = faces.shape[0]
    tri = verts[faces.reshape(-1).long()].reshape(nf, 3, 4)
    vw = torch.where(tri[:, :, 3] == 0.0, 1e-8, tri[:, :, 3])
    sx = (tri[:, :, 0] / vw * 0.5 + 0.5) * (w - 1)
    sy = (0.5 - tri[:, :, 1] / vw * 0.5) * (h - 1)
    sz = tri[:, :, 2] / vw * 0.5 + 0.5
    area = ((sx[:, 1] - sx[:, 0]) * (sy[:, 2] - sy[:, 0])
            - (sx[:, 2] - sx[:, 0]) * (sy[:, 1] - sy[:, 0]))
    valid = area.abs() >= 1e-12
    inv_area = torch.where(valid, 1.0 / torch.where(valid, area, 1.0), 0.0)
    recs = torch.stack([
        (sy[:, 1] - sy[:, 2]) * inv_area,
        (sx[:, 2] - sx[:, 1]) * inv_area,
        (sx[:, 1] * sy[:, 2] - sx[:, 2] * sy[:, 1]) * inv_area,
        (sy[:, 2] - sy[:, 0]) * inv_area,
        (sx[:, 0] - sx[:, 2]) * inv_area,
        (sx[:, 2] * sy[:, 0] - sx[:, 0] * sy[:, 2]) * inv_area,
        sz[:, 0] - sz[:, 2], sz[:, 1] - sz[:, 2], sz[:, 2]], dim=1).contiguous()
    smin, smax = sx.amin(1), sx.amax(1)
    tmin, tmax = sy.amin(1), sy.amax(1)
    offscreen = (smax < 0) | (smin > w - 1) | (tmax < 0) | (tmin > h - 1)
    valid = valid & ~offscreen
    x0 = smin.floor().clamp(0, w - 1)
    x1 = smax.ceil().clamp(0, w - 1)
    y0 = tmin.floor().clamp(0, h - 1)
    y1 = tmax.ceil().clamp(0, h - 1)
    bbox = torch.stack([x0, x1, y0, y1], dim=1).nan_to_num(0.0).to(torch.int32)
    bbox[:, 1] = torch.where(valid, bbox[:, 1], -1)
    bbox[:, 0] = torch.where(valid, bbox[:, 0], 0)
    return recs, bbox.contiguous()


def _edges(r: torch.Tensor, px: torch.Tensor, py: torch.Tensor):
    """w0, w1 in the kernel's order: (c + a·px) + b·py, each op rounded."""
    w0 = (r[:, 2] + r[:, 0] * px) + r[:, 1] * py
    w1 = (r[:, 5] + r[:, 3] * px) + r[:, 4] * py
    return w0, w1


def _resolve(recs: torch.Tensor, zbuf: torch.Tensor, h: int, w: int) -> RasterOut:
    """Decode the token z-buffer into face_id / bary / depth (the kernel's
    pass 2 in plain PyTorch)."""
    dev = zbuf.device
    hit = zbuf != _EMPTY
    fid = torch.where(hit, zbuf & 0xFFFFFFFF, -1).to(torch.int32)
    depth = torch.where(hit, (zbuf >> 32).to(torch.int32).view(torch.float32), 0.0)
    p = torch.arange(h * w, device=dev)
    r = recs[fid.clamp_min(0).long()] if recs.shape[0] else torch.zeros(h * w, 9, device=dev)
    w0, w1 = _edges(r, (p % w).float(), (p // w).float())
    bary = torch.stack([w0, w1, (1.0 - w0) - w1], dim=-1)
    bary = torch.where(hit[:, None], bary, 0.0)
    return RasterOut(fid.reshape(h, w), bary.reshape(h, w, 3), depth.reshape(h, w),
                     torch.zeros(2, dtype=torch.int32, device=dev))


def rasterize_plain(recs: torch.Tensor, bbox: torch.Tensor, h: int, w: int) -> RasterOut:
    """The kernel's function in plain PyTorch, from :func:`face_setup`'s
    records: every (face, bbox pixel) pair, a chunk of faces at a time,
    reduced into an int64 token z-buffer with ``scatter_reduce('amin')``."""
    dev = recs.device
    zbuf = torch.full((h * w,), _EMPTY, dtype=torch.int64, device=dev)
    nx = (bbox[:, 1] - bbox[:, 0] + 1).clamp_min(0).long()
    ny = (bbox[:, 3] - bbox[:, 2] + 1).clamp_min(0).long()
    counts = nx * ny
    ends = counts.cumsum(0)
    start_face, done = 0, 0
    nf = recs.shape[0]
    while start_face < nf:
        # faces [start_face, stop) hold at most _PLAIN_CHUNK pairs (or one face)
        stop = int(torch.searchsorted(ends, done + _PLAIN_CHUNK, right=True).item())
        stop = min(max(stop, start_face + 1), nf)
        sel = torch.arange(start_face, stop, device=dev)
        fidx = torch.repeat_interleave(sel, counts[start_face:stop])
        if fidx.numel():
            local = torch.arange(fidx.numel(), device=dev) - (ends[fidx] - counts[fidx] - done)
            x = bbox[fidx, 0].long() + local % nx[fidx]
            y = bbox[fidx, 2].long() + local // nx[fidx]
            r = recs[fidx]
            w0, w1 = _edges(r, x.float(), y.float())
            w2 = (1.0 - w0) - w1
            z = (r[:, 8] + w0 * r[:, 6]) + w1 * r[:, 7]
            z = torch.where(z <= 0.0, 0.0, torch.where(z > 1.0, 1.0, z))  # NaN stays NaN
            cov = (w0 >= 0) & (w1 >= 0) & (w2 >= 0) & (z < 2.0)
            token = (z.view(torch.int32).long() << 32) | fidx
            zbuf.scatter_reduce_(0, (y * w + x)[cov], token[cov], "amin")
        done = int(ends[stop - 1].item())
        start_face = stop
    return _resolve(recs, zbuf, h, w)


_TILE = 32  # the kernel's screen tile edge (csrc/rasterize.cu kTile)


@functools.lru_cache(maxsize=None)
def _lib():
    """The kernel's C entry point, built and loaded at first use."""
    from hunyuan3d2_tpu_torch.utils import cuda_build

    fn = cuda_build.load("rasterize").hy3d_rasterize
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p] + [ctypes.c_int] * 5
                   + [ctypes.c_void_p] * 9)
    fn.restype = ctypes.c_int
    return fn


def _check(verts: torch.Tensor, faces: torch.Tensor, h: int, w: int):
    if verts.dim() != 2 or verts.shape[1] != 4 or verts.dtype != torch.float32:
        raise ValueError(f"rasterize takes float32 [V, 4] clip-space verts, got "
                         f"{verts.dtype} {tuple(verts.shape)}")
    if faces.dim() != 2 or faces.shape[1] != 3 or faces.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"rasterize takes integer [F, 3] faces, got {faces.dtype} "
                         f"{tuple(faces.shape)}")
    if faces.device != verts.device:
        raise ValueError("rasterize: verts and faces lie on different devices")
    if h <= 0 or w <= 0 or faces.shape[0] >= 2 ** 31:
        raise ValueError(f"rasterize: bad size {h}x{w} or face count {faces.shape[0]}")


def rasterize(verts: torch.Tensor, faces: torch.Tensor, h: int, w: int) -> RasterOut:
    """Rasterize ``faces`` [F, 3] of clip-space ``verts`` [V, 4] (float32)
    into an h×w image → :class:`RasterOut`."""
    _check(verts, faces, h, w)
    if not verts.is_cuda:
        return rasterize_plain(*face_setup(verts, faces, h, w), h, w)
    return _rasterize_cuda(verts, faces, h, w)[0]


def _workspace(nf: int, h: int, w: int, device):
    """The kernel's int32 workspace, sized from F and the tile count alone
    (bbox [F, 4] | recs [F, 9] | counts [ntiles + 3] | tile lists [ntiles,
    cap] | wide list [max(F, 1)]), and the tile lists' capacity."""
    ntiles = -(-h // _TILE) * -(-w // _TILE)
    cap = max(256, ((8 * nf + ntiles - 1) // ntiles + 31) // 32 * 32)
    ws = torch.empty(13 * nf + ntiles + 3 + ntiles * cap + max(nf, 1), dtype=torch.int32,
                     device=device)
    return ws, cap


def _launch(verts, faces, h: int, w: int, ws, cap: int, face_id, bary, depth):
    """The C entry on :func:`_workspace`'s buffer (contiguous CUDA inputs)."""
    nf = faces.shape[0]
    c = 13 * nf                                            # the counts' offset
    lists = c + -(-h // _TILE) * -(-w // _TILE) + 3
    wp = ws.data_ptr()
    err = _lib()(verts.data_ptr(), verts.shape[0], faces.data_ptr(),
                 int(faces.dtype == torch.int64), nf, h, w, cap, wp + 16 * nf, wp, wp + 4 * c,
                 wp + 4 * lists, wp + 4 * (lists + (lists - c - 3) * cap), face_id.data_ptr(),
                 bary.data_ptr(), depth.data_ptr(),
                 torch.cuda.current_stream(verts.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rasterize kernel launch failed: cudaError {err}")


def _rasterize_cuda(verts, faces, h: int, w: int):
    """(RasterOut, workspace); each call adds one to ``rasterize.launches``."""
    verts, faces = verts.contiguous(), faces.contiguous()
    dev = verts.device
    ws, cap = _workspace(faces.shape[0], h, w, dev)
    face_id = torch.empty((h, w), dtype=torch.int32, device=dev)
    bary = torch.empty((h, w, 3), dtype=torch.float32, device=dev)
    depth = torch.empty((h, w), dtype=torch.float32, device=dev)
    _launch(verts, faces, h, w, ws, cap, face_id, bary, depth)
    rasterize.launches += 1
    c = 13 * faces.shape[0] + -(-h // _TILE) * -(-w // _TILE)   # the wide count's offset
    return RasterOut(face_id, bary, depth, ws[c + 1:c + 3]), ws


def rasterize_cuda(verts: torch.Tensor, faces: torch.Tensor, h: int, w: int):
    """The CUDA kernel on CUDA tensors → (:class:`RasterOut`, recs [F, 9],
    bbox [F, 4] int32): the records and bbox its face setup computed (those
    of :func:`face_setup`). One memset and two kernels on the current
    stream, no host synchronisation; each call adds one to
    ``rasterize.launches``. A face with a vertex index outside [0, V) is
    culled (where face_setup would fail)."""
    _check(verts, faces, h, w)
    if not verts.is_cuda:
        raise ValueError("rasterize_cuda runs the CUDA kernel: pass CUDA tensors")
    out, ws = _rasterize_cuda(verts, faces, h, w)
    nf = faces.shape[0]
    return out, ws[4 * nf:13 * nf].view(torch.float32).view(nf, 9), ws[:4 * nf].view(nf, 4)


rasterize.launches = 0


def interpolate(out: RasterOut, faces: torch.Tensor, attrs: torch.Tensor) -> torch.Tensor:
    """Barycentric interpolation of per-vertex attrs [V, C] → [h, w, C]
    float32, 0 where empty (a per-corner multiply-add, as in the JAX
    package)."""
    tri = faces.long()[out.face_id.clamp_min(0).long()]        # [h, w, 3]
    attrs = attrs.float()
    img = attrs[tri[..., 0]] * out.bary[..., 0:1]
    img = img + attrs[tri[..., 1]] * out.bary[..., 1:2]
    img = img + attrs[tri[..., 2]] * out.bary[..., 2:3]
    return torch.where((out.face_id >= 0)[..., None], img, 0.0)
