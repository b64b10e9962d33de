"""The plain reference of the ``paint_turbo`` configuration (Hunyuan3D-Paint
v2-0 Turbo: the 2.5D multiview UNet with its dual reference copy, the SD
VAE, the LCM turbo sampler, the cond-map renders and the texture bake), in
plain PyTorch, fp32, TF32 off.

It follows the published Hunyuan3D-2 code (hy3dgen/texgen: pipelines,
hunyuanpaint's unet/modules.py and pipeline.py, the diffusers
UNet2DConditionModel and AutoencoderKL it wraps, differentiable_renderer's
camera_utils and mesh_render) and reads the weights by the checkpoint's
names (``unet.*``, ``unet_dual.*``, ``vae.*``). It imports nothing of the
program: it makes the image transform, the mesh's render frame and normals,
the cameras, the rasters, the voxel masks and the sampler's draws itself
from the request, and reads the program's outputs only to judge them. No
kernel: attention is a softmax over query blocks (the 24,576-token
multiview score matrix does not fit in fp32 whole), a raster is flat
(face × candidate pixel) tensors with a depth test by ``scatter_reduce``
amin.

Departures, each noted where it is made:

* the UV unwrap is not recomputed: it packs charts on the host and has no
  unique answer, so the bake runs on the program's unwrapped mesh (the
  mesh the call returned), whose own faults are checked;
* the bake runs on the program's uint8 views (``views_err`` judges them),
  so that ``texture_err`` judges the bake alone;
* the bake samples each texel's projection into each view (the port's
  texture-space form, ``geometry/render_device.py``), with the published
  bake's arithmetic: weight · cos^exp of the angle to the camera, visibility
  eroded and depth edges dropped, views merged in order and skipped when
  more than 99 % of their texels are painted (back_project +
  fast_bake_texture); the published code splats each view's pixels into
  texture space instead.

``precision="fp8"`` is the control: every matmul, convolution and
attention product takes its operands rounded to float8 e4m3 (one scale a
tensor), the vertex and texel projections included, the step below the
bf16 the configuration serves in.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

# each compared number's limit, set on the card at the cells' sizes
# (benchmark/control.py, 12 seeds over both cells) past the midpoint
# between the largest reading of the program and the smallest of the fp8
# control (PERF.md §2): cond maps 0 / 0.4148, masks 1.99e-7 / 0.0200,
# latents 0.00568 / 0.0617, views 0.0265 / 0.196, texture 0.00159 / 0.249.
# * cond_maps_err: the share of cond-map pixels (of all views) whose normal
#   or position differs by more than one level of 255 (a level is the
#   quantisation's rounding);
# * mask_err: the share of the multiview attention's (query, key) pairs
#   whose voxel-mask allowance differs between the program's attention and
#   the reference's (a grid the program ran unmasked counts all pairs
#   allowed), over the grids the reference masks;
# * latents_err, views_err: ‖program − reference‖ / ‖reference‖ of the
#   denoised latents and of the decoded views before quantisation;
# * texture_err: the same of the textures before the inpaint, the
#   reference baking the program's uint8 views onto its unwrapped mesh; a
#   texel one bake trusts and the other does not counts with its whole
#   colour (an untrusted texel is black), so the trust's disagreement is
#   bounded by the same limit;
# * mesh_faults (no face, a face index out of range, a non-finite vertex, a
#   UV outside [0, 1]) and texture_faults (a non-finite texel before the
#   inpaint, a GLB that does not read back as the returned mesh) need no
#   reference: none.
LIMITS = {"cond_maps_err": 0.25, "mask_err": 0.012, "latents_err": 0.035, "views_err": 0.12,
          "texture_err": 0.13, "mesh_faults": 0, "texture_faults": 0}

CAMERA_DISTANCE = 1.45
ORTHO_HALF = 0.6            # ortho scale 1.2
SCALE_FACTOR = 1.15         # the render frame's bounding-sphere diameter
BAKE_COS = math.cos(math.radians(75.0))
DEPTH_BIAS, EDGE_THRESH = 2e-4, 0.25
UV_SLACK = 1e-4             # a UV this far outside [0, 1] is rounding, not a fault


class Arith:
    """The products' precision: ``fp32`` (the reference) or ``fp8`` (the
    control)."""

    def __init__(self, precision: str):
        if precision not in ("fp32", "fp8"):
            raise ValueError(f"precision must be fp32 or fp8, got {precision!r}")
        self.fp8 = precision == "fp8"

    def operand(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        if not self.fp8:
            return x
        s = x.abs().amax().clamp(min=1e-30) / 448.0
        return (x / s).to(torch.float8_e4m3fn).float() * s

    def linear(self, x, w, b=None):
        y = self.operand(x) @ self.operand(w).reshape(w.shape[0], -1).T
        return y if b is None else y + b.float()

    def conv(self, x, w, b, stride=1, padding=None):
        """NCHW fp32; ``padding`` None is "same" for odd kernels."""
        pad = w.shape[-1] // 2 if padding is None else padding
        return F.conv2d(self.operand(x), self.operand(w), b.float(), stride=stride, padding=pad)

    def attention(self, q, k, v, mask=None, chunk: int = 2048):
        """Softmax attention, [B, H, L, D] fp32, in query blocks; ``mask``
        [B, Lq, Lk] bool (True = attend) is shared across heads."""
        q, k, v = self.operand(q), self.operand(k), self.operand(v)
        scale = q.shape[-1] ** -0.5
        out = []
        for i in range(0, q.shape[2], chunk):
            s = q[:, :, i:i + chunk] @ k.transpose(-1, -2) * scale
            if mask is not None:
                s = s.masked_fill(~mask[:, None, i:i + chunk], float("-inf"))
            out.append(self.operand(torch.softmax(s, dim=-1)) @ v)
        return torch.cat(out, dim=2)


# -- the request's image (texgen's recentring, the multiview net's resize) ----
def reference_image(rgba: np.ndarray, size: int) -> np.ndarray:
    """uint8 RGBA → the reference view, uint8 RGB [size, size, 3]: cropped to
    the alpha bbox, padded by 0.2 of the crop a side onto a transparent
    white square, bicubic to size², alpha composited on white."""
    from PIL import Image

    ys, xs = np.nonzero(rgba[..., 3] > 0)
    crop = rgba[ys.min():ys.max() + 1, xs.min():xs.max() + 1]
    h, w = crop.shape[:2]
    bw, bh = int(w * 0.2), int(h * 0.2)
    side = max(w + 2 * bw, h + 2 * bh)
    canvas = Image.new("RGBA", (side, side), (255, 255, 255, 0))
    canvas.paste(Image.fromarray(crop), ((side - w - 2 * bw) // 2 + bw,
                                         (side - h - 2 * bh) // 2 + bh))
    arr = np.asarray(canvas.resize((size, size), Image.BICUBIC)).astype(np.float32)
    alpha = arr[..., 3:] / 255.0
    return (arr[..., :3] * alpha + 255 * (1 - alpha)).astype(np.uint8)


# -- the render frame and the cameras (mesh_render, camera_utils) ------------
def render_axes(vertices: np.ndarray) -> np.ndarray:
    """(x, y, z) → (−x, z, −y), float32: the renderer's axes."""
    v = np.asarray(vertices, np.float32)
    return np.stack([-v[:, 0], v[:, 2], -v[:, 1]], axis=1)


def render_frame(vertices: np.ndarray) -> np.ndarray:
    """The renderer's axes, centred on the bbox centre and scaled so the
    bounding sphere's diameter is 1.15, float32."""
    v = render_axes(vertices)
    center = (v.max(0) + v.min(0)) / 2
    diameter = np.linalg.norm(v - center, axis=1).max() * 2.0
    return ((v - center) * (SCALE_FACTOR / max(diameter, 1e-12))).astype(np.float32)


def vertex_normals(v: np.ndarray, f: np.ndarray) -> np.ndarray:
    """The mean of the unit face normals around each vertex, unit length."""
    fn = np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]]).astype(np.float64)
    fn /= np.maximum(np.linalg.norm(fn, axis=1, keepdims=True), 1e-12)
    vn = np.zeros((len(v), 3))
    for k in range(3):
        np.add.at(vn, f[:, k], fn)
    return (vn / np.maximum(np.linalg.norm(vn, axis=1, keepdims=True), 1e-12)).astype(np.float32)


def camera(elev: float, azim: float):
    """(world → camera, its orthographic projection) float32 4×4: a look-at
    camera at distance 1.45 around the origin, elevation negated, azimuth
    + 90°, z up."""
    e, a = math.radians(-elev), math.radians(azim + 90.0)
    eye = CAMERA_DISTANCE * np.array([math.cos(e) * math.cos(a), math.cos(e) * math.sin(a),
                                      math.sin(e)])
    fwd = -eye / np.linalg.norm(eye)
    right = np.cross(fwd, [0.0, 0.0, 1.0])
    right /= np.linalg.norm(right)
    up = np.cross(right, fwd)
    up /= np.linalg.norm(up)
    mv = np.eye(4)
    mv[:3, :3] = np.stack([right, up, -fwd])
    mv[:3, 3] = -mv[:3, :3] @ eye
    near, far = 0.1, 100.0
    proj = np.diag([1 / ORTHO_HALF, 1 / ORTHO_HALF, -2 / (far - near), 1.0]).astype(np.float32)
    proj[2, 3] = -(far + near) / (far - near)
    mv = mv.astype(np.float32)
    return mv, proj @ mv


def camera_index(azim: int, elev: int) -> int:
    """The published camera-class index of a view."""
    div = {-20: 1, 0: 1, 20: 1, -90: 3, 90: 3}[elev]
    off = {-20: 0, 0: 12, 20: 24, -90: 36, 90: 40}[elev]
    return (((azim // 30) + 9) % 12) // div + off


# -- the plain rasteriser --------------------------------------------------
def rasterize(clip: torch.Tensor, faces: torch.Tensor, h: int, w: int, chunk: int = 1 << 22):
    """Clip-space vertices [V, 4] and faces [F, 3] → (face id [h, w], -1
    where empty; barycentrics [h, w, 3]; depth [h, w]). Screen x =
    (x/w·0.5+0.5)·(w−1), y = (0.5−y/w·0.5)·(h−1), pixels at integer
    coordinates; a face of screen area under 1e-12 or wholly off the image
    draws nothing; a pixel is covered where its three barycentrics are ≥ 0
    (either winding); depth z/w·0.5+0.5 interpolated and clamped to [0, 1];
    the nearest depth wins, a tie the lowest face id. Every (face, pixel of
    its bbox) pair is a row of flat tensors, a chunk of faces at a time.

    The barycentrics are a face's edge functions normalised by its area,
    w_i = (c_i + a_i·x) + b_i·y, and the depth z₂ + w₀(z₀ − z₂) + w₁(z₁ − z₂),
    each operation rounded in that order: the published raster kernel's
    fp32 arithmetic. Which face covers a pixel on an edge follows from it,
    and the bake's depth normalisation (the visible depth's min and max)
    turns one such pixel into a change of every depth edge."""
    dev = clip.device
    tri = clip[faces]                                                  # [F, 3, 4]
    cw = torch.where(tri[..., 3] == 0.0, 1e-8, tri[..., 3])
    sx = (tri[..., 0] / cw * 0.5 + 0.5) * (w - 1)
    sy = (0.5 - tri[..., 1] / cw * 0.5) * (h - 1)
    sz = tri[..., 2] / cw * 0.5 + 0.5
    area = ((sx[:, 1] - sx[:, 0]) * (sy[:, 2] - sy[:, 0])
            - (sx[:, 2] - sx[:, 0]) * (sy[:, 1] - sy[:, 0]))
    live = ((area.abs() >= 1e-12) & (sx.amax(1) >= 0) & (sx.amin(1) <= w - 1)
            & (sy.amax(1) >= 0) & (sy.amin(1) <= h - 1))
    inv = torch.where(live, 1.0 / torch.where(live, area, 1.0), 0.0)
    edge = torch.stack([(sy[:, 1] - sy[:, 2]) * inv, (sx[:, 2] - sx[:, 1]) * inv,
                        (sx[:, 1] * sy[:, 2] - sx[:, 2] * sy[:, 1]) * inv,
                        (sy[:, 2] - sy[:, 0]) * inv, (sx[:, 0] - sx[:, 2]) * inv,
                        (sx[:, 2] * sy[:, 0] - sx[:, 0] * sy[:, 2]) * inv], 1)
    x0, x1 = sx.amin(1).floor().clamp(0, w - 1), sx.amax(1).ceil().clamp(0, w - 1)
    y0, y1 = sy.amin(1).floor().clamp(0, h - 1), sy.amax(1).ceil().clamp(0, h - 1)
    ids = torch.nonzero(live).flatten()
    nx = (x1 - x0 + 1).long()[ids]
    ny = (y1 - y0 + 1).long()[ids]
    counts = nx * ny
    ends = counts.cumsum(0).cpu().numpy()
    empty = torch.iinfo(torch.int64).max
    zbuf = torch.full((h * w,), empty, dtype=torch.int64, device=dev)

    def bary(f, px, py):
        e = edge[f]
        b0 = (e[:, 2] + e[:, 0] * px) + e[:, 1] * py
        b1 = (e[:, 5] + e[:, 3] * px) + e[:, 4] * py
        return torch.stack([b0, b1, (1.0 - b0) - b1], 1)

    start, done = 0, 0
    while start < len(ids):
        # faces [start, stop) hold at most ``chunk`` pairs (or one face)
        stop = max(int(np.searchsorted(ends, done + chunk, side="right")), start + 1)
        sel = torch.arange(start, stop, device=dev)
        row = torch.repeat_interleave(sel, counts[start:stop])
        local = torch.arange(row.numel(), device=dev) - (
            torch.cat([torch.zeros(1, dtype=torch.long, device=dev), counts[start:stop].cumsum(0)])
            [row - start])
        f = ids[row]
        px = x0[f] + (local % nx[row]).float()
        py = y0[f] + (local // nx[row]).float()
        b = bary(f, px, py)
        z = (sz[f, 2] + b[:, 0] * (sz[f, 0] - sz[f, 2])) + b[:, 1] * (sz[f, 1] - sz[f, 2])
        z = torch.where(z <= 0.0, 0.0, torch.where(z > 1.0, 1.0, z))    # NaN stays NaN
        cov = (b >= 0).all(1) & (z < 2.0)
        token = (z.view(torch.int32).long() << 32) | f
        pix = (py * w + px).long()
        zbuf.scatter_reduce_(0, pix[cov], token[cov], "amin")
        done, start = int(ends[stop - 1]), stop
    hit = zbuf != empty
    fid = torch.where(hit, zbuf & 0xFFFFFFFF, -1)
    depth = torch.where(hit, (zbuf >> 32).to(torch.int32).view(torch.float32), 0.0)
    p = torch.arange(h * w, device=dev)
    b = torch.where(hit[:, None], bary(fid.clamp_min(0), (p % w).float(), (p // w).float()), 0.0)
    return fid.reshape(h, w), b.reshape(h, w, 3), depth.reshape(h, w)


def interpolate(fid, b, faces, attrs):
    """Per-vertex attrs [V, C] at each pixel → [h, w, C], 0 where empty."""
    tri = faces[fid.clamp_min(0)]                                     # [h, w, 3]
    out = sum(attrs[tri[..., k]] * b[..., k:k + 1] for k in range(3))
    return torch.where((fid >= 0)[..., None], out, 0.0)


def to_u8(x):
    return torch.round(x.clamp(0.0, 1.0) * 255.0).to(torch.uint8)


def project(A: Arith, pos: torch.Tensor, mat: torch.Tensor) -> torch.Tensor:
    """Positions [..., 3] → homogeneous [..., 4] times ``mat``ᵀ."""
    ph = torch.cat([pos, torch.ones_like(pos[..., :1])], -1)
    return A.linear(ph.reshape(-1, 4), mat).reshape(pos.shape[:-1] + (4,))


def cond_maps(A: Arith, verts, faces, normals, mvps, res: int):
    """World normals (to [0, 1]) and positions (·0.5 + 0.5) of every view,
    uint8 [N, res, res, 3] each, white where no face covers."""
    out_n, out_p = [], []
    attrs = torch.cat([normals, verts * 0.5 + 0.5], 1)
    for mvp in mvps:
        fid, b, _ = rasterize(project(A, verts, mvp), faces, res, res)
        amap = interpolate(fid, b, faces, attrs)
        hit = (fid >= 0)[..., None]
        n = amap[..., :3] / torch.linalg.norm(amap[..., :3], dim=-1, keepdim=True).clamp_min(1e-12)
        out_n.append(to_u8(torch.where(hit, (n + 1.0) * 0.5, 1.0)))
        out_p.append(to_u8(torch.where(hit, amap[..., 3:6], 1.0)))
    return torch.stack(out_n), torch.stack(out_p)


# -- SD VAE (diffusers AutoencoderKL) ----------------------------------------
def group_norm(x, W, name, groups, eps):
    return F.group_norm(x, groups, W[name + ".weight"].float(), W[name + ".bias"].float(), eps)


def resnet(W, A: Arith, name, x, groups, eps, temb=None):
    h = A.conv(F.silu(group_norm(x, W, name + ".norm1", groups, eps)), W[name + ".conv1.weight"],
               W[name + ".conv1.bias"])
    if temb is not None:
        h = h + A.linear(F.silu(temb), W[name + ".time_emb_proj.weight"],
                         W[name + ".time_emb_proj.bias"])[:, :, None, None]
    h = A.conv(F.silu(group_norm(h, W, name + ".norm2", groups, eps)), W[name + ".conv2.weight"],
               W[name + ".conv2.bias"])
    if name + ".conv_shortcut.weight" in W:
        x = A.conv(x, W[name + ".conv_shortcut.weight"], W[name + ".conv_shortcut.bias"])
    return x + h


def vae_mid(W, A: Arith, name, x, groups):
    x = resnet(W, A, name + ".resnets.0", x, groups, 1e-6)
    b, c, hh, ww = x.shape
    a = name + ".attentions.0"
    y = group_norm(x, W, a + ".group_norm", groups, 1e-6).flatten(2).transpose(1, 2)
    q, k, v = (A.linear(y, W[f"{a}.{n}.weight"], W[f"{a}.{n}.bias"])[:, None]
               for n in ("to_q", "to_k", "to_v"))
    o = A.attention(q, k, v)[:, 0]
    o = A.linear(o, W[a + ".to_out.0.weight"], W[a + ".to_out.0.bias"])
    x = x + o.transpose(1, 2).reshape(b, c, hh, ww)
    return resnet(W, A, name + ".resnets.1", x, groups, 1e-6)


def vae_encode(W, A: Arith, cfg: dict, images_u8: torch.Tensor) -> torch.Tensor:
    """uint8 [B, H, W, 3] → scaled latents [B, h, w, 4]: the posterior's mean."""
    g, e = cfg["norm_num_groups"], "vae.encoder"
    x = (images_u8.float() / 255.0 * 2.0 - 1.0).permute(0, 3, 1, 2)
    x = A.conv(x, W[e + ".conv_in.weight"], W[e + ".conv_in.bias"])
    n = len(cfg["block_out_channels"])
    for i in range(n):
        for j in range(cfg["layers_per_block"]):
            x = resnet(W, A, f"{e}.down_blocks.{i}.resnets.{j}", x, g, 1e-6)
        if i < n - 1:   # pad right and bottom by one, then a stride-2 valid conv
            c = f"{e}.down_blocks.{i}.downsamplers.0.conv"
            x = A.conv(F.pad(x, (0, 1, 0, 1)), W[c + ".weight"], W[c + ".bias"], 2, 0)
    x = vae_mid(W, A, e + ".mid_block", x, g)
    x = A.conv(F.silu(group_norm(x, W, e + ".conv_norm_out", g, 1e-6)), W[e + ".conv_out.weight"],
               W[e + ".conv_out.bias"])
    x = A.conv(x, W["vae.quant_conv.weight"], W["vae.quant_conv.bias"])
    lc = cfg["latent_channels"]
    return (x[:, :lc] * cfg["scaling_factor"]).permute(0, 2, 3, 1)


def vae_decode(W, A: Arith, cfg: dict, z: torch.Tensor) -> torch.Tensor:
    """Scaled latents [B, h, w, 4] → images [B, H, W, 3] in [-1, 1]."""
    g, d = cfg["norm_num_groups"], "vae.decoder"
    x = z.float().permute(0, 3, 1, 2) / cfg["scaling_factor"]
    x = A.conv(x, W["vae.post_quant_conv.weight"], W["vae.post_quant_conv.bias"])
    x = A.conv(x, W[d + ".conv_in.weight"], W[d + ".conv_in.bias"])
    x = vae_mid(W, A, d + ".mid_block", x, g)
    n = len(cfg["block_out_channels"])
    for i in range(n):
        for j in range(cfg["layers_per_block"] + 1):
            x = resnet(W, A, f"{d}.up_blocks.{i}.resnets.{j}", x, g, 1e-6)
        if i < n - 1:
            c = f"{d}.up_blocks.{i}.upsamplers.0.conv"
            x = A.conv(F.interpolate(x, scale_factor=2, mode="nearest"), W[c + ".weight"],
                       W[c + ".bias"])
    x = A.conv(F.silu(group_norm(x, W, d + ".conv_norm_out", g, 1e-6)), W[d + ".conv_out.weight"],
               W[d + ".conv_out.bias"])
    return x.permute(0, 2, 3, 1)


# -- the 2.5D UNet (hunyuanpaint unet/modules.py over UNet2DConditionModel) --
def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """diffusers Timesteps(flip_sin_to_cos=True, shift 0): [cos | sin]."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32,
                                                        device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], -1)


def layer_norm(x, W, name, eps=1e-5):
    return F.layer_norm(x, x.shape[-1:], W[name + ".weight"].float(), W[name + ".bias"].float(),
                        eps)


def attend(W, A: Arith, name, x, kv, heads, mask=None):
    """diffusers Attention: to_q / to_k / to_v (no bias), softmax, to_out.0."""
    def split(y):
        b, l, c = y.shape
        return y.reshape(b, l, heads, c // heads).transpose(1, 2)

    q = split(A.linear(x, W[name + ".to_q.weight"]))
    k = split(A.linear(kv, W[name + ".to_k.weight"]))
    v = split(A.linear(kv, W[name + ".to_v.weight"]))
    o = A.attention(q, k, v, mask)
    b, h, l, d = o.shape
    o = o.transpose(1, 2).reshape(b, l, h * d)
    return A.linear(o, W[name + ".to_out.0.weight"], W[name + ".to_out.0.bias"])


def transformer(W, A: Arith, cfg, name, x, ctx, layer, mode, views, cache, masks):
    """Transformer2DModel with one block; in the main UNet the block is the
    2.5D wrapper: after self-attention, the reference attention (K/V the
    reference pass's norm1 states of this layer, 'r') and the multiview
    attention over all views' tokens (voxel-masked where a mask of that
    length exists, 'r'). In 'w' the block's norm1 states go to ``cache``."""
    b, c, hh, ww = x.shape
    heads = cfg["num_heads"] or c // cfg["attention_head_dim"]
    y = group_norm(x, W, name + ".norm", cfg["norm_num_groups"], 1e-6)
    y = A.linear(y.flatten(2).transpose(1, 2), W[name + ".proj_in.weight"],
                 W[name + ".proj_in.bias"])
    blk = name + ".transformer_blocks.0"
    base = blk + ".transformer" if blk + ".transformer.norm1.weight" in W else blk
    h = layer_norm(y, W, base + ".norm1")
    y = y + attend(W, A, base + ".attn1", h, h, heads)
    l = hh * ww
    if mode == "w":
        cache[layer] = h.reshape(b // views, views * l, c)
    if mode == "r" and cfg["use_reference_attention"]:
        ref = cache[layer].repeat_interleave(b // cache[layer].shape[0], dim=0)
        y = y + attend(W, A, blk + ".attn_refview", h, ref, heads)
    if mode == "r" and cfg["use_multiview_attention"] and views > 1:
        mv = h.reshape(b // views, views * l, c)
        out = attend(W, A, blk + ".attn_multiview", mv, mv, heads, masks.get(views * l))
        y = y + out.reshape(b, l, c)
    y = y + attend(W, A, base + ".attn2", layer_norm(y, W, base + ".norm2"), ctx, heads)
    a, gate = A.linear(layer_norm(y, W, base + ".norm3"), W[base + ".ff.net.0.proj.weight"],
                       W[base + ".ff.net.0.proj.bias"]).chunk(2, dim=-1)
    y = y + A.linear(a * F.gelu(gate), W[base + ".ff.net.2.weight"], W[base + ".ff.net.2.bias"])
    y = A.linear(y, W[name + ".proj_out.weight"], W[name + ".proj_out.bias"])
    return x + y.transpose(1, 2).reshape(b, c, hh, ww)


def is_cross(cfg: dict, i: int, down: bool) -> bool:
    n = len(cfg["block_out_channels"])
    if cfg.get("down_cross") is not None:
        return cfg["down_cross"][i if down else n - 1 - i]
    return (i < n - 1) if down else (i > 0)


def unet(W, A: Arith, cfg: dict, p: str, x, t, ctx, labels, mode, views, cache, masks=None):
    """UNet2DConditionModel ``p`` ("unet" or "unet_dual") over NCHW ``x``
    [B·views, C, h, w] at timesteps ``t`` [B·views], text ``ctx`` [B·views,
    77, D] → the prediction (NCHW)."""
    g, masks = cfg["norm_num_groups"], masks or {}
    temb = timestep_embedding(t, cfg["block_out_channels"][0])
    te = p + ".time_embedding"
    temb = A.linear(F.silu(A.linear(temb, W[te + ".linear_1.weight"], W[te + ".linear_1.bias"])),
                    W[te + ".linear_2.weight"], W[te + ".linear_2.bias"])
    if labels is not None:
        temb = temb + W[p + ".class_embedding.weight"].float()[labels]

    def attn(name, x, layer):
        return transformer(W, A, cfg, name, x, ctx, layer, mode, views, cache, masks)

    x = A.conv(x, W[p + ".conv_in.weight"], W[p + ".conv_in.bias"])
    skips = [x]
    n = len(cfg["block_out_channels"])
    for i in range(n):
        for j in range(cfg["layers_per_block"]):
            x = resnet(W, A, f"{p}.down_blocks.{i}.resnets.{j}", x, g, 1e-5, temb)
            if is_cross(cfg, i, True):
                x = attn(f"{p}.down_blocks.{i}.attentions.{j}", x, f"down_{i}_{j}")
            skips.append(x)
        if i < n - 1:
            c = f"{p}.down_blocks.{i}.downsamplers.0.conv"
            x = A.conv(x, W[c + ".weight"], W[c + ".bias"], 2, 1)
            skips.append(x)
    x = resnet(W, A, f"{p}.mid_block.resnets.0", x, g, 1e-5, temb)
    x = attn(f"{p}.mid_block.attentions.0", x, "mid_0")
    x = resnet(W, A, f"{p}.mid_block.resnets.1", x, g, 1e-5, temb)
    for i in range(n):
        for j in range(cfg["layers_per_block"] + 1):
            x = resnet(W, A, f"{p}.up_blocks.{i}.resnets.{j}", torch.cat([x, skips.pop()], 1), g,
                       1e-5, temb)
            if is_cross(cfg, i, False):
                x = attn(f"{p}.up_blocks.{i}.attentions.{j}", x, f"up_{i}_{j}")
        if i < n - 1:
            c = f"{p}.up_blocks.{i}.upsamplers.0.conv"
            x = A.conv(F.interpolate(x, scale_factor=2, mode="nearest"), W[c + ".weight"],
                       W[c + ".bias"])
    x = F.silu(group_norm(x, W, p + ".conv_norm_out", g, 1e-5))
    return A.conv(x, W[p + ".conv_out.weight"], W[p + ".conv_out.bias"])


def voxel_masks(position_u8: torch.Tensor, view: int) -> dict:
    """{multiview token count N·g²: [1, N·g², N·g²] bool} at the grids g of
    32, 16 and 8 that divide the view: each grid cell's mean 3D position
    over its object pixels (a cell of fewer than 5 is put at the origin),
    and a pair may attend when its cells lie within 1.73 / g."""
    pos = position_u8.float() / 255.0                                   # [N, H, W, 3]
    n = pos.shape[0]
    valid = (pos != 1.0).all(-1, keepdim=True).float()
    out = {}
    for g in (32, 16, 8):
        if view % g:
            continue
        cell = view // g
        s = (pos * valid).reshape(n, g, cell, g, cell, 3).sum((2, 4))
        cnt = valid.reshape(n, g, cell, g, cell, 1).sum((2, 4))
        mean = torch.where(cnt < 5, 0.0, s / cnt.clamp_min(1.0)).reshape(1, n * g * g, 3)
        d2 = (mean[:, :, None] - mean[:, None]).square().sum(-1)
        out[n * g * g] = d2 < (1.73 / g) ** 2
    return out


def lcm_tables(steps: int):
    """The turbo schedule: DDIM's 30-entry table (i + 1)·33 − 1 indexed by
    round(linspace(29, 2, steps)), and ᾱ of the scaled-linear betas
    (0.00085 to 0.012 over 1000 steps), fp32."""
    table = np.arange(1, 31) * (1000 // 30) - 1
    timesteps = table[np.round(np.linspace(29, 2, steps)).astype(int)]
    betas = np.linspace(0.00085 ** 0.5, 0.012 ** 0.5, 1000) ** 2
    return [int(t) for t in timesteps], np.cumprod(1.0 - betas).astype(np.float32)


# -- the bake -----------------------------------------------------------------
def max_filter(x: torch.Tensor, k: int) -> torch.Tensor:
    return F.max_pool2d(x[None, None], k, stride=1, padding=k // 2)[0, 0]


def bake(A: Arith, verts, faces, uv, views_u8, cams, weights, *, render: int, tex: int,
         exp: float):
    """The views' colours into the UV texture → (texture [tex, tex, 3] in
    [0, 1], trust [tex, tex]). Each texel of the UV raster (its 3D position
    and unit normal interpolated) is projected into each view; it takes the
    view's colour (a bilinear upsample to 4× the view, at most the render
    size, sampled at the nearest pixel)
    with weight · cos^exp of the angle between its normal and the camera's
    axis (0 below cos 75°) where it lies in the view, passes the depth test
    against the view's 3×3-dilated depth raster and the view is reliable
    there: covered after an erosion by 2·int(render·2/512)+1 and off that
    dilation of the Sobel edges (> 0.25) of its normalised depth. Views merge
    in order; a view whose candidate texels are > 99 % painted already is
    skipped."""
    dev = verts.device
    up = min(render, 4 * views_u8.shape[1])
    normals = torch.from_numpy(vertex_normals(verts.cpu().numpy(),
                                              faces.cpu().numpy())).to(dev)
    uv_clip = torch.stack([uv[:, 0] * 2 - 1, -(uv[:, 1] * 2 - 1), torch.zeros_like(uv[:, 0]),
                           torch.ones_like(uv[:, 0])], 1)
    fid, b, _ = rasterize(uv_clip, faces, tex, tex)
    attr = interpolate(fid, b, faces, torch.cat([verts, normals], 1))
    tpos = attr[..., :3]
    tnrm = attr[..., 3:] / torch.linalg.norm(attr[..., 3:], dim=-1, keepdim=True).clamp_min(1e-12)
    tvalid = fid >= 0
    k = 2 * int(2 / 512 * render) + 1
    acc = torch.zeros(tex, tex, 3, device=dev)
    trust = torch.zeros(tex, tex, device=dev)
    sobel = torch.tensor([[-1.0, 0.0, 1.0], [-2.0, 0.0, 2.0], [-1.0, 0.0, 1.0]], device=dev)
    for view, (mv, mvp), weight in zip(views_u8, cams, weights):
        vfid, _, d = rasterize(project(A, verts, mvp), faces, render, render)
        vis = (vfid >= 0).float()
        dmin = torch.where(vis > 0, d, torch.inf).min()
        dmax = torch.where(vis > 0, d, -torch.inf).max()
        dn = (d - dmin) / (dmax - dmin).clamp_min(1e-12) * vis
        dp = F.pad(dn[None, None], (1, 1, 1, 1), mode="replicate")
        gx = F.conv2d(dp, sobel[None, None])[0, 0]
        gy = F.conv2d(dp, sobel.T[None, None])[0, 0]
        edges = (torch.sqrt(gx * gx + gy * gy) > EDGE_THRESH).float()
        reliable = (max_filter(1.0 - vis, k) <= 0) & (max_filter(edges, k) < 0.5)
        pc = project(A, tpos, mvp)
        pw = torch.where(pc[..., 3] == 0, 1e-8, pc[..., 3])
        sx = (pc[..., 0] / pw * 0.5 + 0.5) * (render - 1)
        sy = (0.5 - pc[..., 1] / pw * 0.5) * (render - 1)
        tz = (pc[..., 2] / pw * 0.5 + 0.5).clamp(0.0, 1.0)
        inside = (sx >= 0) & (sx <= render - 1) & (sy >= 0) & (sy <= render - 1)
        row = torch.round(sy).clamp(0, render - 1).long()
        col = torch.round(sx).clamp(0, render - 1).long()
        zmax = max_filter(torch.where(vis > 0, d, 0.0), 3)
        seen = tz <= zmax[row, col] + DEPTH_BIAS
        cos = -A.linear(tnrm.reshape(-1, 3), mv[2:3, :3]).reshape(tex, tex)
        cos = torch.where(cos < BAKE_COS, 0.0, cos)
        ok = tvalid & inside & seen & reliable[row, col]
        wt = torch.where(ok, weight * cos.pow(exp), 0.0)
        cand = (cos > 0) & ok
        color = F.interpolate(view.float().permute(2, 0, 1)[None], size=(up, up),
                              mode="bilinear", align_corners=False)[0].permute(1, 2, 0) / 255.0
        urow = torch.round((sy + 0.5) * (up / render) - 0.5).clamp(0, up - 1).long()
        ucol = torch.round((sx + 0.5) * (up / render) - 0.5).clamp(0, up - 1).long()
        painted = ((trust > 0) & cand).sum()
        if painted / cand.sum().clamp_min(1) > 0.99:
            continue
        acc += wt[..., None] * color[urow, ucol]
        trust += wt
    return acc / trust.clamp_min(1e-8)[..., None], trust


@torch.no_grad()
def run(config: dict, W: dict, request: dict, kept: dict, precision: str = "fp32"):
    """The reference's outputs for one request: the cond maps, the voxel
    masks its multiview attention used, the denoised latents, the decoded
    views (before quantisation) and the bake of the
    program's uint8 views (``kept["views_u8"]``) onto the program's
    unwrapped mesh (``kept["output"]``) with its trust."""
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        return _run(config, W, request, kept, Arith(precision))
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


def reference_cache(W, A: Arith, ucfg: dict, ref_lat: torch.Tensor) -> dict:
    """The reference pass ('w') of the dual copy over the reference latents
    [1, h, w, 4], at t = 0, with the main UNet's learned reference text →
    {layer: norm1 states [1, L, C]}."""
    cache = {}
    if not ucfg["use_reference_attention"]:
        return cache
    if not ucfg["use_dual_stream"]:
        raise ValueError("this reference writes the cache with the dual copy only")
    dual = dict(ucfg, in_channels=4, use_multiview_attention=False,
                use_reference_attention=False, use_camera_embedding=False)
    ctx = W["unet.learned_text_clip_ref"].float().expand(ref_lat.shape[0], -1, -1)
    unet(W, A, dual, "unet_dual", ref_lat.permute(0, 3, 1, 2),
         torch.zeros(ref_lat.shape[0], device=ref_lat.device), ctx, None, "w", 1, cache)
    return cache


def sample(W, A: Arith, config: dict, cache: dict, masks: dict, normal_lat, position_lat,
           seed: int) -> torch.Tensor:
    """The LCM turbo loop → denoised latents [1, N, h, w, 4]: x_T drawn with
    ``torch.randn`` from a generator seeded with ``seed`` on the device (the
    request's ``init_latents``), each step's noise from one seeded with 0 (the
    published pipeline seeds its sampler with 0 on every call); the UNet's
    v-prediction gives x₀ = √ᾱ_t·x − √(1−ᾱ_t)·v, re-noised to the next
    timestep, x₀ itself after the last."""
    ucfg, vw = config["unet"], config["views"]
    dev, n = normal_lat.device, normal_lat.shape[0]
    labels = torch.tensor([camera_index(a, e) + 5 for a, e in zip(vw["azims"], vw["elevs"])],
                          device=dev) if ucfg["use_camera_embedding"] else None
    ctx = W["unet.learned_text_clip_gen"].float().expand(n, -1, -1)
    timesteps, ac = lcm_tables(min(config["sampler"]["steps"], 10))
    ac = torch.from_numpy(ac).to(dev)
    shape = (1,) + tuple(normal_lat.shape[:3]) + (4,)
    lat = torch.randn(shape, generator=torch.Generator(device=dev).manual_seed(seed), device=dev)
    noise_gen = torch.Generator(device=dev).manual_seed(0)
    cond = torch.cat([normal_lat, position_lat], -1)
    for i, t in enumerate(timesteps):
        x = torch.cat([lat[0], cond], -1).permute(0, 3, 1, 2)
        v = unet(W, A, ucfg, "unet", x, torch.full((n,), float(t), device=dev), ctx, labels, "r",
                 n, cache, masks).permute(0, 2, 3, 1)[None]
        noise = torch.randn(shape, generator=noise_gen, device=dev)
        x0 = ac[t] ** 0.5 * lat - (1 - ac[t]) ** 0.5 * v
        if i + 1 == len(timesteps):
            return x0
        nxt = ac[timesteps[i + 1]]
        lat = nxt ** 0.5 * x0 + (1 - nxt) ** 0.5 * noise
    return lat


def cameras(views: dict, dev) -> list:
    """[(world → camera, its projection)] of the configuration's views."""
    return [tuple(torch.from_numpy(m).to(dev) for m in camera(e, a))
            for e, a in zip(views["elevs"], views["azims"])]


def _run(config, W, request, kept, A: Arith):
    dev = next(iter(W.values())).device
    vcfg, vw = config["vae"], config["views"]
    cams = cameras(vw, dev)
    vertices, faces_np = request["mesh"]
    verts = torch.from_numpy(render_frame(vertices)).to(dev)
    faces = torch.from_numpy(np.asarray(faces_np, np.int64)).to(dev)
    normals = torch.from_numpy(vertex_normals(verts.cpu().numpy(), faces_np)).to(dev)
    normal_u8, position_u8 = cond_maps(A, verts, faces, normals, [m for _, m in cams], vw["size"])

    ref_u8 = torch.from_numpy(reference_image(request["image"], vw["size"])).to(dev)
    cache = reference_cache(W, A, config["unet"], vae_encode(W, A, vcfg, ref_u8[None]))
    normal_lat, position_lat = (vae_encode(W, A, vcfg, m) for m in (normal_u8, position_u8))
    h, levels = normal_lat.shape[1], len(config["unet"]["block_out_channels"])
    masks = {k: m for k, m in voxel_masks(position_u8, vw["size"]).items()
             if k in {len(vw["azims"]) * (h >> i) ** 2 for i in range(levels)}}
    lat = sample(W, A, config, cache, masks, normal_lat, position_lat, request["seed"])
    views = torch.cat([vae_decode(W, A, vcfg, z[None]) for z in lat[0]])

    # the returned mesh lies in the render frame already (the program returns
    # the unwrapped mesh as it baked it, its axes put back): only the axes
    # change, so its vertices are the baked ones to the bit
    mesh = kept["output"]
    bverts = torch.from_numpy(render_axes(mesh.vertices)).to(dev)
    buv = torch.from_numpy(np.asarray(mesh.uv, np.float32) * [1, -1] + [0, 1]).float().to(dev)
    texture, trust = bake(A, bverts, torch.from_numpy(np.asarray(mesh.faces, np.int64)).to(dev),
                          buv, kept["views_u8"].to(dev), cams, vw["weights"],
                          render=config["render_size"], tex=config["texture_size"],
                          exp=float(config["bake_exp"]))
    return {"cond_maps": (normal_u8, position_u8), "masks": masks, "latents": lat,
            "views": views, "texture": texture, "trust": trust}


def rel_err(a: torch.Tensor, ref: torch.Tensor) -> float:
    """‖a − ref‖ / ‖ref‖ over all elements."""
    a, ref = a.float().flatten(), ref.float().flatten().to(a.device)
    return float(torch.linalg.vector_norm(a - ref) / torch.linalg.vector_norm(ref))


def mesh_faults(mesh) -> int:
    """Faults of the returned mesh that need no reference: no mesh, no face,
    a face index out of range, a non-finite vertex, a UV outside [0, 1] (or
    no UVs)."""
    if mesh is None or mesh.uv is None:
        return 1
    v, f, uv = np.asarray(mesh.vertices), np.asarray(mesh.faces), np.asarray(mesh.uv)
    return int((len(f) == 0) + ((f < 0) | (f >= len(v))).sum() + (~np.isfinite(v)).sum()
               + (~np.isfinite(uv)).sum() + ((uv < -UV_SLACK) | (uv > 1 + UV_SLACK)).sum())


def texture_faults(texture: torch.Tensor, mesh, glb) -> int:
    """Faults of the textured result that need no reference: a non-finite
    texel of the bake, and a GLB that does not read back as the returned
    mesh (positions, faces, UVs and texture). ``glb`` reads the program's
    GLB back into arrays (``systems/paint.py`` ``read_glb``)."""
    faults = int((~torch.isfinite(texture)).sum())
    try:
        back = glb()
        same = (np.array_equal(back["vertices"], mesh.vertices)
                and np.array_equal(back["faces"], mesh.faces)
                and np.allclose(back["uv"], mesh.uv, atol=1e-6)
                and np.array_equal(back["texture"], mesh.texture))
    except (ValueError, OSError):          # no GLB, or no image in it
        same = False
    return faults + (not same)


def mask_err(used: dict, masks: dict) -> float:
    """The share of the multiview attention's (query, key) pairs, over the
    grids the reference masks, whose allowance differs between the mask the
    program's attention used at that token count (all pairs, where it ran
    unmasked) and the reference's."""
    differ = total = 0
    for tokens, m in masks.items():
        p = used.get(tokens)
        differ += int((~m).sum()) if p is None else int((p.to(m.device) ^ m).sum())
        total += m.numel()
    return differ / max(total, 1)


def compare(out: dict, ref: dict, request: dict) -> dict:
    """The compared numbers of one request (the faults only where ``out``
    holds the call's return value: the control's outputs hold none)."""
    pn, pp = (m.to(ref["cond_maps"][0].device).int() for m in out["cond_maps"])
    rn, rp = (m.int() for m in ref["cond_maps"])
    differ = ((pn - rn).abs().amax(-1) > 1) | ((pp - rp).abs().amax(-1) > 1)
    # a texel either bake leaves untrusted is black in it: a disagreement of
    # the trust counts as the colour it adds or misses
    tex_p = torch.where(out["trust"].to(ref["trust"].device)[..., None] > 1e-8,
                        out["texture"].to(ref["texture"].device), 0.0)
    tex_r = torch.where(ref["trust"][..., None] > 1e-8, ref["texture"], 0.0)
    numbers = {
        "cond_maps_err": float(differ.float().mean()),
        "mask_err": mask_err(out["masks"], ref["masks"]),
        "latents_err": rel_err(out["latents"], ref["latents"]),
        "views_err": rel_err(out["views"], ref["views"]),
        "texture_err": rel_err(tex_p, tex_r),
    }
    if "output" in out:
        numbers["mesh_faults"] = mesh_faults(out["output"])
        numbers["texture_faults"] = texture_faults(out["texture"], out["output"], out["glb"])
    return numbers
