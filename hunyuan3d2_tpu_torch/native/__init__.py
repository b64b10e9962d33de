"""ctypes bindings for the native CPU runtime (``hy3dnative.cpp``, a copy of
the JAX package's with the OpenMP scratch fix in ``hy3d_grid_put_linear``).

At first use the source is compiled with ``g++`` into a shared library
under ``build/hunyuan3d2_tpu_torch/`` at the repository root, keyed by a
hash of the source and the flags (the JAX package's Makefile flags, so the
compiler contracts the same multiply-adds and the floats agree); nothing
is built when the module is imported and no library is committed. Bound
here: the host rasterizer (the UV unwrap's chart overlap guard) and the
raster fused with attribute interpolation (the host renders); the host bake
(the bilinear splat of ``back_project``, the fused per-view bake from a
float or a uint8 view); the vertex-graph inpaint and push-pull fill (the
texture inpaint); the surface nets over a dense grid and from compacted
active cells (the 'dmc'/'sn' extractor); the four mesh functions of the
postprocess (face components, quadric simplification, the weld with
degenerate and duplicate face removal, cluster decimation). Each returns
numpy arrays.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import threading

import numpy as np

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "hy3dnative.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(_SRC))), "build",
                          "hunyuan3d2_tpu_torch")
_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17", "-fopenmp")
_LOCK = threading.Lock()


def library_path() -> str:
    with open(_SRC, "rb") as fh:
        digest = hashlib.sha256(fh.read() + " ".join(_FLAGS).encode()).hexdigest()[:16]
    return os.path.join(_BUILD_DIR, f"libhy3dnative-{digest}.so")


@functools.lru_cache(maxsize=None)
def get_lib() -> ctypes.CDLL:
    """The loaded library, compiled first if it is missing."""
    path = library_path()
    with _LOCK:
        if not os.path.exists(path):
            os.makedirs(_BUILD_DIR, exist_ok=True)
            tmp = f"{path}.{os.getpid()}.tmp"
            res = subprocess.run(["g++", *_FLAGS, "-o", tmp, _SRC],
                                 capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(f"building hy3dnative.cpp failed:\n{res.stderr}")
            os.replace(tmp, path)
    lib = ctypes.CDLL(path)
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    lib.hy3d_rasterize.argtypes = [f32p, ctypes.c_int64, i32p, ctypes.c_int64,
                                   ctypes.c_int, ctypes.c_int, i32p, f32p, f32p]
    lib.hy3d_rasterize.restype = None
    lib.hy3d_rasterize_interp.argtypes = [f32p, ctypes.c_int64, i32p, ctypes.c_int64, f32p,
                                          ctypes.c_int, ctypes.c_int, ctypes.c_int, i32p, f32p,
                                          f32p, f32p]
    lib.hy3d_rasterize_interp.restype = None
    lib.hy3d_bake_view.argtypes = [f32p, i32p, f32p, u8p, ctypes.c_float, ctypes.c_int,
                                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                   ctypes.c_float, ctypes.c_float, f32p, f32p]
    lib.hy3d_bake_view.restype = ctypes.c_int
    lib.hy3d_bake_view_u8.argtypes = [f32p, i32p, u8p, ctypes.c_int, ctypes.c_int, u8p,
                                      ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                      ctypes.c_int, ctypes.c_int, ctypes.c_float,
                                      ctypes.c_float, f32p, f32p]
    lib.hy3d_bake_view_u8.restype = ctypes.c_int
    lib.hy3d_vertex_inpaint.argtypes = [
        f32p, u8p, f32p, u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        f32p, ctypes.c_int64, f32p, ctypes.c_int64, i32p, i32p, ctypes.c_int64]
    lib.hy3d_vertex_inpaint.restype = None
    lib.hy3d_grid_put_linear.argtypes = [f32p, f32p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                                         ctypes.c_int, f32p]
    lib.hy3d_grid_put_linear.restype = None
    lib.hy3d_pushpull_fill.argtypes = [f32p, u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.hy3d_pushpull_fill.restype = None
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.hy3d_surface_nets.argtypes = [f32p, ctypes.c_int64, ctypes.c_float, f32p,
                                      ctypes.c_int64, i32p, ctypes.c_int64, i64p, i64p]
    lib.hy3d_surface_nets.restype = ctypes.c_int32
    lib.hy3d_sn_actives.argtypes = [i32p, f32p, ctypes.c_int64, ctypes.c_int64, ctypes.c_float,
                                    f32p, i32p, ctypes.c_int64, i64p]
    lib.hy3d_sn_actives.restype = ctypes.c_int32
    lib.hy3d_face_components.argtypes = [i32p, ctypes.c_int64, ctypes.c_int64, i32p]
    lib.hy3d_face_components.restype = ctypes.c_int32
    mesh_out = [f32p, i64p, i32p, i64p]
    lib.hy3d_simplify.argtypes = [f32p, ctypes.c_int64, i32p, ctypes.c_int64, ctypes.c_int64,
                                  *mesh_out]
    lib.hy3d_simplify.restype = None
    lib.hy3d_weld_dedup.argtypes = [f32p, ctypes.c_int64, i32p, ctypes.c_int64, *mesh_out]
    lib.hy3d_weld_dedup.restype = None
    lib.hy3d_cluster_decimate.argtypes = [f32p, ctypes.c_int64, i32p, ctypes.c_int64,
                                          ctypes.c_double, *mesh_out]
    lib.hy3d_cluster_decimate.restype = None
    return lib


def rasterize(verts_clip: np.ndarray, faces: np.ndarray, height: int, width: int):
    """verts_clip [N, 4] float32 clip space, faces [M, 3] int32 →
    (face_id [H, W] int32 with -1 empty, bary [H, W, 3], depth [H, W])."""
    lib = get_lib()
    verts_clip = np.ascontiguousarray(verts_clip, np.float32)
    faces = _checked_faces(faces, len(verts_clip), "rasterize")
    face_id = np.empty((height, width), np.int32)
    bary = np.empty((height, width, 3), np.float32)
    depth = np.empty((height, width), np.float32)
    lib.hy3d_rasterize(verts_clip, len(verts_clip), faces, len(faces), height, width,
                       face_id, bary, depth)
    return face_id, bary, depth


def _checked_faces(faces: np.ndarray, num_vertices: int, name: str) -> np.ndarray:
    faces = np.ascontiguousarray(faces, np.int32)
    if len(faces) and (faces.min() < 0 or faces.max() >= num_vertices):
        raise ValueError(f"{name}: face index out of range")
    return faces


def _buf(bufs, name: str, shape, dtype) -> np.ndarray:
    """An uninitialised array, reused from the dict ``bufs`` when it holds
    one of that shape and dtype (None: always a new array)."""
    if bufs is None:
        return np.empty(shape, dtype)
    a = bufs.get(name)
    if a is None or a.shape != tuple(shape) or a.dtype != dtype:
        a = bufs[name] = np.empty(shape, dtype)
    return a


def rasterize_interp(verts_clip: np.ndarray, faces: np.ndarray, attrs: np.ndarray,
                     height: int, width: int, bufs=None):
    """Rasterization fused with the interpolation of per-vertex attributes
    attrs [N, C] → (face_id, bary, depth, attr_map [H, W, C], 0 off the
    mesh). ``bufs``: a dict whose buffers the outputs reuse (a caller on a
    loop passes one and consumes the outputs before its next call)."""
    lib = get_lib()
    verts_clip = np.ascontiguousarray(verts_clip, np.float32)
    faces = _checked_faces(faces, len(verts_clip), "rasterize_interp")
    attrs = np.ascontiguousarray(attrs, np.float32)
    if attrs.ndim != 2 or len(attrs) != len(verts_clip):
        raise ValueError(f"rasterize_interp: attrs {attrs.shape} for {len(verts_clip)} vertices")
    c = attrs.shape[1]
    face_id = _buf(bufs, "ri_fid", (height, width), np.int32)
    bary = _buf(bufs, "ri_bary", (height, width, 3), np.float32)
    depth = _buf(bufs, "ri_depth", (height, width), np.float32)
    out = _buf(bufs, "ri_amap", (height, width, c), np.float32)
    lib.hy3d_rasterize_interp(verts_clip, len(verts_clip), faces, len(faces), attrs, c, height,
                              width, face_id, bary, depth, out)
    return face_id, bary, depth, out


def grid_put_linear(coords: np.ndarray, values: np.ndarray, h: int, w: int,
                    out: np.ndarray = None) -> np.ndarray:
    """Bilinear scatter splat of values [n, C] at coords [n, 2] in [0, 1]
    (x → rows, y → cols) → [h, w, C] grid normalised by the splatted
    weight, written into ``out`` when given."""
    lib = get_lib()
    coords = np.ascontiguousarray(coords, np.float32)
    values = np.ascontiguousarray(values, np.float32)
    if coords.shape != (len(values), 2):
        raise ValueError(f"grid_put_linear: coords {coords.shape} for {len(values)} values")
    shape = (h, w, values.shape[1])
    if out is None:
        out = np.empty(shape, np.float32)
    elif out.shape != shape or out.dtype != np.float32 or not out.flags.c_contiguous:
        raise ValueError(f"grid_put_linear: out must be C-contiguous float32 {shape}")
    lib.hy3d_grid_put_linear(coords, values, len(coords), h, w, values.shape[1], out)
    return out


def _bake_args(amap, fid, reliable, tex_merge, trust, c: int, name: str):
    h, w = np.shape(fid)
    th, tw = np.shape(trust)
    if (np.shape(amap) != (h, w, 6) or np.shape(reliable) != (h, w)
            or np.shape(tex_merge) != (th, tw, c)):
        raise ValueError(f"{name}: amap {np.shape(amap)}, reliable {np.shape(reliable)} or "
                         f"tex_merge {np.shape(tex_merge)} disagree with fid {(h, w)}, trust "
                         f"{(th, tw)} and {c} channels")
    for a in (tex_merge, trust):  # accumulated in place
        if a.dtype != np.float32 or not a.flags.c_contiguous:
            raise ValueError(f"{name}: tex_merge and trust must be C-contiguous float32")
    return (np.ascontiguousarray(amap, np.float32), np.ascontiguousarray(fid, np.int32),
            np.ascontiguousarray(reliable, np.uint8), h, w, th, tw)


def bake_view(amap: np.ndarray, fid: np.ndarray, image: np.ndarray, reliable: np.ndarray,
              cos_thres: float, weight: float, exp: float, tex_merge: np.ndarray,
              trust: np.ndarray) -> bool:
    """The fused mask + splat + merge of one view (image [h, w, C] float32,
    at the raster's size) into the running texture: tex_merge [th, tw, C]
    and trust [th, tw] accumulate in place. Returns False when the view was
    skipped (its texels > 99 % painted already)."""
    image = np.ascontiguousarray(image, np.float32)
    amap, fid, reliable, h, w, th, tw = _bake_args(amap, fid, reliable, tex_merge, trust,
                                                   image.shape[-1], "bake_view")
    if image.shape[:2] != (h, w):
        raise ValueError(f"bake_view: image {image.shape} for a {(h, w)} raster")
    return bool(get_lib().hy3d_bake_view(amap, fid, image, reliable, float(cos_thres), h, w,
                                         image.shape[2], th, tw, float(weight), float(exp),
                                         tex_merge, trust))


def bake_view_u8(amap: np.ndarray, fid: np.ndarray, image_u8: np.ndarray, reliable: np.ndarray,
                 cos_thres: float, weight: float, exp: float, tex_merge: np.ndarray,
                 trust: np.ndarray) -> bool:
    """bake_view from the view at its native size [ih, iw, C ≤ 8] uint8,
    sampled bilinearly at each raster pixel (align_corners=False, a PIL
    BILINEAR upsample)."""
    image_u8 = np.ascontiguousarray(image_u8, np.uint8)
    ih, iw, c = image_u8.shape
    if c > 8:
        raise ValueError(f"bake_view_u8: at most 8 channels, got {c}")
    amap, fid, reliable, h, w, th, tw = _bake_args(amap, fid, reliable, tex_merge, trust, c,
                                                   "bake_view_u8")
    return bool(get_lib().hy3d_bake_view_u8(amap, fid, image_u8, ih, iw, reliable,
                                            float(cos_thres), h, w, c, th, tw, float(weight),
                                            float(exp), tex_merge, trust))


def pushpull_fill(texture: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """O(N) pyramid hole fill: texels under mask (255) keep their values,
    the others take valid-weighted coarse averages."""
    lib = get_lib()
    texture = np.array(texture, np.float32, order="C")
    mask = np.ascontiguousarray(mask, np.uint8)
    h, w, c = texture.shape
    if mask.shape != (h, w):
        raise ValueError(f"pushpull_fill: mask {mask.shape} for texture {texture.shape}")
    lib.hy3d_pushpull_fill(texture, mask, h, w, c)
    return texture


def vertex_inpaint(texture: np.ndarray, mask: np.ndarray, vtx_pos: np.ndarray,
                   vtx_uv: np.ndarray, pos_idx: np.ndarray, uv_idx: np.ndarray):
    """Propagate painted vertex colours along the mesh graph into unpainted
    texels → (texture, mask)."""
    lib = get_lib()
    texture = np.ascontiguousarray(texture, np.float32)
    mask = np.ascontiguousarray(mask, np.uint8)
    th, tw, tc = texture.shape
    if mask.shape != (th, tw) or np.shape(pos_idx) != np.shape(uv_idx):
        raise ValueError("vertex_inpaint: mask or index shapes disagree with the texture")
    out_tex = np.empty_like(texture)
    out_mask = np.empty_like(mask)
    lib.hy3d_vertex_inpaint(
        texture, mask, out_tex, out_mask, th, tw, tc,
        np.ascontiguousarray(vtx_pos, np.float32), len(vtx_pos),
        np.ascontiguousarray(vtx_uv, np.float32), len(vtx_uv),
        np.ascontiguousarray(pos_idx, np.int32), np.ascontiguousarray(uv_idx, np.int32),
        len(pos_idx))
    return out_tex, out_mask


def surface_nets(grid: np.ndarray, level: float = 0.0):
    """Dense surface nets over an [R, R, R] float32 grid → (verts [V, 3] in
    lattice coords, faces [F, 3]); OpenMP, deterministic order."""
    lib = get_lib()
    grid = np.ascontiguousarray(grid, np.float32)
    R = grid.shape[0]
    verts_cap = max(1 << 20, int(R * R * 24))
    faces_cap = verts_cap * 4
    out_v = np.empty((verts_cap, 3), np.float32)
    out_f = np.empty((faces_cap, 3), np.int32)
    nv, nf = ctypes.c_int64(), ctypes.c_int64()
    ret = lib.hy3d_surface_nets(grid.reshape(-1), R, level, out_v, verts_cap, out_f, faces_cap,
                                ctypes.byref(nv), ctypes.byref(nf))
    if ret != 0:
        raise MemoryError(f"surface_nets capacity exceeded (code {ret})")
    return out_v[:nv.value].copy(), out_f[:nf.value].copy()


def sn_from_actives(cells: np.ndarray, vals: np.ndarray, nc: int, level: float = 0.0):
    """Surface nets from compacted active cells sorted by flat id: cells
    [K, 3], vals [K, 8] → (verts [K, 3] lattice coords, faces [F, 3])."""
    lib = get_lib()
    cells = np.ascontiguousarray(cells, np.int32)
    vals = np.ascontiguousarray(vals, np.float32)
    k = len(cells)
    out_v = np.empty((k, 3), np.float32)
    faces_cap = 6 * max(k, 1)
    out_f = np.empty((faces_cap, 3), np.int32)
    nf = ctypes.c_int64()
    ret = lib.hy3d_sn_actives(cells.reshape(-1), vals.reshape(-1), k, nc, level,
                              out_v.reshape(-1), out_f.reshape(-1), faces_cap, ctypes.byref(nf))
    if ret != 0:
        raise MemoryError(f"sn_from_actives capacity exceeded (code {ret})")
    return out_v, out_f[:nf.value].copy()


def _mesh_arrays(verts: np.ndarray, faces: np.ndarray, name: str):
    """C-contiguous float32 [N, 3] / int32 [M, 3] copies, indices checked: the
    native passes index vertex arrays by them unchecked."""
    verts = np.ascontiguousarray(verts, np.float32)
    faces = np.ascontiguousarray(faces, np.int32)
    if verts.ndim != 2 or verts.shape[1] != 3 or faces.ndim != 2 or faces.shape[1] != 3:
        raise ValueError(f"{name}: verts {verts.shape} and faces {faces.shape} must be [N, 3]")
    if len(faces) and (faces.min() < 0 or faces.max() >= len(verts)):
        raise ValueError(f"{name}: face index out of range")
    return verts, faces


def _mesh_call(fn, verts: np.ndarray, faces: np.ndarray, *args):
    """Run a native pass that writes at most N vertices and M faces."""
    out_v = np.empty_like(verts)
    out_f = np.empty_like(faces)
    onv, onf = ctypes.c_int64(), ctypes.c_int64()
    fn(verts, len(verts), faces, len(faces), *args, out_v, ctypes.byref(onv), out_f,
       ctypes.byref(onf))
    return out_v[:onv.value].copy(), out_f[:onf.value].copy()


def face_components(faces: np.ndarray, num_vertices: int):
    """Connected components of the face graph (faces sharing a vertex) →
    (labels [M] int32 in first-seen order, count)."""
    lib = get_lib()
    faces = np.ascontiguousarray(faces, np.int32)
    if len(faces) and (faces.min() < 0 or faces.max() >= num_vertices):
        raise ValueError("face_components: face index out of range")
    labels = np.empty(len(faces), np.int32)
    n = lib.hy3d_face_components(faces, len(faces), num_vertices, labels)
    return labels, int(n)


def simplify(verts: np.ndarray, faces: np.ndarray, target_faces: int):
    """Quadric edge-collapse decimation to about ``target_faces`` faces."""
    verts, faces = _mesh_arrays(verts, faces, "simplify")
    return _mesh_call(get_lib().hy3d_simplify, verts, faces, int(target_faces))


def weld_dedup(verts: np.ndarray, faces: np.ndarray):
    """Exact vertex weld (-0.0 equals 0.0) and removal of degenerate,
    zero-area and duplicate faces in one hashing pass; first occurrences
    keep their order."""
    verts, faces = _mesh_arrays(verts, faces, "weld_dedup")
    return _mesh_call(get_lib().hy3d_weld_dedup, verts, faces)


def cluster_decimate(verts: np.ndarray, faces: np.ndarray, cell: float):
    """Uniform vertex clustering at ``cell`` size: each cluster becomes its
    mean, collapsed and duplicate faces go."""
    verts, faces = _mesh_arrays(verts, faces, "cluster_decimate")
    return _mesh_call(get_lib().hy3d_cluster_decimate, verts, faces, float(cell))
