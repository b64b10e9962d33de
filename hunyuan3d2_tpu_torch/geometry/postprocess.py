"""Mesh postprocessors (port of hunyuan3d2_tpu/geometry/postprocess.py).

FloaterRemover drops small disconnected components, DegenerateFaceRemover
welds coincident vertices and drops degenerate and duplicate faces,
FaceReducer decimates to a face budget by quadric edge collapse (after a
vertex-cluster pre-pass for large inputs), MeshSimplifier decimates by a
ratio, and mesh_normalize fits the mesh into [-0.99, 0.99]³. All run on the
host, on the native C++ runtime (``native/``) and numpy. Each takes and
returns a :class:`Mesh` (or anything with ``vertices`` / ``faces``), and each
stage's wall time lands in ``LAST_TIMINGS`` under its class name.
"""

from __future__ import annotations

import numpy as np

from hunyuan3d2_tpu_torch import native
from hunyuan3d2_tpu_torch.geometry.mesh import Mesh
from hunyuan3d2_tpu_torch.utils.timer import timed_scope


def _as_mesh(mesh) -> Mesh:
    if isinstance(mesh, Mesh):
        return mesh
    return Mesh(np.asarray(mesh.vertices, np.float32), np.asarray(mesh.faces, np.int32))


class FloaterRemover:
    """Drop connected components with fewer than ``threshold`` × the largest
    component's faces."""

    def __init__(self, threshold: float = 0.005):
        self.threshold = threshold

    @timed_scope("FloaterRemover")
    def __call__(self, mesh, threshold: float = None) -> Mesh:
        mesh = _as_mesh(mesh).copy()
        if len(mesh.faces) == 0:
            return mesh
        labels, n = native.face_components(mesh.faces, len(mesh.vertices))
        if n <= 1:
            return mesh
        counts = np.bincount(labels, minlength=n)
        keep = counts >= max(1, int(counts.max() * (threshold or self.threshold)))
        mesh.faces = mesh.faces[keep[labels]]
        return mesh.remove_unreferenced_vertices()


class DegenerateFaceRemover:
    """Weld exactly coincident vertices, then remove repeated-index,
    zero-area and duplicate faces (one native hashing pass)."""

    @timed_scope("DegenerateFaceRemover")
    def __call__(self, mesh) -> Mesh:
        mesh = _as_mesh(mesh).copy()
        mesh.vertices, mesh.faces = native.weld_dedup(mesh.vertices, mesh.faces)
        return mesh.remove_unreferenced_vertices()


class FaceReducer:
    """Quadric edge-collapse decimation to ``max_facenum`` faces."""

    @timed_scope("FaceReducer")
    def __call__(self, mesh, max_facenum: int = 40000) -> Mesh:
        mesh = _as_mesh(mesh)
        if len(mesh.faces) <= max_facenum:
            return mesh
        v, f = mesh.vertices, mesh.faces
        # Above 8× the budget an O(N) vertex-cluster pass first takes the mesh
        # to about 2× the budget, so the quadric stage spends no time on the
        # trivial early collapses.
        if len(f) > 8 * max_facenum:
            target_pre = 2 * max_facenum
            e1 = v[f[:, 1]] - v[f[:, 0]]
            e2 = v[f[:, 2]] - v[f[:, 0]]
            area = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=1).sum()
            cell = float(np.sqrt(max(area, 1e-12) / max(target_pre / 2, 1)))
            for _ in range(3):
                cv, cf = native.cluster_decimate(v, f, cell)
                if len(cf) <= max_facenum:
                    cell *= 0.7  # overshot: refine
                    continue
                if len(cf) > 2 * target_pre:
                    cell *= float(np.sqrt(len(cf) / target_pre))
                    continue
                v, f = cv, cf
                break
        if len(f) > max_facenum:
            v, f = native.simplify(v, f, max_facenum)
        return Mesh(v, f, metadata=dict(mesh.metadata))


class MeshSimplifier:
    """Quadric decimation to ``ratio`` of the faces. ``executable`` is
    accepted for the reference's signature (its external simplifier binary)
    and unused."""

    def __init__(self, executable: str = None):
        self.executable = executable

    @timed_scope("MeshSimplifier")
    def __call__(self, mesh, ratio: float = 0.1) -> Mesh:
        mesh = _as_mesh(mesh)
        v, f = native.simplify(mesh.vertices, mesh.faces, max(4, int(len(mesh.faces) * ratio)))
        return Mesh(v, f, metadata=dict(mesh.metadata))


def mesh_normalize(mesh) -> Mesh:
    """Scale into the [-0.99, 0.99] cube about the bounding box's centre."""
    mesh = _as_mesh(mesh)
    vmin, vmax = mesh.vertices.min(0), mesh.vertices.max(0)
    center = (vmin + vmax) / 2
    scale = (vmax - vmin).max()
    mesh.vertices = (mesh.vertices - center) / max(scale, 1e-12) * 2.0 * 0.99
    return mesh
