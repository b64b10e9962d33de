"""Camera math (host-side, numpy), copied from hunyuan3d2_tpu/geometry/camera.py.

Behavioral parity: reference hy3dgen/texgen/differentiable_renderer/
camera_utils.py — get_mv_matrix :38 (elev/azim → look-at world-to-camera,
with the elev negation / azim+90 convention and +z up), orthographic :75 and
perspective :101 projections, transform_pos :22 homogeneous transform.
"""

from __future__ import annotations

import math

import numpy as np


def get_mv_matrix(elev: float, azim: float, camera_distance: float,
                  center=None) -> np.ndarray:
    """World→camera matrix for a look-at camera orbiting the center.
    Convention: elev is negated and azim offset by +90° (so azim=0 looks at
    the 'front' of a y-forward asset); up is +z."""
    elev = -elev
    azim = azim + 90.0
    er, ar = math.radians(elev), math.radians(azim)
    eye = np.array([
        camera_distance * math.cos(er) * math.cos(ar),
        camera_distance * math.cos(er) * math.sin(ar),
        camera_distance * math.sin(er),
    ])
    center = np.zeros(3) if center is None else np.asarray(center, np.float64)
    fwd = center - eye
    fwd = fwd / np.linalg.norm(fwd)
    up = np.array([0.0, 0.0, 1.0])
    right = np.cross(fwd, up)
    right = right / np.linalg.norm(right)
    up = np.cross(right, fwd)
    up = up / np.linalg.norm(up)
    rot = np.stack([right, up, -fwd], axis=0)      # camera basis rows
    w2c = np.eye(4)
    w2c[:3, :3] = rot
    w2c[:3, 3] = -rot @ eye
    return w2c.astype(np.float32)


def ortho_projection(left=-1.0, right=1.0, bottom=-1.0, top=1.0,
                     near=0.0, far=2.0) -> np.ndarray:
    m = np.eye(4, dtype=np.float32)
    m[0, 0] = 2.0 / (right - left)
    m[1, 1] = 2.0 / (top - bottom)
    m[2, 2] = -2.0 / (far - near)
    m[0, 3] = -(right + left) / (right - left)
    m[1, 3] = -(top + bottom) / (top - bottom)
    m[2, 3] = -(far + near) / (far - near)
    return m


def perspective_projection(fovy_deg: float, aspect_wh: float, near: float,
                           far: float) -> np.ndarray:
    f = 1.0 / math.tan(math.radians(fovy_deg) / 2.0)
    return np.array([
        [f / aspect_wh, 0, 0, 0],
        [0, f, 0, 0],
        [0, 0, -(far + near) / (far - near), -2.0 * far * near / (far - near)],
        [0, 0, -1, 0],
    ], dtype=np.float32)


def transform_pos(mtx: np.ndarray, pos: np.ndarray) -> np.ndarray:
    """[N,3|4] positions × 4×4 matrix → [N,4] homogeneous."""
    pos = np.asarray(pos, np.float32)
    if pos.shape[-1] == 3:
        pos = np.concatenate([pos, np.ones((len(pos), 1), np.float32)], axis=1)
    return pos @ mtx.T
