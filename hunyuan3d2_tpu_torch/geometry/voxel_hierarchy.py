"""Sparse voxel hierarchy builder (port of
hunyuan3d2_tpu/geometry/voxel_hierarchy.py: the same numpy, copied so that
the port imports nothing of the JAX package).

Behavioral parity: reference custom_rasterizer grid_neighbor.cpp
(build_hierarchy :311 / build_hierarchy_with_feat :435 — multi-level sparse
voxel grids from layered view position/normal/(feature) maps: voxel key
packing pos2key/key2pos :4-27, per-level downsampling :157, 6-neighborhood
links :192). The symbols are exported by the reference extension but unused
by any Python in the snapshot (legacy/aux API); provided here as vectorized
numpy for API completeness.

Levels: level 0 = input resolution; each next level halves the grid. Each
level stores the occupied voxel keys (sorted), per-voxel averaged position /
normal / optional features, the parent index into the next level, and the
6-neighbor indices (-1 where absent).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np


def pos2key(pos: np.ndarray, resolution: int) -> np.ndarray:
    """Quantize [0,1]³ positions into packed voxel keys (x-major)."""
    ijk = np.clip((pos * resolution).astype(np.int64), 0, resolution - 1)
    return (ijk[..., 0] * resolution + ijk[..., 1]) * resolution + ijk[..., 2]


def key2pos(key: np.ndarray, resolution: int) -> np.ndarray:
    """Voxel center positions of packed keys."""
    z = key % resolution
    y = (key // resolution) % resolution
    x = key // (resolution * resolution)
    return (np.stack([x, y, z], -1).astype(np.float32) + 0.5) / resolution


@dataclass
class VoxelLevel:
    resolution: int
    keys: np.ndarray                     # [M] sorted packed keys
    positions: np.ndarray                # [M, 3] averaged positions
    normals: Optional[np.ndarray] = None # [M, 3]
    features: Optional[np.ndarray] = None
    parent: Optional[np.ndarray] = None  # [M] index into next level
    neighbors: Optional[np.ndarray] = None  # [M, 6] indices, -1 absent


def _average_by_key(keys, values):
    order = np.argsort(keys, kind="stable")
    k = keys[order]
    uniq, start = np.unique(k, return_index=True)
    sums = np.add.reduceat(values[order], start, axis=0)
    counts = np.diff(np.append(start, len(k)))[:, None]
    return uniq, sums / counts


def _neighbors(keys: np.ndarray, resolution: int) -> np.ndarray:
    r2 = resolution * resolution
    offs = np.array([r2, -r2, resolution, -resolution, 1, -1], np.int64)
    out = np.full((len(keys), 6), -1, np.int32)
    for i, off in enumerate(offs):
        cand = keys + off
        pos = np.searchsorted(keys, cand)
        pos = np.minimum(pos, len(keys) - 1)
        ok = keys[pos] == cand
        # reject wrap-around across grid boundaries
        if i in (4, 5):
            ok &= (cand % resolution) - (keys % resolution) == off
        elif i in (2, 3):
            ok &= ((cand // resolution) % resolution) - \
                  ((keys // resolution) % resolution) == off // resolution
        out[:, i] = np.where(ok, pos, -1)
    return out


def build_hierarchy(positions: np.ndarray, normals: Optional[np.ndarray] = None,
                    features: Optional[np.ndarray] = None,
                    resolution: int = 256, num_levels: int = 4,
                    with_neighbors: bool = True) -> List[VoxelLevel]:
    """positions [N,3] in [0,1]³ (+optional per-point normals/features) →
    list of VoxelLevels from fine to coarse with parent links."""
    positions = np.asarray(positions, np.float32)
    levels: List[VoxelLevel] = []
    res = resolution
    pts, nrm, feat = positions, normals, features
    for _ in range(num_levels):
        keys_raw = pos2key(pts, res)
        keys, avg_pos = _average_by_key(keys_raw, pts)
        lvl = VoxelLevel(resolution=res, keys=keys, positions=avg_pos)
        if nrm is not None:
            _, avg_n = _average_by_key(keys_raw, np.asarray(nrm, np.float32))
            lens = np.linalg.norm(avg_n, axis=1, keepdims=True)
            lvl.normals = avg_n / np.maximum(lens, 1e-12)
        if feat is not None:
            _, avg_f = _average_by_key(keys_raw, np.asarray(feat, np.float32))
            lvl.features = avg_f
        if with_neighbors:
            lvl.neighbors = _neighbors(keys, res)
        levels.append(lvl)
        if res <= 2:
            break
        res //= 2

    # parent links: voxel at level ℓ → containing voxel at level ℓ+1
    for lo, hi in zip(levels[:-1], levels[1:]):
        parent_keys = pos2key(lo.positions, hi.resolution)
        pos = np.searchsorted(hi.keys, parent_keys)
        pos = np.minimum(pos, len(hi.keys) - 1)
        lo.parent = np.where(hi.keys[pos] == parent_keys, pos, -1).astype(np.int32)
    return levels


def build_hierarchy_with_feat(positions, normals, features, resolution=256,
                              num_levels=4):
    """Parity alias (grid_neighbor.cpp:435)."""
    return build_hierarchy(positions, normals=normals, features=features,
                           resolution=resolution, num_levels=num_levels)
