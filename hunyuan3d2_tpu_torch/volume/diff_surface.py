"""Differentiable surface extraction (port of
hunyuan3d2_tpu/volume/diff_surface.py; the reference's diso.DiffDMC slot,
surface_extractors.py:79-96).

DiffDMC's contract: vertex positions are differentiable in the SDF grid,
while the mesh's topology (which cells and edges emit geometry) is
piecewise constant. The device surface nets
(``volume/decoders.surface_nets_device``) have that structure:

  * active-cell selection and face connectivity are integer compaction and
    a binary search: no gradient, as in DiffDMC;
  * corner gather → edge-crossing lerp t = (level − va)/(vb − va) → vertex
    = mean of the crossings: smooth in the grid values, so autograd carries
    a vertex-space loss back to the grid, and through the geo decoder
    (``ShapeVAE.decode_queries``, kernel 1 on the card) into the model's
    parameters.

The corner values are gathered as f16 (``extract_active_cells``), as in the
JAX package, so the gradient into the grid passes through that rounding in
both.
"""

from __future__ import annotations

import torch

from hunyuan3d2_tpu_torch.volume.decoders import extract_active_cells, surface_nets_device


def differentiable_surface_nets(grid: torch.Tensor, level: float = 0.0, box_v: float = 1.01,
                                capacity: int = 65536, face_capacity: int = 98304):
    """SDF grid [R, R, R] (or [1, R, R, R]) → (verts [capacity, 3] f32 in bbox
    coords, tris [2·face_capacity, 3] int32, n_quads, n_verts). Rows at and
    past n_verts (2·n_quads) are padding. The gradient of any function of
    ``verts`` with respect to ``grid`` is exact for the fixed topology."""
    g = grid[0] if grid.dim() == 4 else grid
    cell_flat, vals, count = extract_active_cells(g, level, capacity)
    verts, tris, nq = surface_nets_device(cell_flat, vals, g.shape[0], level, box_v,
                                          face_capacity)
    return verts, tris, nq, count


def vertex_loss_and_grad(grid: torch.Tensor, loss_fn, level: float = 0.0, box_v: float = 1.01,
                         capacity: int = 65536, face_capacity: int = 98304):
    """(value, d value / d grid) of ``loss_fn(verts, n_verts)``, the padding
    rows of ``verts`` zeroed before the loss so they carry no signal."""
    g = grid.detach().requires_grad_(True)
    with torch.enable_grad():
        verts, _, _, count = differentiable_surface_nets(g, level, box_v, capacity,
                                                         face_capacity)
        mask = (torch.arange(verts.shape[0], device=verts.device) < count)[:, None]
        value = loss_fn(verts * mask, count)
        (grad,) = torch.autograd.grad(value, g)
    return value.detach(), grad
