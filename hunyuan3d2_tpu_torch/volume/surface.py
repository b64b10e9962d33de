"""Surface extraction records and registry (the parts of
hunyuan3d2_tpu/volume/surface.py that the FlashVDM path uses).

On this path the mesh is emitted on the device (volume/decoders.py
``surface_nets_from_grid``); the extractor entry only names the algorithm:
``'dmc'`` (and its alias ``'sn'``) is naive surface nets, a dual method like
the reference's DMC. Vertices are in the [-box_v, box_v]³ bbox and faces
point outward (occupancy logits: inside > level).
"""

from __future__ import annotations

from hunyuan3d2_tpu_torch.geometry.mesh import Mesh


class Latent2MeshOutput:
    """Simple (verts, faces) record (reference surface_extractors.py:22)."""

    def __init__(self, mesh_v=None, mesh_f=None):
        self.mesh_v = mesh_v
        self.mesh_f = mesh_f

    def to_mesh(self) -> Mesh:
        return Mesh(self.mesh_v, self.mesh_f)


class SurfaceNetsExtractor:
    """Marks the on-device surface-nets emission of the FlashVDM path."""


SurfaceExtractors = {
    "dmc": SurfaceNetsExtractor,
    "sn": SurfaceNetsExtractor,
}
