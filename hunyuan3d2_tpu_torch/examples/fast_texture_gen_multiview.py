"""Texture an existing mesh with the paint-turbo stack on the port (the
reference's examples/fast_texture_gen_multiview.py: load a GLB, run
HunyuanPaint-turbo)."""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from hunyuan3d2_tpu_torch.examples import _demo
from hunyuan3d2_tpu_torch.geometry.mesh import Mesh
from hunyuan3d2_tpu_torch.pipelines.texgen import Hunyuan3DPaintPipeline


def _sphere_mesh() -> Mesh:
    """A sphere of radius 0.6 from the surface nets of its distance grid."""
    import numpy as np

    from hunyuan3d2_tpu_torch.volume.surface import SurfaceNetsExtractor

    lin = np.linspace(-1.01, 1.01, 32)
    x, y, z = np.meshgrid(lin, lin, lin, indexing="ij")
    grid = (0.6 - np.sqrt(x * x + y * y + z * z))[None].astype(np.float32)
    out = SurfaceNetsExtractor()(grid, mc_level=0.0)[0]
    return Mesh(out.mesh_v, out.mesh_f)


def main(device="cuda", mesh_path=None, image_path=None):
    if _demo.random_weights() or mesh_path is None:
        mesh = _sphere_mesh()
        image = _demo.demo_image((60, 180, 220), size=64)
        pipe = Hunyuan3DPaintPipeline.init_random(view_size=64, render_size=256,
                                                  texture_size=256, num_inference_steps=2,
                                                  device=device)
    else:
        from PIL import Image

        mesh = Mesh.load(mesh_path)
        image = Image.open(image_path)
        pipe = Hunyuan3DPaintPipeline.from_pretrained(
            "tencent/Hunyuan3D-2", subfolder="hunyuan3d-paint-v2-0-turbo", device=device)
    start = time.time()
    textured = pipe(mesh, image)
    print("--- %s seconds ---" % (time.time() - start))
    textured.export("fast_texture_gen.glb")


if __name__ == "__main__":
    args = _demo.parse_args(__doc__)
    main(args.device, *args.inputs[:2])
