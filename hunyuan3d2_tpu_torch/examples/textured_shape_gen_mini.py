"""Mini shape + texture generation on the port (the reference's
examples/textured_shape_gen_mini.py: Hunyuan3D-2mini shape → paint →
textured GLB)."""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from hunyuan3d2_tpu_torch.examples import _demo
from hunyuan3d2_tpu_torch.pipelines.shapegen import Hunyuan3DDiTFlowMatchingPipeline
from hunyuan3d2_tpu_torch.pipelines.texgen import Hunyuan3DPaintPipeline


def main(device="cuda", image_path=None):
    if _demo.random_weights():
        shape_pipe = Hunyuan3DDiTFlowMatchingPipeline.init_random(size="tiny", dino="tiny",
                                                                  device=device)
        paint_pipe = Hunyuan3DPaintPipeline.init_random(view_size=64, render_size=256,
                                                        texture_size=256, num_inference_steps=2,
                                                        device=device)
        steps, octree = 3, 64
    else:
        shape_pipe = Hunyuan3DDiTFlowMatchingPipeline.from_pretrained(
            "tencent/Hunyuan3D-2mini", subfolder="hunyuan3d-dit-v2-mini", variant="fp16",
            device=device)
        paint_pipe = Hunyuan3DPaintPipeline.from_pretrained("tencent/Hunyuan3D-2", device=device)
        steps, octree = 50, 380
    image = _demo.image_or_demo(image_path, (220, 120, 60))
    start = time.time()
    mesh = shape_pipe(image=image, num_inference_steps=steps, octree_resolution=octree,
                      num_chunks=20000, seed=12345)[0]
    print("--- %s seconds ---" % (time.time() - start))
    mesh.export("demo_mini.glb")
    textured = paint_pipe(mesh, image)
    textured.export("demo_textured_mini.glb")


if __name__ == "__main__":
    args = _demo.parse_args(__doc__)
    main(args.device, *args.inputs[:1])
