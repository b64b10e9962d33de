"""Mini-model shape generation on the port (the reference's
examples/shape_gen_mini.py: Hunyuan3D-2mini, 50 steps, octree 380, chunks
20000, fixed seed)."""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from hunyuan3d2_tpu_torch.examples import _demo
from hunyuan3d2_tpu_torch.pipelines.shapegen import Hunyuan3DDiTFlowMatchingPipeline


def main(device="cuda", image_path=None):
    if _demo.random_weights():
        pipeline = Hunyuan3DDiTFlowMatchingPipeline.init_random(size="tiny", dino="tiny",
                                                                device=device)
        steps, octree = 5, 64
    else:
        pipeline = Hunyuan3DDiTFlowMatchingPipeline.from_pretrained(
            "tencent/Hunyuan3D-2mini", subfolder="hunyuan3d-dit-v2-mini", variant="fp16",
            device=device)
        steps, octree = 50, 380
    image = _demo.image_or_demo(image_path, (90, 120, 220))
    start = time.time()
    mesh = pipeline(image=image, num_inference_steps=steps, octree_resolution=octree,
                    num_chunks=20000, seed=12345)[0]
    print("--- %s seconds ---" % (time.time() - start))
    mesh.export("demo_mini.glb")


if __name__ == "__main__":
    args = _demo.parse_args(__doc__)
    main(args.device, *args.inputs[:1])
