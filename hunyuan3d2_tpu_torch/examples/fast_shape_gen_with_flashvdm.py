"""Turbo shape generation with FlashVDM decoding on the port (the
reference's examples/fast_shape_gen_with_flashvdm.py: 5 steps, octree 380,
chunks 200000, FlashVDM on)."""

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
        octree = 64
    else:
        pipeline = Hunyuan3DDiTFlowMatchingPipeline.from_pretrained(
            "tencent/Hunyuan3D-2", subfolder="hunyuan3d-dit-v2-0-turbo", device=device)
        octree = 380
    pipeline.enable_flashvdm(True, mc_algo="dmc")
    image = _demo.image_or_demo(image_path, (90, 200, 120))
    start = time.time()
    mesh = pipeline(image=image, num_inference_steps=5, octree_resolution=octree,
                    num_chunks=200000, seed=12345)[0]
    print("--- %s seconds ---" % (time.time() - start))
    mesh.export("fast_shape_gen.glb")


if __name__ == "__main__":
    args = _demo.parse_args(__doc__)
    main(args.device, *args.inputs[:1])
