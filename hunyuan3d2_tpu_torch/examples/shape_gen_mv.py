"""Multiview-conditioned shape generation on the port (the reference's
examples/mv_shape_gen.py: a front/left/back view dict → Hunyuan3D-2mv)."""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from hunyuan3d2_tpu_torch.examples import _demo
from hunyuan3d2_tpu_torch.models.conditioner import DinoImageEncoderMV, SingleImageEncoder
from hunyuan3d2_tpu_torch.pipelines.shapegen import Hunyuan3DDiTFlowMatchingPipeline
from hunyuan3d2_tpu_torch.utils.imageproc import MVImageProcessorV2


def _random_mv_pipeline(device):
    """The tiny random stack with its DINOv2 tower as the multiview encoder."""
    pipeline = Hunyuan3DDiTFlowMatchingPipeline.init_random(size="tiny", dino="tiny",
                                                            device=device)
    main_enc = pipeline.conditioner.main
    pipeline.conditioner = SingleImageEncoder(DinoImageEncoderMV(main_enc.cfg,
                                                                 model=main_enc.model))
    pipeline.image_processor = MVImageProcessorV2()
    return pipeline


def main(device="cuda", view_paths=()):
    if _demo.random_weights():
        pipeline = _random_mv_pipeline(device)
        steps, octree = 5, 64
    else:
        pipeline = Hunyuan3DDiTFlowMatchingPipeline.from_pretrained(
            "tencent/Hunyuan3D-2mv", subfolder="hunyuan3d-dit-v2-mv", device=device)
        pipeline.image_processor = MVImageProcessorV2()
        steps, octree = 30, 256
    views = _demo.views_or_demo(view_paths)
    start = time.time()
    mesh = pipeline(image=views, num_inference_steps=steps, octree_resolution=octree,
                    seed=12345)[0]
    print("--- %s seconds ---" % (time.time() - start))
    mesh.export("shape_gen_mv.glb")


if __name__ == "__main__":
    args = _demo.parse_args(__doc__)
    main(args.device, args.inputs)
