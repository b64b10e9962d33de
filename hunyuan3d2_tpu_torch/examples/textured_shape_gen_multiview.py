"""Multiview shape + texture generation on the port (the reference's
examples/textured_shape_gen_multiview.py: Hunyuan3D-2mv shape from a
front/left/back view dict → paint conditioned on the front view)."""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from hunyuan3d2_tpu_torch.examples import _demo
from hunyuan3d2_tpu_torch.models.conditioner import DinoImageEncoderMV, SingleImageEncoder
from hunyuan3d2_tpu_torch.pipelines.shapegen import Hunyuan3DDiTFlowMatchingPipeline
from hunyuan3d2_tpu_torch.pipelines.texgen import Hunyuan3DPaintPipeline
from hunyuan3d2_tpu_torch.utils.imageproc import MVImageProcessorV2


def main(device="cuda", view_paths=()):
    if _demo.random_weights():
        pipeline = Hunyuan3DDiTFlowMatchingPipeline.init_random(size="tiny", dino="tiny",
                                                                device=device)
        main_enc = pipeline.conditioner.main
        pipeline.conditioner = SingleImageEncoder(DinoImageEncoderMV(main_enc.cfg,
                                                                     model=main_enc.model))
        paint_pipe = Hunyuan3DPaintPipeline.init_random(view_size=64, render_size=256,
                                                        texture_size=256, num_inference_steps=2,
                                                        device=device)
        steps, octree = 3, 64
    else:
        pipeline = Hunyuan3DDiTFlowMatchingPipeline.from_pretrained(
            "tencent/Hunyuan3D-2mv", subfolder="hunyuan3d-dit-v2-mv", variant="fp16",
            device=device)
        paint_pipe = Hunyuan3DPaintPipeline.from_pretrained("tencent/Hunyuan3D-2", device=device)
        steps, octree = 50, 380
    pipeline.image_processor = MVImageProcessorV2()
    views = _demo.views_or_demo(view_paths)
    start = time.time()
    mesh = pipeline(image=views, num_inference_steps=steps, octree_resolution=octree,
                    num_chunks=20000, seed=12345)[0]
    print("--- %s seconds ---" % (time.time() - start))
    mesh.export("demo_white_mesh_mv.glb")
    textured = paint_pipe(mesh, views["front"])
    textured.export("demo_textured_mv.glb")


if __name__ == "__main__":
    args = _demo.parse_args(__doc__)
    main(args.device, args.inputs)
