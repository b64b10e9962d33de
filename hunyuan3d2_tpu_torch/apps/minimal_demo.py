"""Minimal demo on the PyTorch port: image → mesh → demo.glb (port of
apps/minimal_demo.py).

With a checkpoint directory (``--model_path`` holding ``--subfolder``, or
``$HY3DGEN_MODELS``):
    python -m hunyuan3d2_tpu_torch.apps.minimal_demo --image assets/demo.png
Without one (random weights from a seed, octree capped at 128):
    python -m hunyuan3d2_tpu_torch.apps.minimal_demo --random-weights --device cpu
"""

import argparse
import os
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--image", default=None)
    ap.add_argument("--model_path", default="tencent/Hunyuan3D-2mini")
    ap.add_argument("--subfolder", default="hunyuan3d-dit-v2-mini-turbo")
    ap.add_argument("--output", default="demo.glb")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--octree", type=int, default=380)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--random-weights", action="store_true")
    args = ap.parse_args(argv)

    import numpy as np
    from PIL import Image

    from hunyuan3d2_tpu_torch import Hunyuan3DDiTFlowMatchingPipeline

    if args.random_weights:
        pipe = Hunyuan3DDiTFlowMatchingPipeline.init_random(
            size=os.environ.get("HY3D_RANDOM_SIZE", "mini"), dino="tiny", device=args.device)
        args.octree = min(args.octree, 128)
    else:
        pipe = Hunyuan3DDiTFlowMatchingPipeline.from_pretrained(
            args.model_path, subfolder=args.subfolder, device=args.device)
    pipe.enable_flashvdm(True)

    if args.image:
        image = Image.open(args.image)
    else:
        arr = np.zeros((512, 512, 4), np.uint8)
        arr[128:384, 128:384] = [180, 60, 60, 255]
        image = Image.fromarray(arr)

    t0 = time.time()
    mesh = pipe(image=image, num_inference_steps=args.steps, octree_resolution=args.octree,
                seed=12345)[0]
    print(f"--- {time.time() - t0:.2f} seconds ---")
    mesh.export(args.output)
    print(f"wrote {args.output}: {len(mesh.vertices)} verts, {len(mesh.faces)} faces")


if __name__ == "__main__":
    main()
