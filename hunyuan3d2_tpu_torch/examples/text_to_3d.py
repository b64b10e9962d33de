"""Text → image → shape on the port (the reference's text front end,
hy3dgen/text2image.py HunyuanDiTPipeline feeding the shape pipeline, as its
api_server.py and gradio_app.py wire it).

HY3D_RANDOM_WEIGHTS=1 runs the whole path on random weights: the port's
HunyuanDiT pipeline at its tiny config, then the tiny shape stack. The GLB
goes to ``out_dir``/text_to_3d.glb, by default tmp/results at the repository
root as in the JAX example."""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from hunyuan3d2_tpu_torch.examples import _demo
from hunyuan3d2_tpu_torch.pipelines.shapegen import Hunyuan3DDiTFlowMatchingPipeline
from hunyuan3d2_tpu_torch.utils.text2image import HunyuanDiTPipeline

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(device="cuda", prompt="一只可爱的猫", out_dir=os.path.join(ROOT, "tmp", "results")):
    t2i = HunyuanDiTPipeline(model_path=os.environ.get(
        "HY3D_T2I_MODEL", "Tencent-Hunyuan/HunyuanDiT-v1.1-Diffusers-Distilled"), device=device)
    if _demo.random_weights():
        pipeline = Hunyuan3DDiTFlowMatchingPipeline.init_random(size="tiny", dino="tiny",
                                                                device=device)
        steps, octree = 5, 64
    else:
        pipeline = Hunyuan3DDiTFlowMatchingPipeline.from_pretrained(
            "tencent/Hunyuan3D-2mini", subfolder="hunyuan3d-dit-v2-mini", variant="fp16",
            device=device)
        steps, octree = 50, 380
    t0 = time.time()
    image = t2i(prompt, seed=0)
    print(f"t2i image: {image.size} in {time.time() - t0:.2f}s")
    mesh = pipeline(image=image, num_inference_steps=steps, octree_resolution=octree,
                    seed=12345)[0]
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "text_to_3d.glb")
    mesh.export(path)
    print(f"--- {time.time() - t0:.2f} seconds ---")
    print(f"wrote {path}")


if __name__ == "__main__":
    args = _demo.parse_args(__doc__)
    main(args.device, *args.inputs[:1])
