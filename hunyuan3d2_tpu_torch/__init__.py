"""hunyuan3d2_tpu_torch — the PyTorch and CUDA port of hunyuan3d2_tpu.

Image → mesh on the mini and the v2-0 shape stacks (DINOv2 conditioner,
single- or multiview → flow-matching DiT, with CFG or a guidance embedding →
ShapeVAE → FlashVDM, hierarchical or vanilla decode → on-device surface
nets or host marching cubes / tetrahedra), and
mesh + image → textured mesh through the paint-turbo stack (device cond
maps → 2.5D UNet multiview diffusion → UV unwrap → texture-space bake);
the published checkpoints load with ``from_pretrained`` (io/checkpoints.py),
meshes are cleaned on the host (geometry/postprocess.py), text → image runs
through HunyuanDiT (pipelines/t2i.py, utils/text2image.py), and apps/ serves
it all over HTTP, gradio or a one-shot demo; examples/ holds the
reference's example scripts. The secondary image pipelines (delight, x4
upscale, ControlNet + IP-Adapter align: pipelines/{delight,upscale,align}.py
behind utils/{dehighlight,imagesuper,align_img4tex}.py) run standalone.
Hand-written Hopper kernels: flash attention, unmasked and masked
(csrc/flash_attention.cu), the fused geo decoder and the streamed decode's
MLP tail (csrc/geo_decode.cu) and the z-buffer rasterizer
(csrc/rasterize.cu). Entry points run on ``cuda``
unless the caller passes ``device="cpu"``; on CPU tensors each kernel
wrapper runs its plain PyTorch twin. The package imports neither ``jax``
nor ``hunyuan3d2_tpu``.
"""

from hunyuan3d2_tpu_torch.pipelines.shapegen import (  # noqa: F401
    Hunyuan3DDiTFlowMatchingPipeline,
    Hunyuan3DDiTPipeline,
)
from hunyuan3d2_tpu_torch.pipelines.texgen import Hunyuan3DPaintPipeline  # noqa: F401
