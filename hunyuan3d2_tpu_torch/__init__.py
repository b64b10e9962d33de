"""hunyuan3d2_tpu_torch — the PyTorch and CUDA port of hunyuan3d2_tpu.

Image → mesh on the mini shape stack (DINOv2 conditioner → flow-matching
DiT → ShapeVAE → FlashVDM block-sparse decode → on-device surface nets),
with hand-written Hopper kernels for flash attention (csrc/flash_attention.cu)
and the fused geo decoder (csrc/geo_decode.cu). Entry points run on ``cuda``
unless the caller passes ``device="cpu"``; on CPU tensors each kernel
wrapper runs its plain PyTorch twin. The package imports neither ``jax``
nor ``hunyuan3d2_tpu``.
"""

from hunyuan3d2_tpu_torch.pipelines.shapegen import (  # noqa: F401
    Hunyuan3DDiTFlowMatchingPipeline,
    Hunyuan3DDiTPipeline,
)
