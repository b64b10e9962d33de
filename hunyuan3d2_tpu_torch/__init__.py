"""hunyuan3d2_tpu_torch — the PyTorch and CUDA port of hunyuan3d2_tpu.

Image → mesh on the mini and the v2-0 shape stacks (DINOv2 conditioner,
single- or multiview → flow-matching DiT, with CFG or a guidance embedding →
ShapeVAE → FlashVDM, hierarchical or vanilla decode → on-device surface
nets or host marching cubes / tetrahedra), and
mesh + image → textured mesh through the paint-turbo stack (device cond
maps → 2.5D UNet multiview diffusion → texture-space bake, the UV unwrap
running meanwhile in a host worker process, utils/host_worker.py);
the published checkpoints load with ``from_pretrained`` (io/checkpoints.py),
meshes are cleaned on the host (geometry/postprocess.py), text → image runs
through HunyuanDiT (pipelines/t2i.py, utils/text2image.py), and apps/ serves
it all over HTTP, gradio or a one-shot demo; examples/ holds the
reference's example scripts. The secondary image pipelines (delight, x4
upscale, ControlNet + IP-Adapter align: pipelines/{delight,upscale,align}.py
behind utils/{dehighlight,imagesuper,align_img4tex}.py) run standalone.
The DiT trains with flow matching (training/, checkpoints through
io/pytree_io.py), a ShapeVAE decode backpropagates a mesh-space loss
through the differentiable surface nets (volume/diff_surface.py), and
tools/export_native.py writes the standalone C++ driver's weight file.
Hand-written Hopper kernels: flash attention, unmasked and masked
(csrc/flash_attention.cu), the fused geo decoder and the streamed decode's
MLP tail (csrc/geo_decode.cu) and the z-buffer rasterizer
(csrc/rasterize.cu); the unmasked flash kernel is differentiable (its
backward is a hand-written kernel too, csrc/flash_attention_bwd.cu), the
others refuse inputs that require a gradient. Entry points run on ``cuda``
unless the caller passes ``device="cpu"``; on CPU tensors each kernel
wrapper runs its plain PyTorch twin. The package imports neither ``jax``
nor ``hunyuan3d2_tpu``.
"""

from hunyuan3d2_tpu_torch.utils.logger import get_logger  # noqa: F401

# The pipelines, the models and torch load at first use, so that importing
# the package stays cheap (the host worker process imports no torch).
_LAZY = {
    "synchronize_timer": "hunyuan3d2_tpu_torch.utils.timer",
    "Hunyuan3DDiTFlowMatchingPipeline": "hunyuan3d2_tpu_torch.pipelines.shapegen",
    "Hunyuan3DDiTPipeline": "hunyuan3d2_tpu_torch.pipelines.shapegen",
    "Hunyuan3DPaintPipeline": "hunyuan3d2_tpu_torch.pipelines.texgen",
    "ShapeVAE": "hunyuan3d2_tpu_torch.models.shapevae",
    "Mesh": "hunyuan3d2_tpu_torch.geometry.mesh",
}


def __getattr__(attr):
    if attr in _LAZY:
        import importlib

        return getattr(importlib.import_module(_LAZY[attr]), attr)
    raise AttributeError(f"module {__name__!r} has no attribute {attr!r}")
