"""The secondary image pipelines at TINY size on the card against the CPU.

Each function builds one pipeline on the CPU and one on the card holding
the CPU's weights, runs both on the same seeded inputs and draws, and
returns both outputs; :func:`image_agreement` compares them. The limits,
image corr ≥ 0.99 and mean |Δ| ≤ 3 levels, are held by ``chip_smoke.py``
(which logs the numbers) and by ``tests/test_torch_cuda.py``. Needs a CUDA
device:

    python -m pytest -m cuda tests/test_torch_cuda.py -k "delight or upscale or align"
"""

from __future__ import annotations

import numpy as np
import torch

# the head-64 upscaler's kernel-1 launches on the card: 2 steps × (self +
# cross) × 4 transformer layers at its 32² level (down 1, mid 1, up 2)
UPSCALE_FLASH_LAUNCHES = 2 * 2 * 4


def copy_to(card, cpu):
    """``card`` with ``cpu``'s module weights and tensors."""
    for name, value in vars(cpu).items():
        if isinstance(value, torch.nn.Module):
            getattr(card, name).load_state_dict(value.state_dict())
        elif isinstance(value, torch.Tensor):
            setattr(card, name, value.to(card.device))
    return card


def image_agreement(a, b):
    """Two images (PIL / uint8, or floats in [0, 1]) → (corr, mean |Δ| in
    8-bit levels, std of ``a`` in levels)."""
    x, y = (np.asarray(i, np.float64) * (1.0 if np.asarray(i).dtype == np.uint8 else 255.0)
            for i in (a, b))
    return np.corrcoef(x.ravel(), y.ravel())[0, 1], np.abs(x - y).mean(), x.std()


def agrees(a, b) -> bool:
    corr, mad, std = image_agreement(a, b)
    return std > 1.0 and corr >= 0.99 and mad <= 3.0


def delight_images():
    """The TINY delight pipeline (32², 3 steps, triple CFG; head sizes 16
    and 32 take the plain attention) → (card rgb01, CPU rgb01)."""
    from hunyuan3d2_tpu_torch.pipelines.delight import DelightPipeline

    def make(device):
        return DelightPipeline.init_random(resolution=32, num_inference_steps=3, device=device,
                                           seed=1)

    cpu = make("cpu")
    card = copy_to(make("cuda"), cpu)
    rs = np.random.RandomState(0)
    rgb = rs.rand(40, 48, 3).astype(np.float32)
    init = rs.randn(1, 16, 16, 4).astype(np.float32)
    noises = [rs.randn(1, 16, 16, 4).astype(np.float32) for _ in range(3)]
    return tuple(p(rgb, init_latents=init, step_noises=noises) for p in (card, cpu))


def upscale_images():
    """A head-64 TINY upscaler (channels (64, 128), 2 heads; 64² → 256², 2
    steps): its 32² level's self and cross attention (1024 queries) go
    through kernel 1 on the card → (card image, CPU image, the card call's
    ``flash_attention`` launches)."""
    import dataclasses

    from PIL import Image

    from hunyuan3d2_tpu_torch.models import paint_unet, sd_vae
    from hunyuan3d2_tpu_torch.ops.flash_attention import flash_attention
    from hunyuan3d2_tpu_torch.ops.nn import build
    from hunyuan3d2_tpu_torch.pipelines import upscale

    ucfg = dataclasses.replace(upscale.X4_UNET_TINY, block_out_channels=(64, 128))
    rs = np.random.RandomState(1)
    text = rs.randn(77, ucfg.cross_attention_dim).astype(np.float32)

    def make(device):
        return upscale.UpscalePipeline(
            build(paint_unet.plain_unet, ucfg, device=device),
            build(sd_vae.AutoencoderKL, upscale.X4_VAE_TINY, device=device), text,
            num_inference_steps=2, device=device)

    cpu = make("cpu")
    card = copy_to(make("cuda"), cpu)
    img = Image.fromarray(rs.randint(0, 256, (64, 64, 3)).astype(np.uint8))
    lowres = rs.randn(1, 64, 64, 3).astype(np.float32)
    init = rs.randn(1, 64, 64, 4).astype(np.float32)
    before = flash_attention.launches
    a = card(img, lowres_noise=lowres, init_latents=init)
    launches = flash_attention.launches - before
    return a, cpu(img, lowres_noise=lowres, init_latents=init), launches


def align_images(strengths=(1.0, 0.5)):
    """The TINY ControlNet + IP-Adapter pipeline (32², 4 steps; the adapter's
    ``to_k_ip`` / ``to_v_ip`` and the zero convs seeded non-zero, seeded
    image tokens), text-to-image and img2img → [(strength, card image, CPU
    image), ...]."""
    from PIL import Image

    from hunyuan3d2_tpu_torch.pipelines.align import ControlNetSDPipeline

    def make(device):
        pipe = ControlNetSDPipeline.init_random(resolution=32, device=device, seed=2)
        pipe.image_encoder = lambda image: np.random.RandomState(3).randn(1, 8, 48)
        return pipe

    cpu = make("cpu")
    g = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for name, p in (list(cpu.unet.named_parameters())
                        + list(cpu.controlnet.named_parameters())):
            if "_ip." in name or name.startswith(("controlnet_down", "controlnet_mid")):
                p.copy_(torch.randn(p.shape, generator=g) * 0.1)
    card = copy_to(make("cuda"), cpu)
    rs = np.random.RandomState(5)
    depth, ip_img = (Image.fromarray(rs.randint(0, 256, (32, 32, 3)).astype(np.uint8))
                     for _ in range(2))
    init = rs.randn(1, 16, 16, 4).astype(np.float32)
    noises = [rs.randn(1, 16, 16, 4).astype(np.float32) for _ in range(4)]
    return [(s, *(p(control_image=depth, ip_adapter_image=ip_img, init_image=ip_img,
                    strength=s, num_inference_steps=4, init_noise=init, step_noises=noises)
                  for p in (card, cpu)))
            for s in strengths]
