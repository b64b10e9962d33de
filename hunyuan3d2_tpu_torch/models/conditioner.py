"""Condition encoders, image → token sequence (port of
hunyuan3d2_tpu/models/conditioner.py, the single-view DINOv2 path).

The encoder owns its 518×518 resize/normalize transform (host side, numpy,
utils/imageproc.py) and returns last_hidden_state [B, 1370, 1536] at
DINOv2-giant. The unconditional embedding is a zeros tensor, not an encoded
blank image (reference conditioner.py:106-117).
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from hunyuan3d2_tpu_torch.models import dinov2


@dataclasses.dataclass(frozen=True)
class DinoEncoderConfig:
    dino: dinov2.DinoConfig = dinov2.GIANT
    image_size: int = 518


class DinoImageEncoder(nn.Module):
    """Single-view DINOv2 conditioner; the tower is ``self.model`` so the
    state dict carries the checkpoint's ``model.`` prefix."""

    def __init__(self, cfg: DinoEncoderConfig = DinoEncoderConfig()):
        super().__init__()
        self.cfg = cfg
        self.model = dinov2.Dinov2Model(cfg.dino)

    @property
    def device(self) -> torch.device:
        return self.model.layernorm.weight.device

    def encode(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """pixel_values [B, H, W, 3] normalized → [B, 1 + patches, hidden]
        (the CLS token kept, the reference default)."""
        return self.model(pixel_values)

    def preprocess(self, image_m11) -> torch.Tensor:
        """[-1,1] [B,H,W,3] numpy → normalized bf16 pixels at this tower's
        resolution, on the tower's device."""
        from hunyuan3d2_tpu_torch.utils.imageproc import dino_transform

        pix = torch.from_numpy(dino_transform(image_m11, self.cfg.image_size))
        return pix.to(self.device, torch.bfloat16)

    def unconditional(self, batch: int, num_views: int = 1) -> torch.Tensor:
        """Zero-token unconditional embedding [B, L, hidden] in bf16."""
        d = self.cfg.dino
        return torch.zeros(batch, d.seq_len * num_views, d.hidden_size, dtype=torch.bfloat16,
                           device=self.device)


class SingleImageEncoder(nn.Module):
    """One main encoder; ``{'main': tokens}`` streams for the DiT."""

    def __init__(self, main_image_encoder: DinoImageEncoder):
        super().__init__()
        self.main_image_encoder = main_image_encoder

    @property
    def main(self) -> DinoImageEncoder:
        return self.main_image_encoder

    def encode_image(self, image_m11) -> dict:
        """[-1,1] numpy image(s) → token streams, with the tower's own transform."""
        return {"main": self.main.encode(self.main.preprocess(image_m11))}

    def unconditional(self, batch: int, num_views: int = 1) -> dict:
        return {"main": self.main.unconditional(batch, num_views)}
