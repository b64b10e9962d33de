"""Condition encoders, image → token sequence (port of
hunyuan3d2_tpu/models/conditioner.py: the single-view and the multiview
DINOv2 encoders, the CLIP tower and the Dual encoder that holds both).

The encoder owns its 518×518 resize/normalize transform (host side, numpy,
utils/imageproc.py) and returns last_hidden_state [B, 1370, 1536] at
DINOv2-giant. The multiview encoder adds a per-view sin-cos view embedding to
every token of a view and flattens the views into one sequence; it has no
weights of its own. The unconditional embedding is a zeros tensor, not an
encoded blank image (reference conditioner.py:106-117). The Dual encoder
adds an ``additional`` stream from a CLIP tower with its own 224-pixel
transform; the DiT reads only ``main``.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from hunyuan3d2_tpu_torch.models import clip_vit, dinov2
from hunyuan3d2_tpu_torch.ops.embeddings import sincos_1d_pos_embed


@dataclasses.dataclass(frozen=True)
class DinoEncoderConfig:
    dino: dinov2.DinoConfig = dinov2.GIANT
    image_size: int = 518


class DinoImageEncoder(nn.Module):
    """Single-view DINOv2 conditioner; the tower is ``self.model`` so the
    state dict carries the checkpoint's ``model.`` prefix. ``model`` shares
    an existing tower instead of making one."""

    def __init__(self, cfg: DinoEncoderConfig = DinoEncoderConfig(),
                 model: dinov2.Dinov2Model = None):
        super().__init__()
        self.cfg = cfg
        self.model = model if model is not None else dinov2.Dinov2Model(cfg.dino)

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


class DinoImageEncoderMV(DinoImageEncoder):
    """Multiview conditioner (reference conditioner.py:154-188): each view is
    encoded, the sin-cos embedding of its view index is added to every token
    of it, and the views are flattened into one sequence."""

    def __init__(self, cfg: DinoEncoderConfig = DinoEncoderConfig(), num_views: int = 4,
                 model: dinov2.Dinov2Model = None):
        super().__init__(cfg, model)
        self.num_views = num_views

    def encode_views(self, pixel_values: torch.Tensor, view_idxs) -> torch.Tensor:
        """pixel_values [B, V, H, W, 3] normalized, view_idxs V ints →
        [B, V·L, hidden]."""
        b, v = pixel_values.shape[:2]
        tokens = self.encode(pixel_values.reshape(b * v, *pixel_values.shape[2:]))
        tokens = tokens.reshape(b, v, tokens.shape[1], tokens.shape[2])
        embeds = sincos_1d_pos_embed(self.cfg.dino.hidden_size,
                                     torch.arange(self.num_views, device=tokens.device))
        ve = embeds[torch.as_tensor(view_idxs, device=tokens.device)]    # [V, hidden]
        tokens = tokens + ve[None, :, None, :].to(tokens.dtype)
        return tokens.reshape(b, v * tokens.shape[2], tokens.shape[3])


class SingleImageEncoder(nn.Module):
    """One main encoder; ``{'main': tokens}`` streams for the DiT."""

    def __init__(self, main_image_encoder: DinoImageEncoder):
        super().__init__()
        self.main_image_encoder = main_image_encoder

    @property
    def main(self) -> DinoImageEncoder:
        return self.main_image_encoder

    def encode_image(self, image_m11, view_idxs=None) -> dict:
        """[-1,1] numpy image(s) [B, H, W, 3] → token streams, with the
        tower's own transform; with ``view_idxs`` (``[[...]]``) the images are
        [B, V, H, W, 3] views for the multiview encoder."""
        if view_idxs is not None:
            b, v = image_m11.shape[:2]
            pixel = self.main.preprocess(image_m11.reshape(b * v, *image_m11.shape[2:]))
            pixel = pixel.reshape(b, v, *pixel.shape[1:])
            return {"main": self.main.encode_views(pixel, view_idxs[0])}
        return {"main": self.main.encode(self.main.preprocess(image_m11))}

    def unconditional(self, batch: int, num_views: int = 1) -> dict:
        return {"main": self.main.unconditional(batch, num_views)}


class CLIPImageEncoder(nn.Module):
    """The CLIP tower as a conditioner encoder: ``self.model`` holds the HF
    ``CLIPVisionModel`` names, so the state dict carries the checkpoint's
    ``model.vision_model.`` prefix."""

    def __init__(self, cfg: clip_vit.CLIPVisionConfig = clip_vit.LARGE,
                 use_cls_token: bool = True):
        super().__init__()
        self.cfg = cfg
        self.use_cls_token = use_cls_token
        self.model = clip_vit.CLIPVisionModel(cfg)

    @property
    def device(self) -> torch.device:
        return self.model.vision_model.pre_layrnorm.weight.device

    def encode(self, pixel_values: torch.Tensor) -> torch.Tensor:
        out = self.model(pixel_values)
        return out if self.use_cls_token else out[:, 1:]

    def preprocess(self, image_m11) -> torch.Tensor:
        """[-1,1] [B,H,W,3] numpy → CLIP-normalised bf16 pixels at this
        tower's resolution, on the tower's device."""
        from hunyuan3d2_tpu_torch.utils.imageproc import clip_transform

        pix = torch.from_numpy(clip_transform(image_m11, self.cfg.image_size))
        return pix.to(self.device, torch.bfloat16)

    def unconditional(self, batch: int, num_views: int = 1) -> torch.Tensor:
        n = self.cfg.seq_len if self.use_cls_token else self.cfg.num_patches
        return torch.zeros(batch, n * num_views, self.cfg.hidden_size, dtype=torch.bfloat16,
                           device=self.device)


class DualImageEncoder(SingleImageEncoder):
    """The main (DINOv2) encoder and the additional (CLIP) one, each with its
    own transform: ``{'main', 'additional'}`` streams, and zero-token
    unconditional embeddings for both."""

    def __init__(self, main_image_encoder: DinoImageEncoder,
                 additional_image_encoder: CLIPImageEncoder):
        super().__init__(main_image_encoder)
        self.additional_image_encoder = additional_image_encoder

    @property
    def additional(self) -> CLIPImageEncoder:
        return self.additional_image_encoder

    def encode_image(self, image_m11, view_idxs=None) -> dict:
        out = super().encode_image(image_m11, view_idxs)
        flat = image_m11
        if view_idxs is not None:
            b, v = image_m11.shape[:2]
            flat = image_m11.reshape((b * v,) + image_m11.shape[2:])
        out["additional"] = self.additional.encode(self.additional.preprocess(flat))
        return out

    def unconditional(self, batch: int, num_views: int = 1) -> dict:
        out = super().unconditional(batch, num_views)
        out["additional"] = self.additional.unconditional(batch, num_views)
        return out
