"""Host-side image preprocessing.

Behavioral parity: reference hy3dgen/shapegen/preprocessors.py
(ImageProcessorV2 :30 — alpha-bbox recenter with border ratio, white
composite, resize 512, to [-1,1] tensor + mask; MVImageProcessorV2 :120 —
fixed view order front/left/back/right + view_idxs) and the conditioner
transform (conditioner.py:80-89: [-1,1]→[0,1], resize to 518 bilinear,
center-crop, ImageNet normalize).

Implemented on numpy/PIL; outputs are channels-LAST [B, H, W, C] float32
(the models take NHWC). Copied from hunyuan3d2_tpu/utils/imageproc.py (the
single-view processor and the DINOv2 transform) so the port imports nothing
of the JAX package.
"""

from __future__ import annotations

import numpy as np
from PIL import Image


def _to_rgba_array(image) -> np.ndarray:
    """PIL image / array / path → [H, W, 4] uint8 RGBA."""
    if isinstance(image, str):
        image = Image.open(image)
    if isinstance(image, Image.Image):
        image = image.convert("RGBA")
        return np.asarray(image)
    image = np.asarray(image)
    if image.dtype != np.uint8:
        image = (np.clip(image, 0, 1) * 255).astype(np.uint8)
    if image.ndim == 2:
        image = np.stack([image] * 3, -1)
    if image.shape[-1] == 3:
        alpha = np.full(image.shape[:2] + (1,), 255, np.uint8)
        image = np.concatenate([image, alpha], -1)
    return image


def recenter_rgba(rgba: np.ndarray, size: int, border_ratio: float = 0.15) -> np.ndarray:
    """Recenter the object by its alpha bbox into a square canvas with a
    border (parity: preprocessors.py:35-106 recenter)."""
    alpha = rgba[..., 3]
    ys, xs = np.nonzero(alpha > 0)
    if len(ys) == 0:
        return np.asarray(Image.fromarray(rgba).resize((size, size), Image.BILINEAR))
    y0, y1, x0, x1 = ys.min(), ys.max() + 1, xs.min(), xs.max() + 1
    crop = rgba[y0:y1, x0:x1]
    h, w = crop.shape[:2]
    # reference: desired_size = int(size * (1 - border_ratio))
    # (preprocessors.py:67) — the object spans (1-border_ratio) of the canvas
    desired = int(size * (1 - border_ratio))
    scale = desired / max(h, w)
    nh, nw = max(1, int(round(h * scale))), max(1, int(round(w * scale)))
    crop_img = Image.fromarray(crop).resize((nw, nh), Image.BILINEAR)
    canvas = np.zeros((size, size, 4), np.uint8)
    oy, ox = (size - nh) // 2, (size - nw) // 2
    canvas[oy:oy + nh, ox:ox + nw] = np.asarray(crop_img)
    return canvas


class ImageProcessorV2:
    """image → dict(image=[B,H,W,3] in [-1,1] white-composited,
    mask=[B,H,W,1] in {-1,1})."""

    def __init__(self, size: int = 512, border_ratio: float = 0.15):
        self.size = size
        self.border_ratio = border_ratio

    def process_one(self, image, border_ratio=None):
        rgba = _to_rgba_array(image)
        rgba = recenter_rgba(rgba, self.size, border_ratio or self.border_ratio)
        rgb = rgba[..., :3].astype(np.float32) / 255.0
        alpha = rgba[..., 3:4].astype(np.float32) / 255.0
        rgb = rgb * alpha + (1.0 - alpha)          # composite on white
        image_t = rgb * 2.0 - 1.0                  # [-1, 1]
        mask_t = alpha * 2.0 - 1.0
        return image_t, mask_t

    def __call__(self, image, border_ratio=None, **kwargs) -> dict:
        if not isinstance(image, (list, tuple)):
            image = [image]
        ims, masks = zip(*[self.process_one(im, border_ratio) for im in image])
        return {
            "image": np.stack(ims).astype(np.float32),
            "mask": np.stack(masks).astype(np.float32),
        }


class MVImageProcessorV2(ImageProcessorV2):
    """Multiview: dict {front/left/back/right: image} → the views stacked as
    one item, [1, V, H, W, 3], in the order front, left, back, right, and
    ``view_idxs`` [[...]] the indices of the views given in that order
    (parity: preprocessors.py:120-160)."""

    return_view_idx = True
    VIEW_ORDER = ("front", "left", "back", "right")

    def __call__(self, image_dict, border_ratio=None, **kwargs) -> dict:
        ims, masks, view_idxs = [], [], []
        for i, name in enumerate(self.VIEW_ORDER):
            if name not in image_dict:
                continue
            im, mk = self.process_one(image_dict[name], border_ratio)
            ims.append(im)
            masks.append(mk)
            view_idxs.append(i)
        return {
            "image": np.stack(ims)[None].astype(np.float32),
            "mask": np.stack(masks)[None].astype(np.float32),
            "view_idxs": [view_idxs],
        }


def dino_transform(image_m11: np.ndarray, image_size: int = 518,
                   mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225)) -> np.ndarray:
    """[-1,1] [B,H,W,3] → resized/center-cropped/normalized [B,518,518,3]
    (parity: conditioner.py:80-95 value_range rescale + transform)."""
    x = (image_m11 + 1.0) / 2.0
    b, h, w, c = x.shape
    scale = image_size / min(h, w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    out = np.empty((b, image_size, image_size, c), np.float32)
    for i in range(b):
        im = Image.fromarray((np.clip(x[i], 0, 1) * 255).astype(np.uint8))
        im = im.resize((nw, nh), Image.BILINEAR)
        arr = np.asarray(im).astype(np.float32) / 255.0
        y0 = (nh - image_size) // 2
        x0 = (nw - image_size) // 2
        out[i] = arr[y0:y0 + image_size, x0:x0 + image_size]
    return (out - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)


def clip_transform(image_m11: np.ndarray, image_size: int = 224) -> np.ndarray:
    """:func:`dino_transform` with CLIP's normalisation: the CLIP tower's
    transform in the Dual conditioner."""
    return dino_transform(image_m11, image_size, mean=(0.48145466, 0.4578275, 0.40821073),
                          std=(0.26862954, 0.26130258, 0.27577711))
