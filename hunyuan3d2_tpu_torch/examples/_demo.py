"""Shared inputs of the examples: a demo RGBA image and a 3-view dict."""

import os

import numpy as np
from PIL import Image


def random_weights() -> bool:
    return os.environ.get("HY3D_RANDOM_WEIGHTS", "0") == "1"


def demo_image(color, size: int = 512) -> Image.Image:
    """A ``color`` square on a transparent ``size``² canvas."""
    arr = np.zeros((size, size, 4), np.uint8)
    lo, hi = size * 3 // 16, size * 13 // 16
    arr[lo:hi, lo:hi] = list(color) + [255]
    return Image.fromarray(arr)


def image_or_demo(path, color) -> Image.Image:
    return Image.open(path) if path else demo_image(color)


def views_or_demo(paths) -> dict:
    """{front, left, back} from three image paths, else three demo squares."""
    if paths and len(paths) >= 3:
        return {k: Image.open(p) for k, p in zip(("front", "left", "back"), paths)}
    return {"front": demo_image((200, 60, 60)), "left": demo_image((60, 200, 60)),
            "back": demo_image((60, 60, 200))}


def parse_args(description: str):
    """``--device`` (default cuda) and the positional input paths."""
    import argparse

    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("inputs", nargs="*")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args()
