"""Golden-stat instrumentation (port of hunyuan3d2_tpu/utils/debug.py).

The reference's ``todos.debug.output_var`` tensor-stat logging: size, min,
max and mean of an intermediate, printed in the reference's format when
HY3DGEN_DEBUG=1. Takes torch tensors (any dtype and device, bf16 included:
the stats are taken in fp32 on the host) as well as numpy arrays.
"""

from __future__ import annotations

import os

import numpy as np
import torch


def tensor_stats(x) -> dict:
    """Size, dtype (named as numpy names it: "bfloat16", "float32"), min,
    max and mean of ``x``."""
    if isinstance(x, torch.Tensor):
        arr = x.detach().float().cpu().numpy()
        return {**tensor_stats(arr), "dtype": str(x.dtype).replace("torch.", "")}
    if hasattr(x, "dtype"):
        arr = np.asarray(x, dtype=np.float32)
    else:
        arr = np.asarray(x)
    return {
        "size": list(arr.shape),
        "dtype": str(getattr(x, "dtype", arr.dtype)),
        "min": float(arr.min()) if arr.size else None,
        "max": float(arr.max()) if arr.size else None,
        "mean": float(arr.mean()) if arr.size else None,
    }


def output_var(name: str, x, force: bool = False):
    """Print `tensor [name] size: [...] min/max/mean` (reference format)."""
    if not force and os.environ.get("HY3DGEN_DEBUG", "0") != "1":
        return None
    s = tensor_stats(x)
    print(f"tensor [{name}] size: {s['size']}, min: {s['min']:.6g}, "
          f"max: {s['max']:.6g}, mean: {s['mean']:.6g}")
    return s
