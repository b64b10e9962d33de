"""What the port's CUDA graphs share (models/dit.py's forward graphs,
models/paint_unet.py's step graphs): one side stream a device for every
capture, the launch counters of the port's ops, and a memory pool kept
across the graphs captured into it."""

from __future__ import annotations

import sys

import torch

_CAPTURE_STREAMS = {}       # device → the side stream every capture on it uses


def capture_stream(device: torch.device):
    """One side stream a device for the captures: cuBLAS keeps a workspace
    for each stream it runs on, so one stream holds one more."""
    stream = _CAPTURE_STREAMS.get(device)
    if stream is None:
        stream = _CAPTURE_STREAMS[device] = torch.cuda.Stream(device)
    return stream


def launch_counts() -> dict:
    """Each launch counter of the port's ops (an op function's
    ``launches``, e.g. ``flash_attention.launches``) → its count."""
    counts = {}
    for name, mod in list(sys.modules.items()):
        if name.startswith("hunyuan3d2_tpu_torch.ops.") and mod is not None:
            for fn in vars(mod).values():
                if callable(fn) and type(getattr(fn, "launches", None)) is int:
                    counts[fn] = fn.launches
    return counts


def anchored_pool(device: torch.device):
    """(a new graph memory pool, its anchor): a graph of one small kernel
    captured into the pool on the device's capture stream. PyTorch releases
    a pool once no graph holds it, and refuses captures into it after; the
    anchor holds it, and the memory it caches, for the captures to come."""
    pool = torch.cuda.graph_pool_handle()
    anchor = torch.cuda.CUDAGraph()
    stream = capture_stream(device)
    stream.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(stream):
        anchor.capture_begin(pool=pool, capture_error_mode="thread_local")
        try:
            torch.zeros(1, device=device)
        finally:
            anchor.capture_end()
    return pool, anchor
