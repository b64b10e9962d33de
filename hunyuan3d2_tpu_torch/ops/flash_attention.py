"""Flash attention: the hand-written Hopper kernel and its plain twin.

Port of hunyuan3d2_tpu/ops/flash_attention.py ``flash_attention`` (the
Pallas kernel ``_flash`` / ``_kernel``). The CUDA source is
``csrc/flash_attention.cu``; its header says how it is laid out and what
bounds it on the H100.

Same function as the TPU kernel: the scale is folded into q in fp32 and
rounded back to the input dtype before the product, softmax state and
accumulator are fp32, padded key columns are masked, the output is
acc / max(l, 1e-30) in the input dtype. bf16 and fp32 inputs, D in {64, 128}.

A CPU tensor goes through :func:`flash_attention_plain`; a CUDA tensor
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

_DTYPES = {torch.bfloat16: 0, torch.float32: 1}


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: Optional[float] = None) -> torch.Tensor:
    """The kernel's function in plain PyTorch: scale folded into q in the
    input dtype, fp32 logits and softmax, probabilities rounded to the input
    dtype before the P·V product."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    qs = (q.float() * scale).to(q.dtype)
    logits = torch.einsum("bhqd,bhkd->bhqk", qs.float(), k.float())
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", w.float(), v.float()).to(q.dtype)


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention takes [B, H, L, D] q, k, v")
    b, h, _, d = q.shape
    if k.shape[:2] != (b, h) or k.shape[3] != d or v.shape != k.shape:
        raise ValueError(f"flash_attention shapes disagree: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if d not in (64, 128):
        raise ValueError(f"flash_attention takes D in (64, 128), got {d}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes bf16 or fp32 q/k/v of one dtype, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention inputs lie on different devices")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention takes contiguous q, k, v")


@functools.lru_cache(maxsize=None)
def _lib():
    """The kernel's C entry point, built and loaded at first use."""
    from hunyuan3d2_tpu_torch.utils import cuda_build

    lib = cuda_build.load("flash_attention")
    fn = lib.hy3d_flash_attention
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q [B, H, Lq, D], k/v [B, H, Lk, D] → [B, H, Lq, D] in q.dtype."""
    _check(q, k, v)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, scale)
    b, h, lq, d = q.shape
    lk = k.shape[2]
    out = torch.empty_like(q)
    err = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b * h, lq, lk, d,
                 _DTYPES[q.dtype], float(scale), torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: cudaError {err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
