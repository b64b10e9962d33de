"""Flash attention, unmasked and masked: the hand-written Hopper kernel and
its plain twins.

Port of hunyuan3d2_tpu/ops/flash_attention.py ``flash_attention`` (the
Pallas kernel ``_flash`` / ``_kernel``) and ``flash_attention_masked``
(``_flash_masked`` / ``_kernel_masked``). The CUDA source is
``csrc/flash_attention.cu``; its header says how it is laid out and what
bounds it on the H100.

Same function as the TPU kernel: the scale is folded into q in fp32 and
rounded back to the input dtype before the product, softmax state and
accumulator are fp32, padded key columns are masked, the output is
acc / max(l, 1e-30) in the input dtype. bf16 and fp32 inputs, D in {64, 128}.
The masked form takes a [B, Lq, Lk] bool mask shared across the heads;
masked scores get no weight, so a fully masked row gives 0.

A CPU tensor goes through :func:`flash_attention_plain`; a CUDA tensor
launches the kernel or raises. The kernel's tile configuration (q rows and
keys per tile, stages of the K/V ring) is a function of the call's shape
(:func:`default_config`), chosen from the sweep of
``hunyuan3d2_tpu_torch.tools.profile_flash_variants``. The masked kernel
walks only the key tiles that hold an allowed pair; the wrapper finds them
on the device (:func:`tile_map`), without a host synchronisation.

The unmasked kernel has a gradient (:class:`_FlashAttentionFn`): its
backward is the gradient of :func:`flash_attention_plain`, recomputed from
the saved q, k, v (the JAX package has no backward kernel either: its
training runs through the plain attention). The masked kernel has none;
its wrapper refuses inputs that require a gradient while grad mode is on
(:func:`refuse_grad`), as do those of the geo decoder's chain, the
rasterizer and the tile-sweep variants, so no gradient is dropped without
a word.
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


def flash_attention_masked_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                 mask: torch.Tensor, scale: Optional[float] = None) -> torch.Tensor:
    """The masked kernel's function in plain PyTorch: scale folded into q in
    the input dtype, fp32 logits, p = exp(s - max) over the allowed keys and
    0 elsewhere, p rounded to the input dtype before the P·V product, the
    sum divided by max(l, 1e-30) after it (so a fully masked row is 0)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    qs = (q.float() * scale).to(q.dtype)
    logits = torch.einsum("bhqd,bhkd->bhqk", qs.float(), k.float())
    allowed = mask[:, None]
    logits = torch.where(allowed, logits, -1e30)
    p = torch.where(allowed, torch.exp(logits - logits.amax(-1, keepdim=True)), 0.0)
    l = p.sum(-1, keepdim=True)
    out = torch.einsum("bhqk,bhkd->bhqd", p.to(q.dtype).float(), v.float())
    return (out / l.clamp_min(1e-30)).to(q.dtype)


def refuse_grad(name: str, *tensors) -> None:
    """Raise when grad mode is on and one of ``tensors`` (None skipped)
    requires a gradient: the kernel ``name`` has no backward, and its output
    would carry none."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(f"{name} has no gradient: call it under torch.no_grad(), or on "
                           "inputs that do not require grad")


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
    if q.is_cuda and any(x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError("flash_attention takes 16-byte aligned q, k, v (TMA tiles)")


SM_COUNT = 132  # H100 SXM


def default_config(b: int, h: int, lq: int, lk: int, d: int, dtype: torch.dtype,
                   masked: bool = False) -> tuple:
    """The kernel's (q rows, keys, stages) per tile for a call's shape: fp32
    runs (64, 64, 2); the masked bf16 kernel (128, 128, 3) at D = 64 and
    (128, 128, 2) at D = 128 (what fits with the mask tiles); the unmasked
    bf16 kernel (128, 128, 3), or 64-row q tiles where 128-row tiles would
    give fewer CTAs than the card has SMs."""
    if dtype == torch.float32:
        return (64, 64, 2)
    if masked:
        return (128, 128, 3 if d == 64 else 2)
    if b * h * -(-lq // 128) < SM_COUNT:
        return (64, 128, 3)
    return (128, 128, 3)


def tile_map(mask: torch.Tensor, bq: int, bk: int) -> torch.Tensor:
    """[B, Lq, Lk] bool → [B, ceil(Lq/bq), ceil(Lk/bk)] uint8, 1 where the
    (q tile, key tile) holds an allowed pair. Plain reductions on the mask's
    device, no host synchronisation."""
    b, lq, lk = mask.shape
    nq, nk = -(-lq // bq), -(-lk // bk)
    m = mask.view(torch.uint8)
    if nq * bq != lq or nk * bk != lk:
        m = torch.nn.functional.pad(m, (0, nk * bk - lk, 0, nq * bq - lq))
    return m.view(b, nq, bq, nk, bk).amax(dim=(2, 4)).contiguous()


@functools.lru_cache(maxsize=None)
def _lib():
    """The kernel's C entry point, built and loaded at first use."""
    from hunyuan3d2_tpu_torch.utils import cuda_build

    lib = cuda_build.load("flash_attention")
    fn = lib.hy3d_flash_attention
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_float]
                   + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


class _FlashAttentionFn(torch.autograd.Function):
    """Kernel 1 under autograd. The forward launches the kernel (and counts
    the launch); the backward recomputes :func:`flash_attention_plain` from
    the saved q, k, v under grad mode and returns its gradients in the
    inputs' dtypes. The recompute holds the [B, H, Lq, Lk] fp32 scores: a
    caller with long sequences chunks its queries."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        ctx.save_for_backward(q, k, v)
        ctx.scale = scale
        out = _launch(q, k, v, None, scale)
        flash_attention.launches += 1
        return out

    @staticmethod
    def backward(ctx, grad_out):
        saved = ctx.saved_tensors
        needs = ctx.needs_input_grad[:3]
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(n) for t, n in zip(saved, needs)]
            out = flash_attention_plain(*inputs, ctx.scale)
            wanted = [t for t, n in zip(inputs, needs) if n]
            grads = iter(torch.autograd.grad(out, wanted, grad_out))
        return tuple(next(grads) if n else None for n in needs) + (None,)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q [B, H, Lq, D], k/v [B, H, Lk, D] → [B, H, Lq, D] in q.dtype,
    differentiable in q, k and v."""
    _check(q, k, v)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, scale)
    return _FlashAttentionFn.apply(q, k, v, scale)


def _launch(q, k, v, mask, scale):
    b, h, lq, d = q.shape
    lk = k.shape[2]
    bq, bk, stages = default_config(b, h, lq, lk, d, q.dtype, mask is not None)
    occupancy = None if mask is None else tile_map(mask, bq, bk)
    out = torch.empty_like(q)
    err = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 None if mask is None else mask.data_ptr(),
                 None if occupancy is None else occupancy.data_ptr(), out.data_ptr(), b * h, h,
                 lq, lk, d, _DTYPES[q.dtype], float(scale), bq, bk, stages,
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: cudaError {err}")
    return out


def flash_attention_masked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           mask: torch.Tensor, scale: Optional[float] = None) -> torch.Tensor:
    """q [B, H, Lq, D], k/v [B, H, Lk, D], mask [B, Lq, Lk] bool (True =
    attend, shared across heads) → [B, H, Lq, D] in q.dtype."""
    _check(q, k, v)
    b, _, lq, _ = q.shape
    if mask.dtype != torch.bool or tuple(mask.shape) != (b, lq, k.shape[2]):
        raise ValueError(f"flash_attention_masked takes a bool [B, Lq, Lk] mask "
                         f"{(b, lq, k.shape[2])}, got {mask.dtype} {tuple(mask.shape)}")
    if mask.device != q.device:
        raise ValueError("flash_attention_masked: mask lies on another device than q")
    refuse_grad("flash_attention_masked", q, k, v)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if not q.is_cuda:
        return flash_attention_masked_plain(q, k, v, mask, scale)
    # torch.bool is one byte of 0 or 1: the kernel reads it as uint8, by TMA
    # from a 16-byte aligned base
    mask = mask.contiguous()
    if mask.data_ptr() % 16:
        mask = mask.clone()
    out = _launch(q, k, v, mask, scale)
    flash_attention_masked.launches += 1
    return out


flash_attention.launches = 0
flash_attention_masked.launches = 0
