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
``hunyuan3d2_tpu_torch.tools.profile_flash_variants``. The fp32 kernels,
masked or not, run 3xTF32 products on tf32 ``wgmma``, which reads K-major
operands only: a pre-pass inside their entry points writes each operand's
TF32 big and small halves, transposed where a product reads it across rows
(:func:`split_operand_plain` is its twin); the wrappers allocate that
scratch. The masked kernels walk only the key tiles that hold an allowed
pair; the wrapper finds them on the device (:func:`tile_map`, at the
kernel's own tiles), without a host synchronisation.

The unmasked kernel has a gradient (:class:`_FlashAttentionFn`), written by
hand too: under a gradient the forward launches the kernel's instance that
also keeps each row's log-sum-exp, and the backward launches
``csrc/flash_attention_bwd.cu`` (:func:`flash_attention_backward`), which
recomputes the probabilities from it tile by tile and keeps no
[B, H, Lq, Lk] scores. Its plain twins are :func:`flash_attention_lse_plain`
and :func:`flash_attention_backward_plain` (the JAX package has no backward
kernel: its training differentiates the plain attention). The masked kernel
has none; its wrapper refuses inputs that require a gradient while grad
mode is on (:func:`refuse_grad`), as do those of the geo decoder's chain,
the rasterizer and the tile-sweep variants, so no gradient is dropped
without a word.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

_DTYPES = {torch.bfloat16: 0, torch.float32: 1}


def _scaled_logits(q: torch.Tensor, k: torch.Tensor, scale: float):
    """(qs, logits): q·scale in fp32 rounded to the input dtype (the q that
    the kernels' products use), and the fp32 logits qs·kᵀ."""
    qs = (q.float() * scale).to(q.dtype)
    return qs, torch.einsum("bhqd,bhkd->bhqk", qs.float(), k.float())


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: Optional[float] = None) -> torch.Tensor:
    """The kernel's function in plain PyTorch: scale folded into q in the
    input dtype, fp32 logits and softmax, probabilities rounded to the input
    dtype before the P·V product."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    _, logits = _scaled_logits(q, k, scale)
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", w.float(), v.float()).to(q.dtype)


def flash_attention_lse_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              scale: Optional[float] = None):
    """The forward that the gradient keeps, in plain PyTorch: (o, lse), o as
    :func:`flash_attention_plain` computes it and lse [B, H, Lq] fp32 the
    log-sum-exp of each row's logits (natural units)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    _, logits = _scaled_logits(q, k, scale)
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    o = torch.einsum("bhqk,bhkd->bhqd", w.float(), v.float()).to(q.dtype)
    return o, torch.logsumexp(logits, dim=-1)


def flash_attention_backward_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                   o: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
                                   scale: Optional[float] = None):
    """The backward kernel's algorithm in plain PyTorch, step by step: the
    gradient (dq, dk, dv), in q's dtype, of :func:`flash_attention_plain` at
    q, k, v for the output gradient ``dout``, from the forward's o and lse.
    P = exp(qs·kᵀ - lse) in fp32; dV = rnd(P)ᵀ·dO; dP = dO·vᵀ; δ = Σ_d dO∘o;
    dS = P∘(dP - δ), rounded to the input dtype as the tensor cores take it;
    dK = dSᵀ·qs; dq = scale·(dS·k), straight through the rounding of qs as
    the plain autograd goes. fp32 products; rnd rounds to the input dtype
    (nothing in fp32)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    dt = q.dtype
    qs, logits = _scaled_logits(q, k, scale)
    p = torch.exp(logits - lse[..., None])
    dv = torch.einsum("bhqk,bhqd->bhkd", p.to(dt).float(), dout.float())
    dp = torch.einsum("bhqd,bhkd->bhqk", dout.float(), v.float())
    delta = (dout.float() * o.float()).sum(-1, keepdim=True)
    ds = (p * (dp - delta)).to(dt).float()
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qs.float())
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k.float()) * scale
    return dq.to(dt), dk.to(dt), dv.to(dt)


def tf32_split_plain(x: torch.Tensor):
    """fp32 x → (big, small) with big + small = x bit for bit: the split that
    the fp32 kernels' pre-pass writes (csrc/hopper.cuh `split_tf32_exact`).
    big is x rounded to TF32 (10 mantissa bits; to nearest, ties away from
    zero, as cvt.rna; truncated where that would overflow), small = x - big,
    exact in fp32 (the tensor cores read its top 19 bits). inf and NaN give
    big = x; a value already in TF32 (±0 too) gives small = 0 of x's sign."""
    u = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    special = (u & 0x7F800000) == 0x7F800000
    b = (u + 0x1000) & 0xFFFFE000
    b = torch.where((b & 0x7F800000) == 0x7F800000, u & 0xFFFFE000, b)
    b = torch.where(special, u, b)

    def bits(v):
        return torch.where(v >= 2 ** 31, v - 2 ** 32, v).to(torch.int32).view(torch.float32)

    big = bits(b)
    small = torch.where((b == u) | special, bits(u & 0x80000000), x - big)
    return big, small


def _perm8(cols: int, device) -> torch.Tensor:
    """The key (or q row) that each column of a transposed operand holds:
    within each group of 8, position p < 4 holds 2p and p ≥ 4 holds
    2(p - 4) + 1 (csrc/flash_attention.cuh `perm8`)."""
    c = torch.arange(cols, device=device)
    p = c % 8
    return c - p + torch.where(p < 4, 2 * p, 2 * (p - 4) + 1)


def split_operand_plain(x: torch.Tensor, scale: float = 1.0, cols: Optional[int] = None):
    """The fp32 kernels' operand pre-pass in plain PyTorch: x [n, rows, D]
    fp32, y = x·scale in fp32 → (direct [2, n, rows, D], the big and small
    halves of y; transposed [2, n, D, cols] or None, the halves of yᵀ with
    the columns in :func:`_perm8` order and zeros past ``rows``; ``cols`` a
    multiple of 8 at least ``rows``)."""
    n, rows, d = x.shape
    y = x.float() * scale
    direct = torch.stack(tf32_split_plain(y))
    if cols is None:
        return direct, None
    yt = torch.zeros(n, d, cols, dtype=torch.float32, device=x.device)
    yt[:, :, :rows] = y.transpose(1, 2)
    yt = yt[:, :, _perm8(cols, x.device)]
    return direct, torch.stack(tf32_split_plain(yt))


def flash_attention_masked_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                 mask: torch.Tensor, scale: Optional[float] = None) -> torch.Tensor:
    """The masked kernel's function in plain PyTorch: scale folded into q in
    the input dtype, fp32 logits, p = exp(s - max) over the allowed keys and
    0 elsewhere, p rounded to the input dtype before the P·V product, the
    sum divided by max(l, 1e-30) after it (so a fully masked row is 0)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    _, logits = _scaled_logits(q, k, scale)
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


def _check_backward(q, o, lse, dout):
    if o.shape != q.shape or dout.shape != q.shape or o.dtype != q.dtype or dout.dtype != q.dtype:
        raise ValueError(f"flash_attention_backward takes o and dout of q's shape and dtype "
                         f"{tuple(q.shape)} {q.dtype}, got o {tuple(o.shape)} {o.dtype}, "
                         f"dout {tuple(dout.shape)} {dout.dtype}")
    if lse.shape != q.shape[:3] or lse.dtype != torch.float32:
        raise ValueError(f"flash_attention_backward takes an fp32 lse {tuple(q.shape[:3])}, "
                         f"got {lse.dtype} {tuple(lse.shape)}")
    if not all(x.device == q.device for x in (o, lse, dout)):
        raise ValueError("flash_attention_backward inputs lie on different devices")
    if not (o.is_contiguous() and lse.is_contiguous() and dout.is_contiguous()):
        raise ValueError("flash_attention_backward takes contiguous o, lse, dout")
    if q.is_cuda and any(x.data_ptr() % 16 for x in (o, lse, dout)):
        raise ValueError("flash_attention_backward takes 16-byte aligned o, lse, dout")


SM_COUNT = 132  # H100 SXM


def default_config(b: int, h: int, lq: int, lk: int, d: int, dtype: torch.dtype,
                   masked: bool = False) -> tuple:
    """The kernel's (q rows, keys, stages) per tile for a call's shape. fp32
    (the third number is the ring's slots): (128, 64, 4) at D = 64, or for
    the unmasked kernel 64-row q tiles with 6 slots where 128-row tiles
    would give fewer CTAs than the card has SMs (the masked kernel keeps
    one configuration a head size: its mask tiles ride in the even slots),
    and (64, 64, 2) at D = 128. bf16: the masked kernel (128, 128, 3) at D = 64
    and (128, 128, 2) at D = 128 (what fits with the mask tiles); the
    unmasked kernel (128, 128, 3), or 64-row q tiles where 128-row tiles
    would give fewer CTAs than the card has SMs."""
    few = b * h * -(-lq // 128) < SM_COUNT
    if dtype == torch.float32:
        if d == 128:
            return (64, 64, 2)
        return (64, 64, 6) if few and not masked else (128, 64, 4)
    if masked:
        return (128, 128, 3 if d == 64 else 2)
    return (64, 128, 3) if few else (128, 128, 3)


class BackwardConfig(NamedTuple):
    """The backward's launch sizes for a call: ``rows``, the q rows a step
    of its dK/dV pass; ``splits``, the splits of that pass's q range; and
    ``lq_pad``, the rows of the pre-pass's per-row statistics (lse·log2 e,
    δ), which every row of the dK/dV pass's last q tile and of the dQ pass's
    last CTA reads."""
    rows: int
    splits: int
    lq_pad: int


# What csrc/flash_attention_bwd.cu launches sets these, per dtype and head
# size: the dK/dV pass's keys a CTA and q rows a step, the multiple its
# statistics are padded to (the dQ pass's q rows a CTA), and the dK/dV
# pass's resident CTAs an SM (bf16: one 64-key consumer warpgroup, two
# CTAs; fp32: one, its split operands fill the shared memory). The entry
# point refuses sizes that do not suit its tiles.
_BWD_TILES = {(torch.bfloat16, 64): (64, 64, 128, 2), (torch.bfloat16, 128): (64, 64, 128, 2),
              (torch.float32, 64): (64, 32, 128, 1), (torch.float32, 128): (64, 32, 64, 1)}


def backward_config(b: int, h: int, lq: int, lk: int, d: int, dtype: torch.dtype) -> BackwardConfig:
    """The backward's launch sizes for a call's shape: the dK/dV pass's q
    range split by :func:`bwd_splits`, the statistics padded to the kernel's
    multiple."""
    keys, rows, pad, per_sm = _BWD_TILES[dtype, d]
    return BackwardConfig(rows, bwd_splits(b * h, lq, lk, keys, rows, per_sm),
                          -(-lq // pad) * pad)


def bwd_splits(n: int, lq: int, lk: int, keys: int, rows: int, per_sm: int) -> int:
    """The splits of the dK/dV pass's q range (``rows`` a step) for ``n``
    heads whose ``keys``-key CTAs, ``per_sm`` resident an SM, fall short of
    the SMs: about ``per_sm`` CTAs an SM, every split at least one q tile."""
    n_qt = -(-lq // rows)
    want = max(1, min(n_qt, -(-per_sm * SM_COUNT // (n * -(-lk // keys)))))
    per = -(-n_qt // want)
    return -(-n_qt // per)


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


def _entry(library: str, name: str, argtypes):
    from hunyuan3d2_tpu_torch.utils import cuda_build

    fn = getattr(cuda_build.load(library), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _lib():
    """The kernel's C entry point, built and loaded at first use."""
    return _entry("flash_attention", "hy3d_flash_attention",
                  [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_float]
                  + [ctypes.c_int] * 3 + [ctypes.c_void_p])


@functools.lru_cache(maxsize=None)
def _lse_lib():
    """The entry point of the kernel's instance that keeps the row lse."""
    return _entry("flash_attention", "hy3d_flash_attention_lse",
                  [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_float]
                  + [ctypes.c_int] * 3 + [ctypes.c_void_p])


@functools.lru_cache(maxsize=None)
def _split_lib():
    """The fp32 kernels' operand pre-pass on its own (csrc/flash_attention.cu)."""
    return _entry("flash_attention", "hy3d_split_operand",
                  [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p])


@functools.lru_cache(maxsize=None)
def _bwd_lib():
    """The backward's C entry point (csrc/flash_attention_bwd.cu)."""
    return _entry("flash_attention_bwd", "hy3d_flash_attention_bwd",
                  [ctypes.c_void_p] * 13 + [ctypes.c_int] * 6 + [ctypes.c_float]
                  + [ctypes.c_int, ctypes.c_void_p])


class _FlashAttentionFn(torch.autograd.Function):
    """Kernel 1 under autograd. The forward launches the kernel (and counts
    the launch): with ``keep`` (a gradient will be taken) its instance that
    also writes the row log-sum-exp, and saves q, k, v, o and lse. The
    backward launches the backward kernel on them (and counts it) and
    returns dq, dk, dv in the inputs' dtypes, None where no gradient is
    needed."""

    @staticmethod
    def forward(ctx, q, k, v, scale, keep):
        ctx.scale = scale
        if keep:
            out, lse = _launch_lse(q, k, v, scale)
            ctx.save_for_backward(q, k, v, out, lse)
        else:
            out = _launch(q, k, v, None, scale)
        flash_attention.launches += 1
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad_out):
        q, k, v, out, lse = ctx.saved_tensors
        grads = _launch_backward(q, k, v, out, lse, grad_out.contiguous(), ctx.scale)
        return tuple(g if n else None for g, n in zip(grads, ctx.needs_input_grad[:3])) + \
            (None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q [B, H, Lq, D], k/v [B, H, Lk, D] → [B, H, Lq, D] in q.dtype,
    differentiable in q, k and v."""
    _check(q, k, v)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, scale)
    return _on_card(q, k, v, scale)


def _on_card(q, k, v, scale):
    """flash_attention's branch for CUDA tensors: the forward keeps the row
    statistics only when a gradient will be taken (grad mode on and an
    input that requires one)."""
    keep = torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad)
    return _FlashAttentionFn.apply(q, k, v, scale, keep)


def flash_attention_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             o: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
                             scale: Optional[float] = None):
    """Kernel 1's gradient: q, k, v [B, H, L, D], the forward's o and lse
    [B, H, Lq] fp32 and the output gradient dout → (dq, dk, dv) in q.dtype.
    A CPU tensor goes through :func:`flash_attention_backward_plain`; a CUDA
    tensor launches the backward kernel or raises."""
    _check(q, k, v)
    _check_backward(q, o, lse, dout)
    refuse_grad("flash_attention_backward", q, k, v, o, dout)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if not q.is_cuda:
        return flash_attention_backward_plain(q, k, v, o, lse, dout, scale)
    return _launch_backward(q, k, v, o, lse, dout, scale)


def _key_pad(lk: int) -> int:
    """The row length of the fp32 kernels' transposed key operands: whole
    64-key tiles (csrc/flash_attention.cuh `key_pad`)."""
    return -(-lk // 64) * 64


def _forward_scratch(q, k):
    """The fp32 kernels' scratch (masked or not), which their pre-pass fills
    with K's and Vᵀ's split halves (2·n·Lk·D + 2·n·D·key_pad(Lk) floats);
    None for bf16."""
    if q.dtype != torch.float32:
        return None
    b, h, lk, d = k.shape
    return torch.empty(2 * b * h * d * (lk + _key_pad(lk)), dtype=torch.float32, device=q.device)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch(q, k, v, mask, scale):
    b, h, lq, d = q.shape
    lk = k.shape[2]
    bq, bk, stages = default_config(b, h, lq, lk, d, q.dtype, mask is not None)
    occupancy = None if mask is None else tile_map(mask, bq, bk)
    out = torch.empty_like(q)
    err = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(mask), _ptr(occupancy),
                 out.data_ptr(), _ptr(_forward_scratch(q, k)), b * h, h, lq, lk, d,
                 _DTYPES[q.dtype], float(scale), bq, bk, stages,
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: cudaError {err}")
    return out


def _launch_lse(q, k, v, scale):
    """The kernel's instance that keeps the row statistics → (o, lse)."""
    b, h, lq, d = q.shape
    lk = k.shape[2]
    bq, bk, stages = default_config(b, h, lq, lk, d, q.dtype)
    out = torch.empty_like(q)
    lse = torch.empty(b, h, lq, dtype=torch.float32, device=q.device)
    err = _lse_lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
                     _ptr(_forward_scratch(q, k)), b * h, lq, lk, d, _DTYPES[q.dtype],
                     float(scale), bq, bk, stages, torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention (lse) kernel launch failed: cudaError {err}")
    return out, lse


def split_operand(x: torch.Tensor, scale: float = 1.0, cols: Optional[int] = None):
    """The fp32 kernels' operand pre-pass on its own (they launch it inside
    their entry points; this wrapper serves the tests): x [n, rows, D] fp32,
    D in {64, 128} → (direct, transposed) as :func:`split_operand_plain`
    gives them, ``cols`` a multiple of 8 at least ``rows``. A CPU tensor
    goes through that twin; a CUDA tensor launches the kernel or raises."""
    n, rows, d = x.shape
    if x.dtype != torch.float32 or d not in (64, 128) or not x.is_contiguous():
        raise ValueError(f"split_operand takes a contiguous fp32 [n, rows, 64 or 128], got "
                         f"{x.dtype} {tuple(x.shape)}")
    if cols is not None and (cols % 8 or cols < rows):
        raise ValueError(f"split_operand: cols {cols} is not a multiple of 8 at least {rows}")
    if not x.is_cuda:
        return split_operand_plain(x, scale, cols)
    direct = torch.empty(2, n, rows, d, dtype=torch.float32, device=x.device)
    trans = None if cols is None else torch.empty(2, n, d, cols, dtype=torch.float32,
                                                  device=x.device)
    err = _split_lib()(x.data_ptr(), direct.data_ptr(), _ptr(trans), n, rows, cols or 0, d,
                       float(scale), torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"split_operand kernel launch failed: cudaError {err}")
    split_operand.launches += 1
    return direct, trans


def _launch_backward(q, k, v, o, lse, dout, scale):
    """The backward kernel's pre-pass and two passes → (dq, dk, dv), counted
    in ``flash_attention_backward.launches``; the scratch (qs, or fp32's
    split operands; δ, lse·log2 e; the split partial sums) is allocated
    here."""
    b, h, lq, d = q.shape
    lk = k.shape[2]
    n = b * h
    _, splits, lq_pad = backward_config(b, h, lq, lk, d, q.dtype)
    if q.dtype == torch.float32:  # the split operands (csrc/flash_attention_bwd.cu)
        qs = torch.empty(2 * n * d * (2 * lq + 2 * lq_pad + 2 * lk + _key_pad(lk)),
                         dtype=torch.float32, device=q.device)
    else:
        qs = torch.empty_like(q)
    stats = torch.empty(2, n, lq_pad, dtype=torch.float32, device=q.device)
    part = (torch.empty(2, splits, n, lk, d, dtype=torch.float32, device=q.device)
            if splits > 1 else None)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    err = _bwd_lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), dout.data_ptr(),
                     lse.data_ptr(), qs.data_ptr(), stats[0].data_ptr(), stats[1].data_ptr(),
                     None if part is None else part.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                     dv.data_ptr(), n, lq, lk, lq_pad, d, _DTYPES[q.dtype], float(scale), splits,
                     torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_backward kernel launch failed: cudaError {err}")
    flash_attention_backward.launches += 1
    return dq, dk, dv


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
flash_attention_backward.launches = 0
flash_attention_masked.launches = 0
split_operand.launches = 0
