"""Fused ShapeVAE geo decoder: the hand-written Hopper kernel and its plain twin.

Port of hunyuan3d2_tpu/ops/geo_decoder_pallas.py ``fused_geo_decode`` (the
Pallas kernel ``_kernel``). The CUDA source is ``csrc/geo_decode.cu``; its
header says how it is laid out and what bounds it on the H100.

:func:`decode_queries_plain` is the same function in plain PyTorch, in the op
order of hunyuan3d2_tpu/models/shapevae.py ``decode_queries`` run on bf16
K/V. :func:`fused_geo_decode` takes it for CPU tensors; for CUDA tensors it
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from hunyuan3d2_tpu_torch.ops.attention import merge_heads, sdpa
from hunyuan3d2_tpu_torch.ops.embeddings import fourier_embed
from hunyuan3d2_tpu_torch.ops.nn import gelu_exact, layer_norm

EMB_PAD = 64


def fused_geo_supported(cfg) -> bool:
    """The JAX package's shape gate for the fused decoder (shapevae.py:204-206)."""
    return (cfg.num_latents <= 1024 and cfg.width % 128 == 0
            and (cfg.geo_decoder_mlp_expand_ratio * cfg.width) % 512 == 0
            and cfg.head_dim in (64, 128) and cfg.out_channels == 1)


def decode_queries_plain(vae, queries: torch.Tensor, k: torch.Tensor,
                         v: torch.Tensor) -> torch.Tensor:
    """queries [B, P, 3] fp32, k/v [B, H, L, D] (k LayerNorm applied) →
    [B, P] logits, in k's dtype. Activations run in k's dtype."""
    cfg = vae.cfg
    g = vae.geo_decoder
    blk = g.cross_attn_decoder
    q_in = fourier_embed(queries, cfg.num_freqs, cfg.include_pi).to(k.dtype)
    x = g.query_proj(q_in)
    q = blk.attn.c_q(blk.ln_1(x))
    b, p, _ = q.shape
    q = blk.attn.attention.q_norm(q.reshape(b, p, cfg.heads, cfg.head_dim)).transpose(1, 2)
    x = x + blk.attn.c_proj(merge_heads(sdpa(q, k, v)))
    x = x + blk.mlp.c_proj(gelu_exact(blk.mlp.c_fc(blk.ln_3(x))))
    x = layer_norm(x, g.ln_post.weight, g.ln_post.bias)
    return g.output_proj(x)[..., 0]


class _GeoArgs(ctypes.Structure):
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "pts", "wqp", "bqp", "ln1s", "ln1b", "wcq", "bcq", "qns", "qnb", "k", "v", "wcp",
        "bcp", "ln3s", "ln3b", "wfc", "bfc", "wpj", "bpj", "lnps", "lnpb", "wout", "out")]
    _fields_ += [(n, ctypes.c_int) for n in ("P", "W", "H", "D", "L", "M", "num_freqs")]
    _fields_ += [(n, ctypes.c_float) for n in ("freq_mul", "eps", "scale", "bout")]


def _operands(vae, device):
    """The kernel's weight operands: bf16 matrices in torch [out, in]
    layout, fp32 vectors; query_proj zero-padded to 64 input columns."""
    g = vae.geo_decoder
    blk = g.cross_attn_decoder
    w = vae.cfg.width
    bf, f32 = torch.bfloat16, torch.float32

    def mat(lin):
        return lin.weight.detach().to(device, bf).contiguous()

    def vec(t, n=w):
        if t is None:
            return torch.zeros(n, dtype=f32, device=device)
        return t.detach().to(device, f32).contiguous()

    qp = g.query_proj.weight.detach()
    wqp = torch.zeros(w, EMB_PAD, dtype=bf, device=device)
    wqp[:, :qp.shape[1]] = qp.to(bf)
    return dict(
        wqp=wqp, bqp=vec(g.query_proj.bias), ln1s=vec(blk.ln_1.weight), ln1b=vec(blk.ln_1.bias),
        wcq=mat(blk.attn.c_q), bcq=vec(blk.attn.c_q.bias),
        qns=vec(blk.attn.attention.q_norm.weight), qnb=vec(blk.attn.attention.q_norm.bias),
        wcp=mat(blk.attn.c_proj), bcp=vec(blk.attn.c_proj.bias),
        ln3s=vec(blk.ln_3.weight), ln3b=vec(blk.ln_3.bias),
        wfc=mat(blk.mlp.c_fc), bfc=vec(blk.mlp.c_fc.bias, blk.mlp.c_fc.out_features),
        wpj=mat(blk.mlp.c_proj), bpj=vec(blk.mlp.c_proj.bias),
        lnps=vec(g.ln_post.weight), lnpb=vec(g.ln_post.bias),
        wout=g.output_proj.weight.detach().to(device, bf).reshape(-1).contiguous(),
    )


@functools.lru_cache(maxsize=None)
def _lib():
    """The kernel's C entry point, built and loaded at first use."""
    from hunyuan3d2_tpu_torch.utils import cuda_build

    fn = cuda_build.load("geo_decode").hy3d_geo_decode
    fn.argtypes = [ctypes.POINTER(_GeoArgs), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(vae, queries, k, v):
    cfg = vae.cfg
    if not fused_geo_supported(cfg):
        raise ValueError(f"fused_geo_decode does not take this VAE config: {cfg}")
    if queries.dim() != 3 or queries.shape[0] != 1 or queries.shape[2] != 3:
        raise ValueError(f"fused_geo_decode takes queries [1, P, 3], got {tuple(queries.shape)}")
    want = (1, cfg.heads, k.shape[2], cfg.head_dim)
    if tuple(k.shape) != want or tuple(v.shape) != want or k.shape[2] % 16:
        raise ValueError(f"fused_geo_decode takes k/v [1, {cfg.heads}, L, {cfg.head_dim}] "
                         f"with L % 16 == 0, got {tuple(k.shape)}, {tuple(v.shape)}")
    if queries.dtype != torch.float32 or k.dtype != torch.bfloat16 or v.dtype != torch.bfloat16:
        raise TypeError("fused_geo_decode takes fp32 queries and bf16 k/v")
    if not (queries.device == k.device == v.device):
        raise ValueError("fused_geo_decode inputs lie on different devices")
    if not (queries.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("fused_geo_decode takes contiguous queries, k, v")


def fused_geo_decode(vae, queries: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """queries [1, P, 3] fp32 + bf16 k/v [1, H, L, D] → [1, P] fp32 logits."""
    _check(vae, queries, k, v)
    if not queries.is_cuda:
        return decode_queries_plain(vae, queries, k, v).float()
    cfg = vae.cfg
    p = queries.shape[1]
    ops = _operands(vae, queries.device)
    out = torch.empty(1, p, dtype=torch.float32, device=queries.device)
    bout = vae.geo_decoder.output_proj.bias
    args = _GeoArgs(
        pts=queries.data_ptr(), k=k.data_ptr(), v=v.data_ptr(), out=out.data_ptr(),
        P=p, W=cfg.width, H=cfg.heads, D=cfg.head_dim, L=k.shape[2],
        M=cfg.geo_decoder_mlp_expand_ratio * cfg.width, num_freqs=cfg.num_freqs,
        freq_mul=math.pi if cfg.include_pi else 1.0, eps=cfg.ln_eps,
        scale=cfg.head_dim ** -0.5, bout=0.0 if bout is None else float(bout.float()),
        **{name: t.data_ptr() for name, t in ops.items()})
    err = _lib()(ctypes.byref(args), torch.cuda.current_stream(queries.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_geo_decode kernel launch failed: cudaError {err}")
    fused_geo_decode.launches += 1
    return out


fused_geo_decode.launches = 0
