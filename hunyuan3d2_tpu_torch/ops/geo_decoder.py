"""ShapeVAE geo decoders on the card: the fused decoder (<= 1024 latents), the
streamed decode (> 1024 latents) with its MLP-tail kernel, and their plain
twins.

Port of hunyuan3d2_tpu/ops/geo_decoder_pallas.py ``fused_geo_decode`` (the
Pallas kernel ``_kernel``) and ``fused_geo_decode_stream`` (the Pallas kernel
``_geo_mlp_kernel``). Both CUDA kernels are in ``csrc/geo_decode.cu``; its
header says how they are laid out and what bounds them on the H100.

:func:`decode_queries_plain` is the fused decoder's function in plain
PyTorch, in the op order of hunyuan3d2_tpu/models/shapevae.py
``decode_queries`` run on bf16 K/V; :func:`geo_mlp_tail_plain` is the MLP
tail's. Each kernel wrapper takes its plain twin for CPU tensors; for CUDA
tensors it launches the kernel or raises.

The streamed decode's projections and attention are not one kernel, as in
the JAX package: :func:`geo_stream_x2` runs the projections as matrix
products (cuBLAS on the card) and the attention through
``ops.attention.attention`` (the flash kernel on the card, ``sdpa`` on the
CPU), and :func:`geo_mlp_tail` finishes. Products with bf16 inputs keep an
fp32 result in the JAX package; here they are the same on both devices:
fp32 GEMMs of the bf16 values, whose products are exact (TF32 tensor cores
on the card, see :func:`_mm32`).

The MLP-tail kernel takes widths up to ``MAX_TAIL_WIDTH`` (1152): its 32-row
tile of the fp32 residual and the bf16 LN3 output fills one block's shared
memory. The stream's gate is the JAX package's and does not test this, so
:func:`geo_mlp_tail` refuses a wider config that passes the gate with a
ValueError that names the limit. Every config in the repo is at most 1024
wide.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch
import torch.nn.functional as F

from hunyuan3d2_tpu_torch.ops.attention import attention, merge_heads, sdpa
from hunyuan3d2_tpu_torch.ops.embeddings import fourier_embed
from hunyuan3d2_tpu_torch.ops.nn import gelu_exact, layer_norm

EMB_PAD = 64
MAX_TAIL_WIDTH = 1152   # the MLP-tail kernel's 32-row tile fills one block's shared memory


def fused_geo_supported(cfg) -> bool:
    """The JAX package's shape gate for the fused decoder (shapevae.py:204-206)."""
    return (cfg.num_latents <= 1024 and cfg.width % 128 == 0
            and (cfg.geo_decoder_mlp_expand_ratio * cfg.width) % 512 == 0
            and cfg.head_dim in (64, 128) and cfg.out_channels == 1)


def fused_geo_stream_supported(cfg) -> bool:
    """The JAX package's shape gate for the streamed decode (shapevae.py:221-224).
    It does not test the MLP-tail kernel's width limit (``MAX_TAIL_WIDTH``):
    :func:`geo_mlp_tail` refuses a config wider than that."""
    return (cfg.num_latents > 1024 and cfg.num_latents % 256 == 0
            and cfg.width % 128 == 0
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


# ---------------------------------------------------------------------------
# the streamed decode (> 1024 latents) and its MLP-tail kernel
# ---------------------------------------------------------------------------
def _mm32(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a · wᵀ with bf16 inputs and an fp32 result: the products are exact in
    fp32, so this is the JAX package's ``preferred_element_type=f32`` up to
    the order of the sums. On the card the product runs on TF32 tensor cores,
    which hold a bf16 value exactly, so TF32 changes no bit of a product; the
    flag is CUDA's alone and is put back after the call."""
    flags = torch.backends.cuda.matmul
    old, flags.allow_tf32 = flags.allow_tf32, True
    try:
        return F.linear(a.float(), w.float())
    finally:
        flags.allow_tf32 = old


def _proj(a: torch.Tensor, lin) -> torch.Tensor:
    """bf16 ``a`` through the Linear ``lin`` → fp32, exact products."""
    y = _mm32(a, lin.weight)
    return y if lin.bias is None else y.add_(lin.bias.float())


def geo_stream_x2(vae, queries: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The streamed decode up to the MLP tail, in the op order of
    geo_decoder_pallas.py:340-375: queries [1, P, 3] fp32 + bf16 k/v
    [1, H, L, D] (k LayerNorm applied) → x2 = x + c_proj(attn) [1, P, W],
    rounded to bf16. The fp32 [P, W] intermediates are freed as soon as the
    next stage has read them, and c_proj's output is added into x in place."""
    cfg = vae.cfg
    g = vae.geo_decoder
    blk = g.cross_attn_decoder
    bf = torch.bfloat16
    p = queries.shape[1]
    x = _proj(fourier_embed(queries, cfg.num_freqs, cfg.include_pi).to(bf), g.query_proj)
    qm = _proj(blk.ln_1(x).to(bf), blk.attn.c_q)
    qh = blk.attn.attention.q_norm(qm.reshape(1, p, cfg.heads, cfg.head_dim))
    del qm
    q4 = qh.transpose(1, 2).to(bf).contiguous()
    del qh
    o = merge_heads(attention(q4, k, v))
    del q4
    x += _proj(o, blk.attn.c_proj)
    del o
    return x.to(bf)


def geo_mlp_tail_plain(vae, x2: torch.Tensor) -> torch.Tensor:
    """The MLP-tail kernel's function (geo_decoder_pallas.py:274-296) in plain
    PyTorch: x2 [1, P, W] bf16 → [1, P] fp32 logits. h = bf16(LN3(x2)); the
    residual acc = x2 + b_proj stays fp32; the 4W exact-GELU MLP with bf16
    inputs and fp32 products (GELU output rounded to bf16) is added into it;
    ln_post is rounded to bf16 and dotted with the output weights in fp32."""
    cfg = vae.cfg
    g = vae.geo_decoder
    blk = g.cross_attn_decoder
    bf = torch.bfloat16
    x = x2.float()
    h = layer_norm(x, blk.ln_3.weight, blk.ln_3.bias, cfg.ln_eps).to(bf)
    if blk.mlp.c_proj.bias is not None:
        x += blk.mlp.c_proj.bias.float()
    t = _mm32(h, blk.mlp.c_fc.weight)
    del h
    if blk.mlp.c_fc.bias is not None:
        t += blk.mlp.c_fc.bias.float()
    x += _mm32(gelu_exact(t).to(bf), blk.mlp.c_proj.weight)
    del t
    x3 = layer_norm(x, g.ln_post.weight, g.ln_post.bias, cfg.ln_eps).to(bf)
    out = _mm32(x3, g.output_proj.weight)[..., 0]
    bias = g.output_proj.bias
    return out if bias is None else out + bias.float()


class _MlpArgs(ctypes.Structure):
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "x2", "ln3s", "ln3b", "wfc", "bfc", "wpj", "bpj", "lnps", "lnpb", "wout", "out")]
    _fields_ += [(n, ctypes.c_int) for n in ("P", "W", "M")]
    _fields_ += [(n, ctypes.c_float) for n in ("eps", "bout")]


@functools.lru_cache(maxsize=None)
def _lib_mlp():
    """The MLP-tail kernel's C entry point (same library as the fused decoder)."""
    from hunyuan3d2_tpu_torch.utils import cuda_build

    fn = cuda_build.load("geo_decode").hy3d_geo_mlp
    fn.argtypes = [ctypes.POINTER(_MlpArgs), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check_tail_width(cfg):
    if cfg.width > MAX_TAIL_WIDTH:
        raise ValueError(f"the MLP-tail kernel does not take W > {MAX_TAIL_WIDTH}, "
                         f"got W = {cfg.width}")


def _check_tail(vae, x2):
    cfg = vae.cfg
    m = cfg.geo_decoder_mlp_expand_ratio * cfg.width
    _check_tail_width(cfg)
    if cfg.width % 128 or m % 64 or cfg.out_channels != 1:
        raise ValueError(f"geo_mlp_tail does not take this VAE config: {cfg}")
    if x2.dim() != 3 or x2.shape[0] != 1 or x2.shape[2] != cfg.width:
        raise ValueError(f"geo_mlp_tail takes x2 [1, P, {cfg.width}], got {tuple(x2.shape)}")
    if x2.dtype != torch.bfloat16:
        raise TypeError(f"geo_mlp_tail takes bf16 x2, got {x2.dtype}")
    if not x2.is_contiguous() or x2.data_ptr() % 16:
        raise ValueError("geo_mlp_tail takes a contiguous, 16-byte aligned x2")


def geo_mlp_tail(vae, x2: torch.Tensor) -> torch.Tensor:
    """x2 [1, P, W] bf16 → [1, P] fp32 logits: the MLP-tail kernel on a CUDA
    tensor, :func:`geo_mlp_tail_plain` on a CPU tensor."""
    _check_tail(vae, x2)
    if not x2.is_cuda:
        return geo_mlp_tail_plain(vae, x2)
    cfg = vae.cfg
    p = x2.shape[1]
    ops = _operands(vae, x2.device)
    out = torch.empty(1, p, dtype=torch.float32, device=x2.device)
    bout = vae.geo_decoder.output_proj.bias
    args = _MlpArgs(
        x2=x2.data_ptr(), out=out.data_ptr(), P=p, W=cfg.width,
        M=cfg.geo_decoder_mlp_expand_ratio * cfg.width, eps=cfg.ln_eps,
        bout=0.0 if bout is None else float(bout.float()),
        **{n: ops[n].data_ptr() for n in (
            "ln3s", "ln3b", "wfc", "bfc", "wpj", "bpj", "lnps", "lnpb", "wout")})
    err = _lib_mlp()(ctypes.byref(args), torch.cuda.current_stream(x2.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"geo_mlp_tail kernel launch failed: cudaError {err}")
    geo_mlp_tail.launches += 1
    return out


geo_mlp_tail.launches = 0


def fused_geo_decode_stream(vae, queries: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor) -> torch.Tensor:
    """queries [1, P, 3] fp32 + bf16 k/v [1, H, L, D] → [1, P] fp32 logits:
    :func:`geo_stream_x2`, then :func:`geo_mlp_tail`."""
    cfg = vae.cfg
    if not fused_geo_stream_supported(cfg):
        raise ValueError(f"fused_geo_decode_stream does not take this VAE config: {cfg}")
    _check_tail_width(cfg)
    if queries.dim() != 3 or queries.shape[0] != 1 or queries.shape[2] != 3:
        raise ValueError(f"fused_geo_decode_stream takes queries [1, P, 3], "
                         f"got {tuple(queries.shape)}")
    want = (1, cfg.heads, k.shape[2], cfg.head_dim)
    if tuple(k.shape) != want or tuple(v.shape) != want:
        raise ValueError(f"fused_geo_decode_stream takes k/v [1, {cfg.heads}, L, "
                         f"{cfg.head_dim}], got {tuple(k.shape)}, {tuple(v.shape)}")
    if queries.dtype != torch.float32 or k.dtype != torch.bfloat16 or v.dtype != torch.bfloat16:
        raise TypeError("fused_geo_decode_stream takes fp32 queries and bf16 k/v")
    if not (queries.device == k.device == v.device):
        raise ValueError("fused_geo_decode_stream inputs lie on different devices")
    return geo_mlp_tail(vae, geo_stream_x2(vae, queries, k, v))
