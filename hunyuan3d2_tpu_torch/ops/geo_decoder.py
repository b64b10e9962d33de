"""ShapeVAE geo decoders on the card: kernel 3 (the fused decoder, <= 1024
latents), the streamed decode (> 1024 latents) with kernel 4 (its MLP
tail), and their plain twins.

Port of hunyuan3d2_tpu/ops/geo_decoder_pallas.py ``fused_geo_decode`` (the
Pallas kernel ``_kernel``) and ``fused_geo_decode_stream`` (the Pallas
kernel ``_geo_mlp_kernel``). On the card both run as one chain of
hand-written kernels (``csrc/geo_decode.cu``; its header says how they are
laid out and what bounds them on the H100) and kernel 1 for the attention:

* the front, :func:`_front`: Fourier embedding (plain, as in the JAX
  package) → x = qe · Wqpᵀ + bqp, fp32 (:func:`gemm_residual`) →
  h1 = bf16(LN1(x)) (:func:`ln_rows`) → q = bf16(per-head LN(h1 · Wcqᵀ +
  bcq)) as [H, P, D] (:func:`gemm_head_ln`) → kernel 1 → x2 = x + o · Wcpᵀ
  + bcp (:func:`gemm_residual`, reading o per head);
* the tail, :func:`_tail`: h = bf16(LN3(x2)) (:func:`ln_rows`) →
  T = bf16(gelu(h · Wfcᵀ + bfc)) (:func:`gemm_gelu`) → y = x2 + bpj +
  T · Wpjᵀ, fp32 (:func:`gemm_residual`) → bf16(LN_post(y)) · wout + bout
  (:func:`ln_dot_rows`).

Kernel 3 keeps x2 in fp32, as its Pallas kernel does; the stream rounds x2
to bf16, as the JAX stream does (geo_decoder_pallas.py:375). Every product
has bf16 inputs and an fp32 sum; every rounding point is the Pallas
kernels'.

Each kernel wrapper takes its plain twin (``*_plain``) for CPU tensors; for
CUDA tensors it launches its kernel or raises. :func:`geo_decode_plain` and
:func:`geo_mlp_tail_plain` compose the plain twins as the card composes the
kernels, with the Pallas kernel's exact softmax (:func:`sdpa`) in place of
kernel 1's online one. :func:`decode_queries_plain` is the dense decode of
the JAX package's ``decode_queries`` (bf16 residual), which the VAE takes
where no kernel fits. The plain products are fp32 GEMMs of the bf16
values, whose products are exact (TF32 tensor cores on the card, see
:func:`_mm32`).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from hunyuan3d2_tpu_torch.ops.attention import merge_heads, sdpa
from hunyuan3d2_tpu_torch.ops.embeddings import fourier_embed
from hunyuan3d2_tpu_torch.ops.flash_attention import flash_attention
from hunyuan3d2_tpu_torch.ops.nn import gelu_exact, layer_norm

EMB_PAD = 64
_DTYPES = {None: 0, torch.bfloat16: 1, torch.float32: 2}   # the kernels' dtype codes


def fused_geo_supported(cfg) -> bool:
    """The JAX package's shape gate for the fused decoder (shapevae.py:204-206)."""
    return (cfg.num_latents <= 1024 and cfg.width % 128 == 0
            and (cfg.geo_decoder_mlp_expand_ratio * cfg.width) % 512 == 0
            and cfg.head_dim in (64, 128) and cfg.out_channels == 1)


def fused_geo_stream_supported(cfg) -> bool:
    """The JAX package's shape gate for the streamed decode (shapevae.py:221-224)."""
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


# ---------------------------------------------------------------------------
# the kernels' weight operands, cached per VAE
# ---------------------------------------------------------------------------
def _operands(vae, device) -> dict:
    """The kernels' weight operands: bf16 matrices in torch [out, in]
    layout, fp32 vectors, query_proj zero-padded to 64 input columns, the
    output bias as a one-element fp32 tensor (read on the device, never by
    the host). Built once per VAE and device, and again when a parameter of
    the geo decoder changes (its storage or its version counter, which an
    in-place update such as ``load_state_dict`` bumps)."""
    g = vae.geo_decoder
    key = (str(device),) + tuple((p.data_ptr(), p._version) for p in g.parameters())
    cached = getattr(vae, "_geo_operands", None)
    if cached is not None and cached[0] == key:
        return cached[1]
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
    wqp[:, :qp.shape[1]] = qp.to(device, bf)
    qn = blk.attn.attention.q_norm
    ops = dict(
        wqp=wqp, bqp=vec(g.query_proj.bias), ln1s=vec(blk.ln_1.weight), ln1b=vec(blk.ln_1.bias),
        wcq=mat(blk.attn.c_q), bcq=vec(blk.attn.c_q.bias),
        qns=vec(qn.weight, vae.cfg.head_dim), qnb=vec(qn.bias, vae.cfg.head_dim),
        wcp=mat(blk.attn.c_proj), bcp=vec(blk.attn.c_proj.bias),
        ln3s=vec(blk.ln_3.weight), ln3b=vec(blk.ln_3.bias),
        wfc=mat(blk.mlp.c_fc), bfc=vec(blk.mlp.c_fc.bias, blk.mlp.c_fc.out_features),
        wpj=mat(blk.mlp.c_proj), bpj=vec(blk.mlp.c_proj.bias),
        lnps=vec(g.ln_post.weight), lnpb=vec(g.ln_post.bias),
        wout=g.output_proj.weight.detach().to(device, bf).reshape(-1).contiguous(),
        bout=vec(g.output_proj.bias, 1),
    )
    vae._geo_operands = (key, ops)
    return ops


# ---------------------------------------------------------------------------
# the kernels (csrc/geo_decode.cu) and their plain twins
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


@functools.lru_cache(maxsize=None)
def _lib():
    """The kernels' C entry points, built and loaded at first use."""
    from hunyuan3d2_tpu_torch.utils import cuda_build

    lib = cuda_build.load("geo_decode")
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.hy3d_gemm.argtypes = [i32] * 4 + [ptr, i32] + [ptr] * 6 + [i32] * 3 + [f32, ptr]
    lib.hy3d_gemm.restype = i32
    lib.hy3d_ln_rows.argtypes = [i32, i32] + [ptr] * 7 + [i32, i32, f32, ptr]
    lib.hy3d_ln_rows.restype = i32
    return lib


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


def _check_vec(name, t, n, device):
    if t.dtype != torch.float32 or tuple(t.shape) != (n,) or not t.is_contiguous():
        raise ValueError(f"{name} takes a contiguous fp32 [{n}] vector, got {t.dtype} "
                         f"{tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name}: a vector lies on another device than the rows")


def _check_aligned(name, *ts):
    if any(t.is_cuda and t.data_ptr() % 16 for t in ts):
        raise ValueError(f"{name} takes 16-byte aligned tensors (TMA tiles, vector loads)")


# ---- LayerNorm rows --------------------------------------------------------
def _check_rows(name, x, scale, bias):
    if x.dim() != 2 or x.dtype not in (torch.bfloat16, torch.float32) or not x.is_contiguous():
        raise ValueError(f"{name} takes contiguous bf16 or fp32 rows [P, W], got {x.dtype} "
                         f"{tuple(x.shape)}")
    if x.shape[0] < 1 or x.shape[1] % 128:
        raise ValueError(f"{name} takes P >= 1 rows of a width W % 128 == 0, got "
                         f"{tuple(x.shape)}")
    _check_vec(name, scale, x.shape[1], x.device)
    _check_vec(name, bias, x.shape[1], x.device)
    _check_aligned(name, x, scale, bias)


def ln_rows_plain(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                  eps: float) -> torch.Tensor:
    """bf16(LN(x) · scale + bias) over the rows of x [P, W] (fp32 statistics)."""
    return layer_norm(x.float(), scale, bias, eps).to(torch.bfloat16)


def ln_rows(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float) -> torch.Tensor:
    """x [P, W] bf16 or fp32 → bf16 [P, W]: the row kernel on a CUDA tensor,
    :func:`ln_rows_plain` on a CPU tensor."""
    _check_rows("ln_rows", x, scale, bias)
    if not x.is_cuda:
        return ln_rows_plain(x, scale, bias, eps)
    y = torch.empty(x.shape, dtype=torch.bfloat16, device=x.device)
    _raise_on(_lib().hy3d_ln_rows(_DTYPES[x.dtype], 0, x.data_ptr(), scale.data_ptr(),
                                  bias.data_ptr(), y.data_ptr(), None, None, None, x.shape[0],
                                  x.shape[1], eps, _stream(x)), "ln_rows")
    ln_rows.launches += 1
    return y


def ln_dot_rows_plain(y: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                      wout: torch.Tensor, bout: torch.Tensor, eps: float) -> torch.Tensor:
    """bf16(LN(y) · scale + bias) · wout + bout over the rows of y [P, W]
    → fp32 [P], the dot in fp32."""
    return _mm32(ln_rows_plain(y, scale, bias, eps), wout[None])[:, 0] + bout


def ln_dot_rows(y: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, wout: torch.Tensor,
                bout: torch.Tensor, eps: float) -> torch.Tensor:
    """y [P, W] fp32 → fp32 [P]: ln_post and the one-channel output, the row
    kernel on a CUDA tensor, :func:`ln_dot_rows_plain` on a CPU tensor."""
    _check_rows("ln_dot_rows", y, scale, bias)
    if y.dtype != torch.float32:
        raise ValueError(f"ln_dot_rows takes fp32 rows, got {y.dtype}")
    if wout.dtype != torch.bfloat16 or tuple(wout.shape) != (y.shape[1],) or wout.device != y.device:
        raise ValueError(f"ln_dot_rows takes bf16 wout [{y.shape[1]}] on the rows' device")
    _check_vec("ln_dot_rows", bout, 1, y.device)
    _check_aligned("ln_dot_rows", wout)
    if not y.is_cuda:
        return ln_dot_rows_plain(y, scale, bias, wout, bout, eps)
    out = torch.empty(y.shape[0], dtype=torch.float32, device=y.device)
    _raise_on(_lib().hy3d_ln_rows(2, 1, y.data_ptr(), scale.data_ptr(), bias.data_ptr(), None,
                                  wout.data_ptr(), bout.data_ptr(), out.data_ptr(), y.shape[0],
                                  y.shape[1], eps, _stream(y)), "ln_dot_rows")
    ln_dot_rows.launches += 1
    return out


# ---- the GEMM template -----------------------------------------------------
def _as_rows(a: torch.Tensor) -> torch.Tensor:
    """[P, K], or kernel 1's per-head [H, P, D] output read as [P, H · D]."""
    return a if a.dim() == 2 else a.transpose(0, 1).reshape(a.shape[1], -1)


def _check_gemm(name, a, w, bias):
    if a.dim() not in (2, 3) or a.dtype != torch.bfloat16 or not a.is_contiguous():
        raise ValueError(f"{name} takes a contiguous bf16 A [P, K] or [H, P, D], got "
                         f"{a.dtype} {tuple(a.shape)}")
    rows, k = (a.shape[0], a.shape[1]) if a.dim() == 2 else (a.shape[1], a.shape[0] * a.shape[2])
    if w.dim() != 2 or w.dtype != torch.bfloat16 or not w.is_contiguous() or w.shape[1] != k:
        raise ValueError(f"{name} takes a contiguous bf16 B [N, {k}], got {w.dtype} "
                         f"{tuple(w.shape)}")
    n = w.shape[0]
    if rows < 1 or k % 64 or n % 8 or (a.dim() == 3 and a.shape[2] % 64):
        raise ValueError(f"{name} takes P >= 1, K % 64 == 0 (and D % 64 == 0 for [H, P, D]), "
                         f"N % 8 == 0; got A {tuple(a.shape)}, B {tuple(w.shape)}")
    if w.device != a.device:
        raise ValueError(f"{name}: A and B lie on different devices")
    _check_vec(name, bias, n, a.device)
    _check_aligned(name, a, w)
    return rows, n, k


def _launch_gemm(epi, a, w, bias, out, rows, resid=None, ln=(None, None), head_dim=0, eps=0.0):
    """hy3d_gemm: epilogue ``epi`` (0 E1, 1 E2, 2 E3) of A · Bᵀ into ``out``."""
    a_inner = a.shape[1] if a.dim() == 2 else a.shape[2]
    _raise_on(_lib().hy3d_gemm(
        epi, head_dim, _DTYPES[None if resid is None else resid.dtype], _DTYPES[out.dtype],
        a.data_ptr(), a_inner, w.data_ptr(), bias.data_ptr(),
        None if resid is None else resid.data_ptr(), None if ln[0] is None else ln[0].data_ptr(),
        None if ln[1] is None else ln[1].data_ptr(), out.data_ptr(), rows, w.shape[0], w.shape[1],
        eps, _stream(a)), "geo GEMM")


def gemm_gelu_plain(a: torch.Tensor, w: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """E1: bf16(gelu_exact(a · wᵀ + bias))."""
    return gelu_exact(_mm32(_as_rows(a), w) + bias).to(torch.bfloat16)


def gemm_gelu(a: torch.Tensor, w: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """The GEMM with epilogue E1: a [P, K] bf16, w [N, K] bf16, bias fp32
    [N] → bf16 [P, N]."""
    rows, n, _ = _check_gemm("gemm_gelu", a, w, bias)
    if not a.is_cuda:
        return gemm_gelu_plain(a, w, bias)
    out = torch.empty(rows, n, dtype=torch.bfloat16, device=a.device)
    _launch_gemm(0, a, w, bias, out, rows)
    gemm_gelu.launches += 1
    return out


def gemm_residual_plain(a: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                        resid: Optional[torch.Tensor] = None,
                        out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """E2: (resid + bias) + a · wᵀ in fp32, cast to ``out_dtype``."""
    y = _mm32(_as_rows(a), w)
    base = bias if resid is None else resid.float() + bias
    return (base + y).to(out_dtype)


def gemm_residual(a: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                  resid: Optional[torch.Tensor] = None,
                  out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The GEMM with epilogue E2: a [P, K] or [H, P, D] bf16, w [N, K] bf16,
    bias fp32 [N], resid [P, N] bf16 or fp32 (or None) → [P, N] of
    ``out_dtype`` (fp32, or bf16 over an fp32 residual)."""
    rows, n, _ = _check_gemm("gemm_residual", a, w, bias)
    if resid is not None:
        if (tuple(resid.shape) != (rows, n) or resid.dtype not in (torch.bfloat16, torch.float32)
                or not resid.is_contiguous() or resid.device != a.device):
            raise ValueError(f"gemm_residual takes a contiguous bf16 or fp32 residual "
                             f"[{rows}, {n}] on A's device, got {resid.dtype} "
                             f"{tuple(resid.shape)}")
        _check_aligned("gemm_residual", resid)
    if (None if resid is None else resid.dtype, out_dtype) not in (
            (None, torch.float32), (torch.float32, torch.float32),
            (torch.float32, torch.bfloat16), (torch.bfloat16, torch.float32)):
        raise ValueError(f"gemm_residual does not take a {resid.dtype if resid is not None else 'missing'} "
                         f"residual with a {out_dtype} output")
    if not a.is_cuda:
        return gemm_residual_plain(a, w, bias, resid, out_dtype)
    out = torch.empty(rows, n, dtype=out_dtype, device=a.device)
    _launch_gemm(1, a, w, bias, out, rows, resid=resid)
    gemm_residual.launches += 1
    return out


def gemm_head_ln_plain(a: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                       scale: torch.Tensor, ln_bias: torch.Tensor, head_dim: int,
                       eps: float) -> torch.Tensor:
    """E3: bf16(LN over each head_dim-column head of a · wᵀ + bias, times
    scale plus ln_bias), laid out [N / head_dim, P, head_dim]."""
    qm = _mm32(_as_rows(a), w) + bias
    q = layer_norm(qm.reshape(qm.shape[0], -1, head_dim), scale, ln_bias, eps)
    return q.to(torch.bfloat16).transpose(0, 1).contiguous()


def gemm_head_ln(a: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, scale: torch.Tensor,
                 ln_bias: torch.Tensor, head_dim: int, eps: float) -> torch.Tensor:
    """The GEMM with epilogue E3 (c_q and the per-head q LayerNorm): a
    [P, K] bf16, w [N, K] bf16, bias fp32 [N], scale/ln_bias fp32
    [head_dim] → bf16 [N / head_dim, P, head_dim], kernel 1's q layout."""
    rows, n, _ = _check_gemm("gemm_head_ln", a, w, bias)
    if head_dim not in (64, 128) or n % head_dim:
        raise ValueError(f"gemm_head_ln takes head_dim 64 or 128 dividing N = {n}, "
                         f"got {head_dim}")
    _check_vec("gemm_head_ln", scale, head_dim, a.device)
    _check_vec("gemm_head_ln", ln_bias, head_dim, a.device)
    if not a.is_cuda:
        return gemm_head_ln_plain(a, w, bias, scale, ln_bias, head_dim, eps)
    out = torch.empty(n // head_dim, rows, head_dim, dtype=torch.bfloat16, device=a.device)
    _launch_gemm(2, a, w, bias, out, rows, ln=(scale, ln_bias), head_dim=head_dim, eps=eps)
    gemm_head_ln.launches += 1
    return out


for _fn in (ln_rows, ln_dot_rows, gemm_gelu, gemm_residual, gemm_head_ln):
    _fn.launches = 0


# ---------------------------------------------------------------------------
# the chain: front (queries → x2) and tail (x2 → logits)
# ---------------------------------------------------------------------------
def _attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     chunk: int = 8192) -> torch.Tensor:
    """The Pallas kernel's exact softmax attention (:func:`sdpa`), in query
    chunks that keep the fp32 scores [1, H, chunk, L] small."""
    return torch.cat([sdpa(q[:, :, i:i + chunk], k, v) for i in range(0, q.shape[2], chunk)],
                     dim=2)


def _front(vae, queries: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           x2_dtype: torch.dtype, plain: bool) -> torch.Tensor:
    """queries [1, P, 3] fp32 + bf16 k/v [1, H, L, D] → x2 [P, W] of
    ``x2_dtype``: the decoder up to its MLP tail, through the kernels (the
    wrappers, which take their twins on CPU tensors) or, with ``plain``,
    through the plain twins and the exact softmax."""
    cfg = vae.cfg
    o = _operands(vae, queries.device)
    eps = cfg.ln_eps
    if plain:
        gemm_res, rows, head_ln, attend = (gemm_residual_plain, ln_rows_plain,
                                           gemm_head_ln_plain, _attention_plain)
    else:
        gemm_res, rows, head_ln, attend = gemm_residual, ln_rows, gemm_head_ln, flash_attention
    qe = fourier_embed(queries[0], cfg.num_freqs, cfg.include_pi).to(torch.bfloat16)
    qe = F.pad(qe, (0, EMB_PAD - qe.shape[1]))
    x = gemm_res(qe, o["wqp"], o["bqp"])
    del qe
    q = head_ln(rows(x, o["ln1s"], o["ln1b"], eps), o["wcq"], o["bcq"], o["qns"], o["qnb"],
                cfg.head_dim, eps)
    att = attend(q[None], k, v)[0]
    del q
    return gemm_res(att, o["wcp"], o["bcp"], resid=x, out_dtype=x2_dtype)


def _tail(vae, x2: torch.Tensor, plain: bool) -> torch.Tensor:
    """x2 [P, W] bf16 or fp32 → [1, P] fp32 logits, through the kernels (or
    their twins on CPU tensors) or, with ``plain``, the plain twins."""
    o = _operands(vae, x2.device)
    eps = vae.cfg.ln_eps
    if plain:
        rows, gelu, gemm_res, dot = (ln_rows_plain, gemm_gelu_plain, gemm_residual_plain,
                                     ln_dot_rows_plain)
    else:
        rows, gelu, gemm_res, dot = ln_rows, gemm_gelu, gemm_residual, ln_dot_rows
    t = gelu(rows(x2, o["ln3s"], o["ln3b"], eps), o["wfc"], o["bfc"])
    y = gemm_res(t, o["wpj"], o["bpj"], resid=x2)
    del t
    return dot(y, o["lnps"], o["lnpb"], o["wout"], o["bout"], eps)[None]


def _check(name, vae, queries, k, v, gate):
    cfg = vae.cfg
    if not gate(cfg):
        raise ValueError(f"{name} does not take this VAE config: {cfg}")
    if queries.dim() != 3 or queries.shape[0] != 1 or queries.shape[2] != 3:
        raise ValueError(f"{name} takes queries [1, P, 3], got {tuple(queries.shape)}")
    want = (1, cfg.heads, k.shape[2], cfg.head_dim)
    if tuple(k.shape) != want or tuple(v.shape) != want:
        raise ValueError(f"{name} takes k/v [1, {cfg.heads}, L, {cfg.head_dim}], got "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if queries.dtype != torch.float32 or k.dtype != torch.bfloat16 or v.dtype != torch.bfloat16:
        raise TypeError(f"{name} takes fp32 queries and bf16 k/v")
    if not (queries.device == k.device == v.device):
        raise ValueError(f"{name} inputs lie on different devices")
    if not (queries.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError(f"{name} takes contiguous queries, k, v")


def geo_decode_plain(vae, queries: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Kernel 3's function (geo_decoder_pallas.py:101-136) in plain PyTorch:
    queries [1, P, 3] fp32 + bf16 k/v [1, H, L, D] → [1, P] fp32 logits. x
    and x2 stay fp32; h1, the per-head q-LN output, the normalised softmax
    p, the attention output, h3, the GELU output and the ln_post output are
    rounded to bf16 where the Pallas kernel rounds them."""
    return _tail(vae, _front(vae, queries, k, v, torch.float32, plain=True), plain=True)


def fused_geo_decode(vae, queries: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """queries [1, P, 3] fp32 + bf16 k/v [1, H, L, D] (k LayerNorm applied)
    → [1, P] fp32 logits: the kernel chain on CUDA tensors,
    :func:`geo_decode_plain` on CPU tensors."""
    _check("fused_geo_decode", vae, queries, k, v, fused_geo_supported)
    if not queries.is_cuda:
        return geo_decode_plain(vae, queries, k, v)
    out = _tail(vae, _front(vae, queries, k, v, torch.float32, plain=False), plain=False)
    fused_geo_decode.launches += 1
    return out


fused_geo_decode.launches = 0


# ---------------------------------------------------------------------------
# the streamed decode (> 1024 latents) and its MLP tail (kernel 4)
# ---------------------------------------------------------------------------
def geo_stream_x2(vae, queries: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The streamed decode up to the MLP tail, in the op order of
    geo_decoder_pallas.py:340-375: queries [1, P, 3] fp32 + bf16 k/v
    [1, H, L, D] (k LayerNorm applied) → x2 = x + c_proj(attn) [1, P, W],
    kept fp32 until it is rounded to bf16 in c_proj's epilogue. The same
    front as kernel 3's (:func:`_front`)."""
    return _front(vae, queries, k, v, torch.bfloat16, plain=False)[None]


def geo_mlp_tail_plain(vae, x2: torch.Tensor) -> torch.Tensor:
    """The MLP tail's function (geo_decoder_pallas.py:274-296) in plain
    PyTorch: x2 [1, P, W] bf16 (or fp32) → [1, P] fp32 logits. h =
    bf16(LN3(x2)); the residual x2 + b_proj stays fp32; the 4W exact-GELU MLP
    with bf16 inputs and fp32 products (GELU output rounded to bf16) is added
    into it; ln_post is rounded to bf16 and dotted with the output weights
    in fp32."""
    return _tail(vae, x2[0], plain=True)


def _check_tail(vae, x2):
    cfg = vae.cfg
    m = cfg.geo_decoder_mlp_expand_ratio * cfg.width
    if cfg.width % 128 or m % 64 or cfg.out_channels != 1:
        raise ValueError(f"geo_mlp_tail does not take this VAE config: {cfg}")
    if x2.dim() != 3 or x2.shape[0] != 1 or x2.shape[2] != cfg.width:
        raise ValueError(f"geo_mlp_tail takes x2 [1, P, {cfg.width}], got {tuple(x2.shape)}")
    if x2.dtype != torch.bfloat16:
        raise TypeError(f"geo_mlp_tail takes bf16 x2, got {x2.dtype}")
    if not x2.is_contiguous() or x2.data_ptr() % 16:
        raise ValueError("geo_mlp_tail takes a contiguous, 16-byte aligned x2")


def geo_mlp_tail(vae, x2: torch.Tensor) -> torch.Tensor:
    """x2 [1, P, W] bf16 → [1, P] fp32 logits: the tail's kernels on a CUDA
    tensor, :func:`geo_mlp_tail_plain` on a CPU tensor."""
    _check_tail(vae, x2)
    if not x2.is_cuda:
        return geo_mlp_tail_plain(vae, x2)
    out = _tail(vae, x2[0], plain=False)
    geo_mlp_tail.launches += 1
    return out


geo_mlp_tail.launches = 0


def fused_geo_decode_stream(vae, queries: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor) -> torch.Tensor:
    """queries [1, P, 3] fp32 + bf16 k/v [1, H, L, D] → [1, P] fp32 logits:
    :func:`geo_stream_x2`, then :func:`geo_mlp_tail`."""
    _check("fused_geo_decode_stream", vae, queries, k, v, fused_geo_stream_supported)
    return geo_mlp_tail(vae, geo_stream_x2(vae, queries, k, v))
