"""Sharding rules: module names → column-, row-parallel or replicated
(port of hunyuan3d2_tpu/parallel/sharding.py).

Megatron-style tensor parallelism over the mesh's "tp" axis, with the JAX
package's suffix table (``_spec_for_path``) written on the port's checkpoint
names. :func:`dit_param_spec` gives each parameter the JAX spec's class;
:func:`shard_params` replaces each such Linear (or conv) by its rank's shard
in place, so one rank holds about 1/tp of each transformer, and sets each
attention's local head count. Where GSPMD may shard a weight unaligned and
insert collectives, the port chooses a layout in which each rank's shard is
self-contained:

* a fused projection's rows are taken rank-major, one block per segment:
  the DiT's qkv (laid out (3, H, D)) becomes [q_r | k_r | v_r], the single
  block's linear1 [q_r | k_r | v_r | mlp_r] with linear2's columns to match,
  and the chunked pairs (the paint UNet's GEGLU, DINOv2's SwiGLU) [a_r | b_r];
  the ShapeVAE's qkv is head-major already, so a contiguous block is;
* a consumer that needs a column-parallel output whole (the adaLN
  modulations, the paint UNet's proj_in, the SD VAE's 1×1 quant convs)
  all-gathers that small activation; a row-parallel layer whose input is
  whole (proj_out, conv_out, the time embedding's second layer) slices it.
  A weight is never gathered;
* an attention whose heads tp does not divide (SD2.1's 320-channel levels:
  5 heads of 64 at tp = 2; the SD VAE's single head) keeps its projections
  sharded, all-gathers their outputs and runs the attention itself whole on
  every tp rank: splitting a head across ranks would need the softmax's
  statistics reduced over them. The DiT, DINOv2, CLIP and ShapeVAE towers
  need tp to divide their heads.

The ShapeVAE's geo decoder keeps whole weights on every rank: its kernels
(3 and 4) take whole operands, as a ``pallas_call``, which GSPMD does not
partition, receives them replicated in the JAX package.

Row-parallel partial products are summed over tp in fp32, then the bias is
added once and the sum cast, the dtype policy of ops/nn.py ``dense``. On the
card a bf16 layer takes its partial product as a tensor-core GEMM of the bf16
operands with an fp32 result (:class:`_PartialProduct`), so sharding keeps
dense's speed and rounds each partial sum only at the end. A
replicated weight used inside a tp-local region (the DiT's and the
ShapeVAE's per-head q/k norms) gets a partial gradient on each rank: the
train step sums those over tp (:func:`reduce_gradients`).

Batch ("dp") splits the leading axis of activations (:func:`shard_batch`);
where dp does not divide it, the batch runs whole on every dp group, as
GSPMD leaves an indivisible axis replicated.
"""

from __future__ import annotations

import re
from typing import Dict, Optional

import torch
from torch import nn

from hunyuan3d2_tpu_torch.ops.conv import Conv2d, conv2d
from hunyuan3d2_tpu_torch.ops.nn import Linear, dense
from hunyuan3d2_tpu_torch.parallel import collectives as C
from hunyuan3d2_tpu_torch.parallel.mesh import axis


def _suffixes(*names: str) -> re.Pattern:
    return re.compile(r"(?:^|\.)(?:" + "|".join(names) + r")$")


# module name → how its weight is split:
#   col: out features, the output stays local (the first of a pair);
#   gather: out features, the output all-gathered;
#   row: in features, the input already local (the second of a pair);
#   slice: in features, the whole input sliced here.
_RULES = (
    (_suffixes(r"(?:img|txt)_mod\.lin", r"modulation\.lin", r"adaLN_modulation\.1", "proj_in",
               "quant_conv", "post_quant_conv"), "gather"),
    (_suffixes(r"(?:img|txt)_attn\.qkv", r"(?:img|txt)_mlp\.0", "linear1",
               r"attention\.(?:query|key|value)", r"mlp\.weights_in", r"self_attn\.[qkv]_proj",
               r"mlp\.fc1", r"attn\.c_qkv", r"mlp\.c_fc", r"attn\.c_q", r"attn\.c_kv", "to_[qkv]",
               r"ff\.net\.0\.proj"), "col"),
    (_suffixes(r"(?:img|txt)_attn\.proj", r"(?:img|txt)_mlp\.2", "linear2",
               r"attention\.output\.dense", r"mlp\.weights_out", r"self_attn\.out_proj",
               r"mlp\.fc2", r"attn\.c_proj", r"mlp\.c_proj", r"to_out\.0", r"ff\.net\.2"), "row"),
    (_suffixes("proj_out", "conv_out", r"time_embedding\.linear_2"), "slice"),
)
_CLASS = {"col": "col", "gather": "col", "row": "row", "slice": "row"}
_ATTN_PROJ = _suffixes("to_[qkv]", r"to_out\.0")
_PARTIAL = _suffixes(r"norm\.(?:query|key)_norm\.scale", r"attention\.[qk]_norm\.(?:weight|bias)")


def _mode(module_name: str) -> Optional[str]:
    for pattern, mode in _RULES:
        if pattern.search(module_name):
            return mode
    return None


def dit_param_spec(module: nn.Module) -> Dict[str, str]:
    """{parameter name: 'col' | 'row' | 'rep'} for any of the port's
    transformers (DiT, ShapeVAE, DINOv2, CLIP, the paint UNet, the SD VAE):
    'col' shards the out features (dim 0 of a torch weight, and the bias),
    'row' the in features (dim 1; the bias stays whole), as the JAX spec of
    the matching leaf does."""
    spec = {}
    for name, _ in module.named_parameters():
        owner, leaf = name.rsplit(".", 1) if "." in name else ("", name)
        cls = _CLASS.get(_mode(owner), "rep") if leaf in ("weight", "bias") else "rep"
        spec[name] = "rep" if leaf == "bias" and cls == "row" else cls
    return spec


def _segments(name: str, weight: torch.Tensor, dim: int) -> list:
    """The sizes of the segments of the sharded axis that each rank takes one
    block of (a fused projection's parts)."""
    n = weight.shape[dim]
    if re.search(r"_attn\.qkv$", name):
        return [n // 3] * 3
    if re.search(r"(?:^|\.)linear1$", name):
        h = weight.shape[1]
        return [h, h, h, n - 3 * h]
    if re.search(r"(?:^|\.)linear2$", name):
        h = weight.shape[0]
        return [h, n - h]
    if re.search(r"(?:weights_in|ff\.net\.0\.proj)$", name):
        return [n // 2] * 2
    return [n]


def _index(name: str, segments: list, tp: int, rank: int, device) -> torch.Tensor:
    parts, off = [], 0
    for s in segments:
        if s % tp:
            raise ValueError(f"shard_params: {name}: a segment of {s} does not split over "
                             f"tp={tp}")
        k = s // tp
        parts.append(torch.arange(off + rank * k, off + (rank + 1) * k, device=device))
        off += s
    return torch.cat(parts)


class _PartialProduct(torch.autograd.Function):
    """x @ w.T of bf16 (or fp16) operands on the card, with an fp32 result:
    cuBLAS's tensor-core GEMM, fp32 accumulator and output (F.linear would
    round each rank's partial sum to bf16 before the reduce; an fp32 GEMM of
    the upcast operands would run on the CUDA cores). The backward runs in
    the operands' dtype, as F.linear's does on the unsharded layer."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        y = torch.mm(x.reshape(-1, x.shape[-1]), w.t(), out_dtype=torch.float32)
        return y.reshape(*x.shape[:-1], w.shape[0])

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype)
        gx = g @ w if ctx.needs_input_grad[0] else None
        gw = (g.reshape(-1, g.shape[-1]).t() @ x.reshape(-1, x.shape[-1])
              if ctx.needs_input_grad[1] else None)
        return gx, gw


class ShardedLinear(nn.Module):
    """This rank's shard of a Linear or a Conv2d (same parameter names):
    rows (``col``, ``gather``) or columns (``row``, ``slice``) ``index`` of
    the whole weight; the collectives of its mode around the product."""

    def __init__(self, src: nn.Module, mode: str, group, index: torch.Tensor):
        super().__init__()
        self.mode, self.group, self.conv = mode, group, isinstance(src, Conv2d)
        self.dim = 0 if mode in ("col", "gather") else 1
        self.register_buffer("index", index, persistent=False)
        self.weight = nn.Parameter(src.weight.detach().index_select(self.dim, index),
                                   requires_grad=src.weight.requires_grad)
        bias = src.bias
        if bias is not None and self.dim == 0:
            bias = nn.Parameter(bias.detach().index_select(0, index),
                                requires_grad=bias.requires_grad)
        self.bias = bias

    def _product(self, x, w, b, *conv_args, **conv_kwargs):
        if self.conv:
            if b is None:
                b = torch.zeros(w.shape[0], dtype=x.dtype, device=x.device)
            return conv2d(x, w, b, *conv_args, **conv_kwargs)
        return dense(x, w, b)

    def forward(self, x, *conv_args, **conv_kwargs):
        g = self.group
        if self.dim == 0:
            y = self._product(C.copy_to_tp(x, g), self.weight, self.bias, *conv_args,
                              **conv_kwargs)
            return C.gather_from_tp(y, g) if self.mode == "gather" else y
        if self.mode == "slice":
            x = C.copy_to_tp(x, g).index_select(-1, self.index)
        # fp32 partial products (the weight rounded to the activations' dtype
        # first, as dense does), summed over tp, then the bias, then one cast.
        # The CPU (and an fp32 layer, or a conv: the few-channel conv_outs)
        # takes the product of the rounded operands in fp32, exact per term.
        w = self.weight.to(x.dtype)
        if x.is_cuda and not self.conv and x.dtype in (torch.bfloat16, torch.float16):
            part = _PartialProduct.apply(x, w)
        else:
            part = self._product(x.float(), w, None, *conv_args, **conv_kwargs)
        y = C.reduce_from_tp(part, g)
        if self.bias is not None:
            y = y + self.bias.float()
        return y.to(x.dtype)


def _set_local_heads(module: nn.Module, tp: int) -> list:
    """Divide each attention's head count by tp; return the names of the
    attentions that run whole (their heads not divisible)."""
    from hunyuan3d2_tpu_torch.models import clip_vit, dinov2, dit, paint_unet, shapevae
    from hunyuan3d2_tpu_torch.ops.conv import Attention2d

    # type → (its head-count attributes, whether it may run whole); the SD
    # VAE's attention has one head
    owners = {dit.DoubleStreamBlock: (("num_heads",), False),
              dit.SingleStreamBlock: (("num_heads", "hidden_size"), False),
              dinov2.Layer: (("num_heads",), False), clip_vit.EncoderLayer: (("num_heads",), False),
              shapevae.ResidualAttentionBlock: (("heads",), False),
              paint_unet.Transformer2D: (("heads",), True), Attention2d: ((), True)}
    whole = []
    for name, sub in module.named_modules():
        if type(sub) not in owners:
            continue
        attrs, may_run_whole = owners[type(sub)]
        heads = getattr(sub, attrs[0]) if attrs else 1
        if heads % tp == 0:
            for a in attrs:
                setattr(sub, a, getattr(sub, a) // tp)
        elif may_run_whole:
            whole.append(name)
        else:
            raise ValueError(f"shard_params: {name} has {heads} heads, which tp={tp} does "
                             "not divide")
    return whole


def shard_params(module: nn.Module, mesh) -> nn.Module:
    """Shard ``module``'s transformer weights over the mesh's "tp" axis in
    place (nothing changes at tp = 1) and record the mesh on it
    (``parallel_mesh``, read by the train step). Returns the module; a
    module sharded once is not sharded again."""
    if getattr(module, "parallel_mesh", None) is not None:
        raise RuntimeError("shard_params: the module is sharded already")
    module.parallel_mesh = mesh
    ax = axis(mesh, "tp")
    if ax is None:
        return module
    group, tp, rank = ax
    whole = _set_local_heads(module, tp)
    for name, sub in list(module.named_modules()):
        mode = _mode(name)
        if mode is None or "geo_decoder" in name.split(".") \
                or not isinstance(sub, (Linear, Conv2d)):
            continue
        if _ATTN_PROJ.search(name) and any(name.startswith(w + ".") for w in whole):
            mode = "gather" if mode == "col" else "slice"
        dim = 0 if mode in ("col", "gather") else 1
        index = _index(name, _segments(name, sub.weight, dim), tp, rank, sub.weight.device)
        parent, _, leaf = name.rpartition(".")
        module.get_submodule(parent).register_module(leaf, ShardedLinear(sub, mode, group,
                                                                         index))
    module.tp_partial_grads = [n for n, _ in module.named_parameters()
                               if _PARTIAL.search(n) and "geo_decoder" not in n.split(".")]
    return module


def reduce_gradients(module: nn.Module) -> None:
    """After a backward on a sharded module: sum the partial gradients of the
    replicated weights inside tp-local regions over tp, then average every
    gradient over dp (the tp shards keep their own)."""
    mesh = getattr(module, "parallel_mesh", None)
    dp, tp = axis(mesh, "dp"), axis(mesh, "tp")
    partial = set(getattr(module, "tp_partial_grads", ()))
    for name, p in module.named_parameters():
        if p.grad is None:
            continue
        if tp is not None and name in partial:
            p.grad.copy_(C.all_reduce(p.grad.float(), tp[0]))
        if dp is not None:
            p.grad.copy_(C.all_reduce(p.grad.float(), dp[0]) / dp[1])


def shard_batch(tensors, mesh):
    """This dp rank's part of each tensor's leading (batch) axis; a tensor
    whose batch dp does not divide, a non-tensor, or any tensor when there
    is no dp axis, passes as it is. A tuple in, a tuple out."""
    ax = axis(mesh, "dp")

    def put(x):
        if ax is None or not isinstance(x, torch.Tensor) or x.dim() == 0 or x.shape[0] % ax[1]:
            return x
        return C.split_batch(x, ax[0])

    if isinstance(tensors, torch.Tensor):
        return put(tensors)
    return tuple(put(x) for x in tensors)


def gather_batch(x: torch.Tensor, mesh, batch: int) -> torch.Tensor:
    """The whole batch of ``batch`` rows from each dp rank's part
    (:func:`shard_batch`'s inverse)."""
    ax = axis(mesh, "dp")
    if ax is None or batch % ax[1]:
        return x
    return C.gather_batch(x, ax[0])
