"""Core NN primitives (port of hunyuan3d2_tpu/ops/nn.py).

Dtype policy, as in the JAX package: Linear weights are bf16, matmuls
accumulate in fp32 with the bias added in fp32 before the single cast back
to the activation dtype, and normalizations compute in fp32. Modules keep
the Hunyuan3D-2 checkpoint parameter names (``weight``/``bias``/``scale``)
with torch's [out, in] Linear layout.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

PARAM_DTYPE = torch.bfloat16


def dense(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x @ w.T (+ b), output in x.dtype. ``w`` is [out, in].

    The JAX package's ``dot(preferred=f32) + b`` then one cast. On the card
    cuBLAS runs the product in the activation dtype with an fp32
    accumulator and the bias in its epilogue; on the CPU the product is
    taken in fp32 explicitly (bf16 products are exact in fp32), so the CPU
    tests see the JAX package's rounding."""
    if x.is_cuda:
        return F.linear(x, w.to(x.dtype), None if b is None else b.to(x.dtype))
    y = F.linear(x.float(), w.float(), None if b is None else b.float())
    return y.to(x.dtype)


def layer_norm(x: torch.Tensor, scale: Optional[torch.Tensor] = None,
               bias: Optional[torch.Tensor] = None, eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm over the last axis in fp32; scale/bias None ⇒ non-affine."""
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = (x32 - mean).square().mean(-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    if scale is not None:
        y = y * scale.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm with fp32 internals; the cast to the working dtype comes
    BEFORE the multiply by the scale (reference RMSNorm order)."""
    x32 = x.float()
    rrms = torch.rsqrt(x32.square().mean(-1, keepdim=True) + eps)
    return (x32 * rrms).to(x.dtype) * scale.to(x.dtype)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x)


def silu(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x)


class Linear(nn.Module):
    """Affine map with bf16 [out, in] weight; computes through :func:`dense`,
    so the activations' dtype (bf16 or fp32) decides the matmul dtype."""

    def __init__(self, in_dim: int, out_dim: int, bias: bool = True):
        super().__init__()
        self.in_features, self.out_features = in_dim, out_dim
        self.weight = nn.Parameter(torch.empty(out_dim, in_dim, dtype=PARAM_DTYPE))
        self.bias = nn.Parameter(torch.empty(out_dim, dtype=PARAM_DTYPE)) if bias else None

    def forward(self, x):
        return dense(x, self.weight, self.bias)


class LayerNorm(nn.Module):
    """Affine LayerNorm with fp32 ``weight``/``bias`` (checkpoint names)."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(dim, dtype=torch.float32))
        self.bias = nn.Parameter(torch.empty(dim, dtype=torch.float32))

    def forward(self, x):
        return layer_norm(x, self.weight, self.bias, self.eps)


class RMSNorm(nn.Module):
    """RMSNorm with an fp32 ``scale`` (reference hunyuan3ddit.py name)."""

    def __init__(self, dim: int):
        super().__init__()
        self.scale = nn.Parameter(torch.empty(dim, dtype=torch.float32))

    def forward(self, x):
        return rms_norm(x, self.scale)


@torch.no_grad()
def init_random_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Random init in the JAX package's scheme: Linear weight and bias
    U(±1/sqrt(in)), norm scales 1, norm biases 0. Other parameters are left
    to the owning module (see its ``init_random_``)."""
    for m in module.modules():
        if isinstance(m, Linear):
            bound = 1.0 / math.sqrt(m.in_features)
            m.weight.uniform_(-bound, bound, generator=generator)
            if m.bias is not None:
                m.bias.uniform_(-bound, bound, generator=generator)
        elif isinstance(m, LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, RMSNorm):
            m.scale.fill_(1.0)
    return module


def build(cls, *args, device=None, generator: Optional[torch.Generator] = None, **kwargs):
    """Construct ``cls(*args, **kwargs)`` without running torch's default
    init, directly on ``device`` (``cuda`` unless the caller passes another),
    then draw its weights from ``generator`` (seed 0 when None) on that
    device. The parameters do not require a gradient (inference); a trainer
    turns them on with ``requires_grad_(True)`` (training/flow_match.py)."""
    device = torch.device(device if device is not None else "cuda")
    with torch.device("meta"):
        module = cls(*args, **kwargs)
    module = module.to_empty(device=device).requires_grad_(False)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    init_random_(module, generator)
    for m in module.modules():  # each draws only its own non-Linear parameters
        if hasattr(m, "init_random_"):
            m.init_random_(generator)
    return module.eval()
