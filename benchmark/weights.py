"""Random weights made by the benchmark, on the device, from the seed.

The port's modules are built on the ``meta`` device (no storage, no init),
and every parameter becomes a view of one buffer per dtype, drawn from one
``torch.Generator`` on the device in a few large calls. The same tensors,
by the checkpoint names the port keeps, are what the reference reads.

Each parameter is ``offset + bound·u`` with u uniform in [-1, 1):

* a matrix or conv weight: bound 1/sqrt(fan in) (the scheme of the
  published models' linear init);
* the bias of such a weight: the same bound;
* a norm's gain (``weight``, ``scale``) and DINOv2's layer scales
  (``lambda1``): 1 ± 0.1;
* a norm's bias: ± 0.1;
* DINOv2's CLS token and position table: ± 0.035 (std 0.02).
"""

from __future__ import annotations

import math

import torch
from torch import nn

CHUNK = 1 << 27   # elements drawn per call


def _rule(name: str, shape, shapes: dict):
    """(offset, bound) of the parameter ``name``."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf in ("cls_token", "position_embeddings"):
        return 0.0, 0.02 * math.sqrt(3.0)
    if len(shape) >= 2:
        return 0.0, 1.0 / math.sqrt(math.prod(shape[1:]))
    sibling = shapes.get(name[: -len(leaf)] + "weight")
    if leaf == "bias" and sibling is not None and len(sibling) >= 2:
        return 0.0, 1.0 / math.sqrt(math.prod(sibling[1:]))
    if leaf == "bias":
        return 0.0, 0.1
    return 1.0, 0.1


def _draw(n: int, dtype, generator, device) -> torch.Tensor:
    """n values uniform in [-1, 1) in ``dtype``, drawn in fp32 chunks."""
    buf = torch.empty(n, dtype=dtype, device=device)
    for i in range(0, n, CHUNK):
        m = min(CHUNK, n - i)
        part = torch.rand(m, generator=generator, device=device, dtype=torch.float32)
        buf[i:i + m] = part.mul_(2.0).sub_(1.0)
    return buf


@torch.no_grad()
def fill(modules: dict, seed: int, device) -> dict:
    """Give every parameter of ``modules`` ({prefix: meta-built module})
    random values from ``seed`` on ``device``; returns {prefix.name: tensor},
    the same storage the modules now hold."""
    params = [(f"{prefix}.{name}", mod, pname, p)
              for prefix, module in modules.items()
              for name, p in module.named_parameters()
              for mod, pname in [_owner(module, name)]]
    for prefix, module in modules.items():
        if any(True for _ in module.buffers()):
            raise ValueError(f"{prefix}: modules with buffers are not supported")
    shapes = {full: tuple(p.shape) for full, _, _, p in params}
    generator = torch.Generator(device=device).manual_seed(seed)
    out = {}
    for dtype in sorted({p.dtype for *_, p in params}, key=str):
        group = [t for t in params if t[3].dtype == dtype]
        buf = _draw(sum(p.numel() for *_, p in group), dtype, generator, device)
        off = 0
        for full, mod, pname, p in group:
            view = buf[off:off + p.numel()].view(p.shape)
            off += p.numel()
            offset, bound = _rule(full, p.shape, shapes)
            view.mul_(bound).add_(offset)
            mod._parameters[pname] = nn.Parameter(view, requires_grad=False)
            out[full] = view
    return out


def _owner(module: nn.Module, name: str):
    """(the submodule that holds parameter ``name``, its local name)."""
    path, _, leaf = name.rpartition(".")
    return (module.get_submodule(path) if path else module), leaf
