"""Flow-matching training for the shape DiT (port of
hunyuan3d2_tpu/training/flow_match.py).

The reference is inference-only; the JAX package added the training
objective of the same model family, rectified-flow velocity regression:

    x_t = (1−σ)·x₀ + σ·x₁,  x₀~N(0,I),  σ~U(0,1)
    target v = x₁ − x₀
    loss = E‖model(x_t, σ, cond) − v‖²

The model sees x_t in bf16; the target and the mean square are fp32, as in
the JAX loss. The step is the usual eager one (zero_grad, backward, step)
with AdamW at optax ``adamw``'s defaults (decoupled weight decay). On the
card the DiT's attention goes through kernel 1, whose gradient is its plain
twin's (ops/flash_attention.py). Draws come from an explicit
``torch.Generator``; a caller may pass ``x0`` and ``sigma`` instead (the
tests replay the JAX package's draws so).
"""

from __future__ import annotations

from typing import Optional

import torch

from hunyuan3d2_tpu_torch.utils.profiling import annotate


def flow_match_loss(model, latents: torch.Tensor, cond: torch.Tensor,
                    guidance: Optional[torch.Tensor] = None, *, x0: Optional[torch.Tensor] = None,
                    sigma: Optional[torch.Tensor] = None,
                    generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """latents [B, L, C] clean data (x₁), cond [B, Lc, D] → the scalar fp32
    loss. ``x0`` [B, L, C] and ``sigma`` [B] are drawn from ``generator`` on
    the latents' device (x0 first) where the caller passes none."""
    dev = latents.device
    if x0 is None:
        x0 = torch.randn(latents.shape, generator=generator, device=dev, dtype=torch.float32)
    if sigma is None:
        sigma = torch.rand((latents.shape[0],), generator=generator, device=dev,
                           dtype=torch.float32)
    x0, sigma = x0.to(dev, torch.float32), sigma.to(dev, torch.float32)
    x1 = latents.float()
    s = sigma[:, None, None]
    xt = (1.0 - s) * x0 + s * x1
    target = x1 - x0
    pred = model(xt.to(torch.bfloat16), sigma, cond, guidance).float()
    return torch.mean(torch.square(pred - target))


def make_train_step(model, optimizer: Optional[torch.optim.Optimizer] = None):
    """(optimizer, train_step) for ``model``, whose parameters are all set
    to require a gradient. The default optimizer is AdamW with lr 1e-4,
    betas (0.9, 0.999), eps 1e-8 and weight decay 0.01 (optax ``adamw(1e-4,
    weight_decay=0.01)``). ``train_step(latents, cond, x0=None, sigma=None,
    generator=None)`` runs one zero_grad / backward / step and returns the
    loss (detached); its three phases are named spans in a trace
    (``loss``, ``backward``, ``optimizer``; utils/profiling.py)."""
    model.requires_grad_(True)
    if optimizer is None:
        optimizer = torch.optim.AdamW(model.parameters(), lr=1e-4, betas=(0.9, 0.999), eps=1e-8,
                                      weight_decay=0.01)

    def train_step(latents, cond, x0=None, sigma=None, generator=None):
        optimizer.zero_grad(set_to_none=True)
        with annotate("loss"):
            loss = flow_match_loss(model, latents, cond, x0=x0, sigma=sigma, generator=generator)
        with annotate("backward"):
            loss.backward()
        with annotate("optimizer"):
            optimizer.step()
        return loss.detach()

    return optimizer, train_step
