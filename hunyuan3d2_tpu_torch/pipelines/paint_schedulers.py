"""The paint-turbo sampler (port of the LCMScheduler of
hunyuan3d2_tpu/pipelines/paint_schedulers.py).

Latent-consistency sampling: an x₀ jump from a v-prediction, then
re-noising to the next discrete timestep. The tables are the JAX package's
numpy tables; ``step`` runs on tensors in fp32.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class LCMScheduler:
    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    ddim_timesteps: int = 30

    def _alphas_cumprod(self) -> np.ndarray:
        betas = np.linspace(self.beta_start ** 0.5, self.beta_end ** 0.5,
                            self.num_train_timesteps) ** 2
        return np.cumprod(1.0 - betas)

    def make_tables(self, num_inference_steps: int):
        """→ (timesteps [N] fp32 descending, alphas_cumprod [T] fp32).

        The turbo rule: DDIM table entry i is (i+1)·(1000//30) − 1, indexed
        by round(linspace(29, 2, N)); at N = 10 that is
        [989, 890, 791, 692, 593, 494, 395, 296, 197, 98]."""
        k = self.num_train_timesteps // self.ddim_timesteps
        table = (np.arange(1, self.ddim_timesteps + 1) * k) - 1
        timesteps = table[np.round(np.linspace(29, 2, num_inference_steps)).astype(int)]
        return timesteps.astype(np.float32), self._alphas_cumprod().astype(np.float32)

    def step(self, model_output: torch.Tensor, sample: torch.Tensor, t_int: int, t_next_int: int,
             alphas_cumprod: torch.Tensor, noise: torch.Tensor):
        """One step in fp32 from a v-prediction → (next sample, predicted
        x₀); ``t_next_int`` 0 returns x₀ itself."""
        ac_t = alphas_cumprod[t_int]
        pred_x0 = ac_t ** 0.5 * sample - (1 - ac_t) ** 0.5 * model_output
        if t_next_int <= 0:
            return pred_x0, pred_x0
        ac_n = alphas_cumprod[t_next_int]
        return ac_n ** 0.5 * pred_x0 + (1 - ac_n) ** 0.5 * noise, pred_x0
