"""Samplers of the paint (texture) diffusion model (port of
hunyuan3d2_tpu/pipelines/paint_schedulers.py).

* EulerAncestralDiscreteScheduler: zero-terminal-SNR rescaled betas,
  v-prediction (or epsilon), 'trailing' spacing; the standard HunyuanPaint
  sampler.
* LCMScheduler: latent-consistency sampling, an x₀ jump from a
  v-prediction, then re-noising to the next discrete timestep; the
  paint-turbo sampler.
* DDIMScheduler: deterministic DDIM (eta = 0), the x4 upscaler's sampler.

The tables are the JAX package's numpy tables, bit for bit; ``step`` runs on
fp32 tensors, its scalar coefficients rounded to fp32 as the JAX package
computes them.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def make_betas(num_train_timesteps: int, beta_start: float, beta_end: float,
               beta_schedule: str = "scaled_linear") -> np.ndarray:
    """The diffusers beta schedules the reference's checkpoints use."""
    if beta_schedule == "scaled_linear":
        return np.linspace(beta_start ** 0.5, beta_end ** 0.5, num_train_timesteps) ** 2
    if beta_schedule == "linear":
        return np.linspace(beta_start, beta_end, num_train_timesteps)
    if beta_schedule == "squaredcos_cap_v2":
        t = np.arange(num_train_timesteps + 1) / num_train_timesteps
        f = np.cos((t + 0.008) / 1.008 * np.pi / 2) ** 2
        return np.clip(1 - f[1:] / f[:-1], 0.0, 0.999)
    raise ValueError(f"unknown beta_schedule {beta_schedule!r}")


def alphas_cumprod_from_config(cfg: dict) -> np.ndarray:
    """A scheduler_config.json dict → the ᾱ table (e.g. the x4 upscaler's
    low-res DDPM, with its own betas)."""
    betas = make_betas(cfg.get("num_train_timesteps", 1000), cfg.get("beta_start", 0.0001),
                       cfg.get("beta_end", 0.02), cfg.get("beta_schedule", "linear"))
    return np.cumprod(1.0 - betas)


def rescale_zero_terminal_snr(betas: np.ndarray) -> np.ndarray:
    """Shift the √ᾱ schedule so that SNR(T) = 0 (Lin et al. 2023)."""
    abar_sqrt = np.sqrt(np.cumprod(1.0 - betas))
    a0, aT = abar_sqrt[0], abar_sqrt[-1]
    abar = ((abar_sqrt - aT) * (a0 / (a0 - aT))) ** 2
    return 1.0 - np.concatenate([abar[:1], abar[1:] / abar[:-1]])


def _spaced_timesteps(t: int, n: int, spacing: str, steps_offset: int) -> np.ndarray:
    """diffusers' timestep spacings, descending, float64."""
    if spacing == "trailing":
        return np.round(np.arange(t, 0, -t / n)).astype(np.float64) - 1
    if spacing == "leading":  # integer step ratio, ascending grid + offset, reversed
        return (np.arange(0, n) * (t // n)).round()[::-1].astype(np.float64) + steps_offset
    return np.linspace(0, t - 1, n)[::-1]


def init_noise_sigma(sigma_max) -> float:
    """(σ_max² + 1)^½ in fp32, the initial noise scale of leading spacing."""
    s = np.float32(sigma_max)
    return float((s * s + np.float32(1)) ** np.float32(0.5))


def draw(given, shape, generator, device) -> torch.Tensor:
    """A unit normal draw of ``shape`` in fp32: ``given`` (an injected
    array) or one from ``generator``."""
    if given is None:
        return torch.randn(shape, generator=generator, device=device)
    if not isinstance(given, torch.Tensor):
        given = torch.from_numpy(np.array(given, np.float32))
    return given.to(device=device, dtype=torch.float32).reshape(shape)


@dataclasses.dataclass(frozen=True)
class EulerAncestralDiscreteScheduler:
    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    prediction_type: str = "v_prediction"
    timestep_spacing: str = "trailing"
    rescale_betas_zero_snr: bool = True
    steps_offset: int = 0

    def _alphas_cumprod(self) -> np.ndarray:
        betas = make_betas(self.num_train_timesteps, self.beta_start, self.beta_end)
        if self.rescale_betas_zero_snr:
            betas = rescale_zero_terminal_snr(betas)
        ac = np.cumprod(1.0 - betas)
        if self.rescale_betas_zero_snr:
            ac[-1] = 2 ** -24  # a finite σ_T ≈ 4096
        return ac

    def make_tables(self, num_inference_steps: int):
        """→ (timesteps [N] fp32 descending, sigmas [N+1] fp32 ending in 0)."""
        t = self.num_train_timesteps
        timesteps = _spaced_timesteps(t, num_inference_steps, self.timestep_spacing,
                                      self.steps_offset)
        ac = self._alphas_cumprod()
        sigmas = np.interp(timesteps, np.arange(t), np.sqrt((1 - ac) / ac))
        sigmas = np.concatenate([sigmas, [0.0]]).astype(np.float32)
        return timesteps.astype(np.float32), sigmas

    @staticmethod
    def scale_model_input(sample: torch.Tensor, sigma) -> torch.Tensor:
        """sample / √(σ² + 1), the divisor rounded to fp32."""
        sigma = np.float32(sigma)
        return sample / float((sigma * sigma + np.float32(1)) ** np.float32(0.5))

    def step(self, model_output: torch.Tensor, sample: torch.Tensor, sigma, sigma_next,
             noise: torch.Tensor):
        """One ancestral Euler step on fp32 tensors → (next sample,
        predicted x₀). v-prediction: x₀ = −σ/√(σ²+1)·v + x/(σ²+1);
        epsilon: x₀ = x − σ·ε.

        Each a + c·b is one fused multiply-add (``torch.add`` with
        ``alpha``), as the JAX package's compiled step contracts it: at
        σ₀ ≈ 4096 the sample is ~10⁴ and the step's result ~10², so a
        separate rounding of the product would show in the result."""
        s, sn = np.float32(sigma), np.float32(sigma_next)
        s2p1 = s * s + np.float32(1)
        if self.prediction_type == "v_prediction":
            pred_x0 = torch.add(sample / float(s2p1), model_output,
                                alpha=float(-s / s2p1 ** np.float32(0.5)))
        elif self.prediction_type == "epsilon":
            pred_x0 = torch.add(sample, model_output, alpha=float(-s))
        else:
            raise ValueError(self.prediction_type)
        up2 = sn * sn * (s * s - sn * sn) / (s * s)
        sigma_up = up2 ** np.float32(0.5)
        sigma_down = (sn * sn - up2) ** np.float32(0.5)
        prev = torch.add(sample, (sample - pred_x0) / float(s), alpha=float(sigma_down - s))
        return torch.add(prev, noise, alpha=float(sigma_up)), pred_x0


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


@dataclasses.dataclass(frozen=True)
class DDIMScheduler:
    """Deterministic DDIM (eta = 0). The hyper-parameters come from the
    checkpoint's scheduler config (``from_config``); the defaults are the
    SD2.x scaled-linear betas."""

    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: str = "scaled_linear"
    prediction_type: str = "v_prediction"
    timestep_spacing: str = "leading"
    steps_offset: int = 1

    @classmethod
    def from_config(cls, cfg: dict) -> "DDIMScheduler":
        """From a diffusers scheduler_config.json dict (the keys modelled
        here; others are ignored)."""
        return cls(**{f.name: cfg[f.name] for f in dataclasses.fields(cls) if f.name in cfg})

    def alphas_cumprod(self) -> np.ndarray:
        betas = make_betas(self.num_train_timesteps, self.beta_start, self.beta_end,
                           self.beta_schedule)
        return np.cumprod(1.0 - betas)

    def make_tables(self, num_inference_steps: int):
        """→ (timesteps [N] int32 descending, alphas_cumprod [T] fp32)."""
        timesteps = _spaced_timesteps(self.num_train_timesteps, num_inference_steps,
                                      self.timestep_spacing, self.steps_offset)
        return timesteps.astype(np.int32), self.alphas_cumprod().astype(np.float32)

    def step(self, model_output: torch.Tensor, sample: torch.Tensor, t_int: int, t_prev_int: int,
             alphas_cumprod: torch.Tensor):
        """One eta = 0 step → (previous sample, predicted x₀);
        ``t_prev_int`` < 0 takes ᾱ_prev = 1 (the final step)."""
        ac_t = alphas_cumprod[t_int]
        ac_prev = alphas_cumprod[t_prev_int] if t_prev_int >= 0 else torch.ones_like(ac_t)
        sq_a, sq_1ma = ac_t ** 0.5, (1 - ac_t) ** 0.5
        if self.prediction_type == "v_prediction":
            pred_x0 = sq_a * sample - sq_1ma * model_output
            eps = sq_a * model_output + sq_1ma * sample
        elif self.prediction_type == "epsilon":
            pred_x0 = (sample - sq_1ma * model_output) / sq_a
            eps = model_output
        else:
            raise ValueError(self.prediction_type)
        return ac_prev ** 0.5 * pred_x0 + (1 - ac_prev) ** 0.5 * eps, pred_x0

    @staticmethod
    def add_noise(sample: torch.Tensor, noise: torch.Tensor, t_int: int,
                  alphas_cumprod: torch.Tensor) -> torch.Tensor:
        ac = alphas_cumprod[t_int]
        return ac ** 0.5 * sample + (1 - ac) ** 0.5 * noise
