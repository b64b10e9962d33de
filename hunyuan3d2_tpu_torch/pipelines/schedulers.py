"""Flow-matching samplers as pure sigma arithmetic.

Behavioral parity: reference hy3dgen/shapegen/schedulers.py
(FlowMatchEulerDiscreteScheduler :56 — reversed-timestep variant: sigmas rise
0→1, shift transform σ' = s·σ/(1+(s−1)σ) (:91, :212), a trailing σ=1.0
appended (:218), Euler step x += (σ_{i+1}−σ_i)·v (:307);
ConsistencyFlowMatchEulerDiscreteScheduler :330 — PCM discrete sigma subset
(:340-349), step jumps to the sampled next sigma and also returns the
predicted original sample (:468)).

A scheduler here is just (a) a function producing the full sigma ladder as a
fixed fp32 array and (b) a pure ``step``; the pipeline loops over them.
Copied (numpy only) from hunyuan3d2_tpu/pipelines/schedulers.py so the port
imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class FlowMatchEulerDiscreteScheduler:
    num_train_timesteps: int = 1000
    shift: float = 1.0

    def make_sigmas(self, num_inference_steps: int, sigmas=None) -> np.ndarray:
        """Return the sigma ladder [N+1] fp32 (with the trailing 1.0).

        NOTE the Hunyuan3D convention (pipelines.py:732): sampling *starts
        from σ=0* and integrates the velocity field forward to σ=1.
        """
        if sigmas is None:
            sigmas = np.linspace(0.0, 1.0, num_inference_steps)
        sigmas = np.asarray(sigmas, dtype=np.float64)
        if self.shift != 1.0:
            sigmas = self.shift * sigmas / (1.0 + (self.shift - 1.0) * sigmas)
        return np.concatenate([sigmas, [1.0]]).astype(np.float32)

    def timesteps(self, sigmas: np.ndarray) -> np.ndarray:
        """Model-facing times: σ · num_train_timesteps, later divided back by
        num_train_timesteps in the pipeline (net effect: the model sees σ)."""
        return sigmas[:-1] * self.num_train_timesteps

    @staticmethod
    def step(sample, velocity, sigma, sigma_next):
        """Euler step of dx/dσ = v (fp32, parity with :302 upcast)."""
        return sample + (sigma_next - sigma) * velocity


@dataclasses.dataclass(frozen=True)
class ConsistencyFlowMatchEulerDiscreteScheduler:
    """Sampler for consistency/step-distilled ('turbo') checkpoints.

    The PCM-style discrete set: the train grid linspace(0,1,T) is subsampled
    at ``pcm_timesteps`` evenly spaced points; inference uses the first N of
    those (reference schedulers.py:340-349, :382-448).
    """

    num_train_timesteps: int = 1000
    pcm_timesteps: int = 50

    def make_sigmas(self, num_inference_steps: int, sigmas=None) -> np.ndarray:
        # exact reference arithmetic (schedulers.py:340-349 discrete grid,
        # :382-410 inference subset): idx = [0, round(i·ratio)−1 …] into
        # linspace(0,1,T); inference picks floor(linspace(0, pcm, N, endpoint=False))
        t = self.num_train_timesteps
        full = np.linspace(0.0, 1.0, t)
        step_ratio = t // self.pcm_timesteps
        euler_idx = np.concatenate(
            [[0], (np.arange(1, self.pcm_timesteps) * step_ratio).round().astype(np.int64) - 1])
        discrete = full[euler_idx]
        inference_idx = np.floor(
            np.linspace(0, self.pcm_timesteps, num=num_inference_steps, endpoint=False)
        ).astype(np.int64)
        chosen = discrete[inference_idx]
        return np.concatenate([chosen, [1.0]]).astype(np.float32)

    def timesteps(self, sigmas: np.ndarray) -> np.ndarray:
        return sigmas[:-1] * self.num_train_timesteps

    @staticmethod
    def step(sample, velocity, sigma, sigma_next):
        # consistency parameterization: jump along the straight flow using the
        # predicted endpoint, identical update rule for the Euler case
        return sample + (sigma_next - sigma) * velocity

    @staticmethod
    def pred_original(sample, velocity, sigma):
        """Predicted x1 (reference :468 pred_original_sample)."""
        return sample + (1.0 - sigma) * velocity

