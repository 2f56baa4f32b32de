"""DDIM (eta = 0) with diffusers-0.2.3 semantics, for the partial denoise.

Counterpart of ``DDIMSchedule`` in ``sd_video_gen_tpu/diffusion/schedulers.py``:
scaled-linear betas; timesteps ``arange(0, N, N//S)[::-1]`` (longer than S
when S does not divide N, and the loop runs over all of them); noise added at
``alpha[start_step]``; x0 clipped to [-1, 1]; ``set_alpha_to_one``. Constants
are f32, computed from f64 as the JAX package does, and applied as f32
scalars. DPM-Solver++ and LMS are not ported yet.
"""

from __future__ import annotations

import numpy as np


NUM_TRAIN_TIMESTEPS = 1000
BETA_START, BETA_END = 0.00085, 0.012   # SD's scaled-linear schedule


class DDIMSchedule:
    """All arrays are indexed by inference-step index i (0 = most noisy)."""

    def __init__(self, num_inference_steps: int = 50):
        N = NUM_TRAIN_TIMESTEPS
        betas = np.linspace(BETA_START ** 0.5, BETA_END ** 0.5, N,
                            dtype=np.float64) ** 2
        acp = np.cumprod(1.0 - betas)
        self.num_inference_steps = num_inference_steps
        step = N // num_inference_steps
        timesteps = np.arange(0, N, step)[::-1].copy()
        self.timesteps = timesteps
        self.n_steps = len(timesteps)
        prev = timesteps - step
        self.alpha = acp[timesteps].astype(np.float32)
        self.alpha_prev = np.where(prev >= 0, acp[np.clip(prev, 0, None)],
                                   1.0).astype(np.float32)  # set_alpha_to_one

    @staticmethod
    def _sqrt(a) -> float:
        """sqrt in f32, as a Python float torch applies in the tensor's dtype."""
        return float(np.sqrt(np.float32(a), dtype=np.float32))

    def add_noise_at(self, x, noise, i: int):
        """Forward-noise x to the noise level of inference step i."""
        a = self.alpha[i]
        return self._sqrt(a) * x + self._sqrt(np.float32(1.0) - a) * noise

    def step(self, eps, i: int, x):
        """One reverse step at inference index i."""
        a_t, a_prev = self.alpha[i], self.alpha_prev[i]
        x0 = (x - self._sqrt(np.float32(1.0) - a_t) * eps) / self._sqrt(a_t)
        x0 = x0.clamp(-1.0, 1.0)                                # clip_sample
        return (self._sqrt(a_prev) * x0
                + self._sqrt(np.float32(1.0) - a_prev) * eps)
