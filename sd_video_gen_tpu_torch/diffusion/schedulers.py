"""The samplers: DDIM (eta = 0), DPM-Solver++(2M) and LMS (order 4).

Counterparts of ``DDIMSchedule``, ``DPMSolverPPSchedule`` and ``LMSSchedule``
in ``sd_video_gen_tpu/diffusion/schedulers.py``.

DDIM, diffusers-0.2.3 semantics: scaled-linear betas; timesteps
``arange(0, N, N//S)[::-1]`` (longer than S when S does not divide N, and the
loop runs over all of them); noise added at ``alpha[start_step]``; x0 clipped
to [-1, 1]; ``set_alpha_to_one``.

DPM-Solver++(2M) over the same noise interval as a DDIM tail: a grid uniform
in lambda (half-logSNR) from ``t_start`` to t = 0, data-prediction steps with
the 2nd-order multistep correction, the last step 1st order
(``lower_order_final``) and, by default, the exact-x0 endpoint. x0 is not
clipped.

LMS, diffusers-0.2.3 ``LMSDiscreteScheduler`` for full text-to-image
denoising: sigma-space scaling, 4th-order linear-multistep coefficients from
integrated Lagrange polynomials (scipy, on the host, once per schedule).

Constants are computed in f64 and stored as f32, as the JAX package does,
and applied as f32 scalars.
"""

from __future__ import annotations

import numpy as np
import torch


NUM_TRAIN_TIMESTEPS = 1000
BETA_START, BETA_END = 0.00085, 0.012   # SD's scaled-linear schedule


def _alphas_cumprod() -> np.ndarray:
    """cumprod(1 - betas) of the scaled-linear schedule, f64, (N,)."""
    betas = np.linspace(BETA_START ** 0.5, BETA_END ** 0.5, NUM_TRAIN_TIMESTEPS,
                        dtype=np.float64) ** 2
    return np.cumprod(1.0 - betas)


class DDIMSchedule:
    """All arrays are indexed by inference-step index i (0 = most noisy)."""

    def __init__(self, num_inference_steps: int = 50):
        N = NUM_TRAIN_TIMESTEPS
        acp = _alphas_cumprod()
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


class DPMSolverPPSchedule:
    """DPM-Solver++(2M) in data-prediction form (Lu et al. 2022).

    ``num_steps`` UNet evaluations from ``t_start`` (the DDIM grid's
    ``timesteps[start_step]``) to t = 0. ``timesteps`` (f64, (num_steps,))
    are the fractional t fed to the eps model; ``alpha`` / ``sigma`` (f32,
    (num_steps + 1,)) the VP levels of the grid.
    """

    def __init__(self, num_steps: int, t_start: float,
                 final_sigma_zero: bool = True):
        if num_steps < 2:
            raise ValueError("DPM-Solver++(2M) needs num_steps >= 2")
        if not t_start > 0:
            raise ValueError(
                f"DPM-Solver++ needs t_start > 0 (got {t_start}): a "
                "start_step at the end of the DDIM grid leaves no noise "
                "interval to solve")
        acp = _alphas_cumprod()
        t_all = np.arange(NUM_TRAIN_TIMESTEPS, dtype=np.float64)
        lam_all = 0.5 * np.log(acp) - 0.5 * np.log1p(-acp)  # falls with t
        lam = np.linspace(np.interp(float(t_start), t_all, lam_all),
                          lam_all[0], num_steps + 1)
        ts = np.interp(lam, lam_all[::-1], t_all[::-1])
        a2 = 1.0 / (1.0 + np.exp(-2.0 * lam))     # alpha_t^2 = sigmoid(2 lam)
        alpha, sigma = np.sqrt(a2), np.sqrt(1.0 - a2)
        h = lam[1:] - lam[:-1]
        # x_{i+1} = c_x[i] x + c_d[i] D_i, D_i = w_cur[i] x0_i + w_prev[i] x0_{i-1}
        c_x = sigma[1:] / sigma[:-1]
        c_d = -alpha[1:] * np.expm1(-h)
        r = np.ones(num_steps)
        r[1:] = h[:-1] / h[1:]
        w_cur = 1.0 + 1.0 / (2.0 * r)
        w_prev = -1.0 / (2.0 * r)
        w_cur[0], w_prev[0] = 1.0, 0.0            # no history yet
        w_cur[-1], w_prev[-1] = 1.0, 0.0          # lower_order_final
        if final_sigma_zero:                      # last level (1, 0): x_k = x0
            alpha[-1], sigma[-1] = 1.0, 0.0
            c_x[-1], c_d[-1] = 0.0, 1.0
        self.timesteps = ts[:-1]
        self.alpha = alpha.astype(np.float32)
        self.sigma = sigma.astype(np.float32)
        self.c_x = c_x.astype(np.float32)
        self.c_d = c_d.astype(np.float32)
        self.w_cur = w_cur.astype(np.float32)
        self.w_prev = w_prev.astype(np.float32)

    def add_noise_at_start(self, x, noise):
        """Forward-noise x to the solve's first level."""
        return float(self.alpha[0]) * x + float(self.sigma[0]) * noise

    def step(self, eps, i: int, x, x0_prev):
        """Transition i: returns (x_{i+1}, x0_i); pass x0_i as the next
        step's ``x0_prev`` (any tensor of x's shape at i = 0, where its
        weight is 0)."""
        x0 = (x - float(self.sigma[i]) * eps) / float(self.alpha[i])
        d = float(self.w_cur[i]) * x0 + float(self.w_prev[i]) * x0_prev
        return float(self.c_x[i]) * x + float(self.c_d[i]) * d, x0


class LMSSchedule:
    """LMSDiscrete with order-4 integrated-Lagrange coefficients.

    ``sigmas``: (S + 1,) f32, descending, the last 0; ``coeffs[i, k]``
    multiplies the k-th newest derivative at step i (zero below the order
    reached); ``timesteps``: (S,) f64, fed to the eps model.
    """

    def __init__(self, num_inference_steps: int = 50, order: int = 4):
        from scipy import integrate
        N = NUM_TRAIN_TIMESTEPS
        acp = _alphas_cumprod()
        sig_train = np.sqrt((1.0 - acp) / acp)
        self.num_inference_steps = num_inference_steps
        self.timesteps = np.linspace(N - 1, 0, num_inference_steps)
        sigmas = np.interp(self.timesteps, np.arange(N), sig_train)
        sigmas = np.concatenate([sigmas, [0.0]])
        self.sigmas = sigmas.astype(np.float32)
        self.order = order

        coeffs = np.zeros((num_inference_steps, order))
        for i in range(num_inference_steps):
            o = min(i + 1, order)
            for k in range(o):
                def poly(tau, i=i, k=k, o=o):
                    prod = 1.0
                    for j in range(o):
                        if j != k:
                            prod *= ((tau - sigmas[i - j])
                                     / (sigmas[i - k] - sigmas[i - j]))
                    return prod
                coeffs[i, k] = integrate.quad(
                    poly, sigmas[i], sigmas[i + 1], epsrel=1e-8)[0]
        self.coeffs = coeffs.astype(np.float32)

    def scale_input(self, x, i: int):
        """Latent input scaling 1 / sqrt(sigma^2 + 1)."""
        s = self.sigmas[i]
        return x / float(np.sqrt(s * s + np.float32(1.0), dtype=np.float32))

    def init_noise_scale(self) -> float:
        """Initial latents multiplier sigma[0]."""
        return float(self.sigmas[0])

    def derivative(self, eps, i: int, x):
        """dx / dsigma at step i: (x - x0) / sigma with x0 = x - sigma eps."""
        s = float(self.sigmas[i])
        return (x - (x - s * eps)) / s

    def step(self, eps, i: int, x, deriv_hist):
        """One LMS step. ``deriv_hist``: (order, *x.shape), newest first.
        Returns (x_next, new_hist)."""
        d = self.derivative(eps, i, x)
        hist = torch.cat([d[None], deriv_hist[:-1]], dim=0)
        # tensordot(coeffs[i], hist) with the weights as f32 scalars: no
        # host-to-device copy per step
        acc = float(self.coeffs[i, 0]) * hist[0]
        for k in range(1, self.order):
            acc = acc + float(self.coeffs[i, k]) * hist[k]
        return x + acc, hist

    def init_history(self, x):
        return x.new_zeros((self.order,) + tuple(x.shape))
