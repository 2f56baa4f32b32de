"""A serving request's and a training step's arithmetic, plain and float32.

Serving (the reference repository's ``prediction/predict.py --denoise``,
``utils/sd_utils.py:222-267``): frames are encoded to SD latents (the VAE's
posterior mean times 0.18215, flattened channel-major), an SOS token of
2.0 is put in front, and the transformer predicts one latent at a time over
a sliding window; each predicted latent is decoded to pixels, nearest-
upscaled to 512px, encoded again, noised to DDIM ``timesteps[start]`` and
denoised by the remaining DDIM steps with the empty prompt and guidance 0,
decoded, nearest-downscaled (half-pixel centres) and encoded at the frame
size. Training: the pixel codec (an antialiased bilinear resize to the
latent grid plus a luma channel), the teacher-forced forward, MSE + GDL +
BiPatchNCE, and Adam in optax's order with the state stored in the dtypes
the configuration states.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.clip_text import empty_prompt_ids
from benchmark.reference.layers import causal_mask, round_fp8

SD_LATENT_SCALE = 0.18215
SOS_VALUE = 2.0


# -- DDIM (50 steps, SD's scaled-linear betas, clip_sample, alpha_prev 1) --
def _alphas_cumprod() -> np.ndarray:
    betas = np.linspace(0.00085 ** 0.5, 0.012 ** 0.5, 1000,
                        dtype=np.float64) ** 2
    return np.cumprod(1.0 - betas)


def _sqrt(a) -> float:
    return float(np.sqrt(np.float32(a), dtype=np.float32))


class DDIM:
    def __init__(self, num_inference_steps: int = 50):
        acp, step = _alphas_cumprod(), 1000 // num_inference_steps
        self.timesteps = np.arange(0, 1000, step)[::-1].copy()
        prev = self.timesteps - step
        self.alpha = acp[self.timesteps].astype(np.float32)
        self.alpha_prev = np.where(prev >= 0, acp[np.clip(prev, 0, None)],
                                   1.0).astype(np.float32)

    def add_noise(self, x, noise, i: int):
        a = self.alpha[i]
        return _sqrt(a) * x + _sqrt(np.float32(1.0) - a) * noise

    def step(self, eps, i: int, x):
        a_t, a_prev = self.alpha[i], self.alpha_prev[i]
        x0 = ((x - _sqrt(np.float32(1.0) - a_t) * eps) / _sqrt(a_t)).clamp(
            -1.0, 1.0)
        return _sqrt(a_prev) * x0 + _sqrt(np.float32(1.0) - a_prev) * eps


# -- the SD VAE as a codec of uint8 BGR frames ------------------------------
def vae_encode(vae, frames_u8: torch.Tensor) -> torch.Tensor:
    """(N, H, W, 3) uint8 -> (N, 4 * (H/8)^2) latents."""
    x = frames_u8.float() / 255.0 * 2.0 - 1.0
    mean = vae.encode_mean(x.permute(0, 3, 1, 2))
    return (mean.float() * SD_LATENT_SCALE).reshape(x.shape[0], -1)


def vae_decode(vae, latents: torch.Tensor, size: int) -> torch.Tensor:
    """(N, 4 * (size/8)^2) latents -> (N, size, size, 3) uint8."""
    h = size // vae.factor
    x = vae.decode(latents.reshape(-1, 4, h, h) / SD_LATENT_SCALE)
    x = torch.clamp(x.float() / 2.0 + 0.5, 0.0, 1.0)
    return torch.round(x * 255.0).to(torch.uint8).permute(0, 2, 3, 1)


def resize_nearest(frames_u8: torch.Tensor, size: int) -> torch.Tensor:
    x = frames_u8.permute(0, 3, 1, 2).float()
    x = F.interpolate(x, size=(size, size), mode="nearest-exact")
    return x.to(torch.uint8).permute(0, 2, 3, 1)


def empty_prompt(clip) -> torch.Tensor:
    """The empty prompt's text states, (1, 77, hidden)."""
    ids = empty_prompt_ids(1, clip.cfg.max_length,
                           clip.embeddings.token_embedding.weight.device)
    return clip(ids).float()


def refine(models, latents: torch.Tensor, noise_nhwc: torch.Tensor,
           frame_size: int, hi_res: int, start_step: int, text,
           num_steps: int = 50) -> torch.Tensor:
    """One predicted latent per row, (B, L) -> (B, L), refined at
    ``hi_res`` from step ``start_step`` of ``num_steps`` DDIM steps with
    ``noise_nhwc``."""
    vae, unet = models["vae"], models["unet"]
    B, h = latents.shape[0], hi_res // vae.factor
    img_hi = resize_nearest(vae_decode(vae, latents, frame_size), hi_res)
    x = vae_encode(vae, img_hi).reshape(B, 4, h, h)
    sched = DDIM(num_steps)
    x = sched.add_noise(x, noise_nhwc.permute(0, 3, 1, 2).to(x.dtype),
                        start_step)
    ctx = text.expand(B, -1, -1).to(x.dtype)
    for i in range(start_step, len(sched.timesteps)):
        t = torch.full((B,), float(sched.timesteps[i]), device=x.device)
        x = sched.step(unet(x, t, ctx).float(), i, x)
    img = resize_nearest(vae_decode(vae, x.reshape(B, -1), hi_res),
                         frame_size)
    return vae_encode(vae, img)


def add_sos(latents: torch.Tensor) -> torch.Tensor:
    sos = torch.full_like(latents[:, :1], SOS_VALUE)
    return torch.cat([sos, latents], dim=1)


def rollout_inputs(context: torch.Tensor, preds: torch.Tensor, i: int,
                   window: int) -> torch.Tensor:
    """The transformer's input for predicted frame ``i``, given the context
    latents (B, T, L) and the latents predicted before it: SOS and the
    context for the first; then the last ``window`` latents of the context
    without its last frame followed by the predictions."""
    if i == 0:
        return add_sos(context)
    seq = torch.cat([context[:, :-1], preds[:, :i]], dim=1)[:, -window:]
    if seq.shape[1] < window:
        seq = torch.cat([seq[:, :1].expand(-1, window - seq.shape[1], -1),
                         seq], dim=1)
    return seq


def next_latent(model, seq: torch.Tensor) -> torch.Tensor:
    mask = causal_mask(seq.shape[1], device=seq.device)
    return model(seq, seq, mask)[:, -1].float()


# -- training -----------------------------------------------------------------
def pixel_encode(frames_u8: torch.Tensor) -> torch.Tensor:
    """(B, T, H, W, 3) uint8 -> (B, T, 4 * (H/8)^2): [-1, 1], an
    antialiased bilinear resize to (H/8, W/8), channels B, G, R, luma."""
    B, T, H, W, _ = frames_u8.shape
    x = (frames_u8.float() / 255.0 * 2.0 - 1.0).reshape(B * T, H, W, 3)
    x = F.interpolate(x.permute(0, 3, 1, 2), size=(H // 8, W // 8),
                      mode="bilinear", align_corners=False, antialias=True)
    x = torch.cat([x, x.mean(dim=1, keepdim=True)], dim=1)
    return x.reshape(B, T, -1)


def _spatial(x):
    hw = int(round((x.shape[-1] // 4) ** 0.5))
    return x.reshape(x.shape[:-1] + (4, hw, hw))


def losses(pred, target, lambda_gdl: float, lambda_c: float,
           temperature: float = 0.07) -> dict:
    """MSE, GDL (alpha 1) and BiPatchNCE of (B, K, L) latents, and their
    weighted total."""
    mse = (pred - target).square().mean()
    x, y = _spatial(pred), _spatial(target)
    v = ((x[..., 1:, :] - x[..., :-1, :]).abs()
         - (y[..., 1:, :] - y[..., :-1, :]).abs()).abs()
    h = ((x[..., :, 1:] - x[..., :, :-1]).abs()
         - (y[..., :, 1:] - y[..., :, :-1]).abs()).abs()
    gdl = (v.sum() + h.sum()) / pred.numel()
    B, K, C, hh, ww = x.shape
    p = x.reshape(B * K, C, hh * ww).transpose(1, 2)
    g = y.reshape(B * K, C, hh * ww).transpose(1, 2)

    def one_way(a, b):
        # the gradient stops through b off the diagonal
        s = torch.einsum("mpc,mqc->mpq", a, b.detach())
        diag = (a * b).sum(-1)
        scores = (s + torch.diag_embed(
            diag - torch.diagonal(s, dim1=-2, dim2=-1))) / temperature
        return (torch.logsumexp(scores, dim=-1)
                - torch.diagonal(scores, dim1=-2, dim2=-1)).mean()

    nce = 0.5 * (one_way(g, p) + one_way(p, g))
    total = mse + lambda_gdl * gdl + lambda_c * nce
    return {"mse": mse, "gdl": gdl, "contrastive": nce, "total": total}


def train_loss(model, frames_u8, k: int, generator, lambda_gdl, lambda_c):
    """The teacher-forced 'ar' loss of one batch."""
    latents = add_sos(pixel_encode(frames_u8))
    y_in = latents[:, :-1]
    mask = causal_mask(y_in.shape[1], device=latents.device)
    pred = model(latents, y_in, mask, generator)[:, -k:]
    return losses(pred.float(), latents[:, 1:][:, -k:], lambda_gdl, lambda_c)


class Adam:
    """optax.adam(lr, 0.9, 0.999, 1e-8) computed in float32, the parameters
    and both moments stored in ``storage`` after each update (a float8
    format under one scale a tensor)."""

    def __init__(self, lr: float, storage: torch.dtype, b1=0.9, b2=0.999,
                 eps=1e-8):
        self.lr, self.storage, self.b1, self.b2, self.eps = (lr, storage, b1,
                                                             b2, eps)

    def init(self, params: dict) -> dict:
        return {"mu": {k: torch.zeros_like(p) for k, p in params.items()},
                "nu": {k: torch.zeros_like(p) for k, p in params.items()},
                "count": 0}

    def _store(self, x):
        if self.storage.itemsize == 1:
            return round_fp8(x.float(), self.storage)
        return x.to(self.storage).float()

    @torch.no_grad()
    def update(self, params: dict, grads: dict, state: dict) -> None:
        state["count"] += 1
        t = state["count"]
        bc1 = float(np.float32(1) - np.float32(self.b1) ** np.float32(t))
        bc2 = float(np.float32(1) - np.float32(self.b2) ** np.float32(t))
        for k, p in params.items():
            g = grads[k].float()
            mu = (1 - self.b1) * g + self.b1 * state["mu"][k]
            nu = (1 - self.b2) * g * g + self.b2 * state["nu"][k]
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            p.copy_(self._store(p - self.lr * u))
            state["mu"][k] = self._store(mu)
            state["nu"][k] = self._store(nu)


def dropout_seed(seed: int, step: int, rank: int = 0) -> int:
    """The seed of a training step's dropout generator, as the measured
    trainer derives it from the run's seed, the step number (from 0) and
    the data rank."""
    out = (int(seed) * 0x9E3779B97F4A7C15 + int(step) * 0xBF58476D1CE4E5B9
           + int(rank) * 0xD6E8FEB86659FD93 + 0x94D049BB133111EB)
    return out % (1 << 63)
