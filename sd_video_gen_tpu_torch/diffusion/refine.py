"""Per-frame partial-denoise refinement for the AR rollout (``--denoise``).

Counterpart of ``make_denoise_refiner`` in
``sd_video_gen_tpu/diffusion/refine.py``. With ``hi_res`` set, for every
predicted latent: decode -> nearest-upscale to ``hi_res`` -> re-encode ->
noise to the level of DDIM ``timesteps[start_step]`` -> the remaining DDIM
steps, or ``solver_steps`` DPM-Solver++(2M) steps over the same interval
(``sampler='dpmpp'``), with guidance 0 and the empty-prompt embedding ->
decode -> nearest-downscale -> re-encode. With ``hi_res=None`` the latent is
denoised at its native resolution with no pixel round trip (the evaluation
harness's variant).

Nearest resizing uses half-pixel centres ('nearest-exact'), as
``jax.image.resize`` does: a 512 -> 64 downscale picks source pixel 8i+4,
where torch's legacy 'nearest' would pick 8i.

Noise: the JAX package draws from ``fold_in(PRNGKey(start_step), step)``,
which torch cannot reproduce. Here ``noise_fn(step, shape)`` gives the NHWC
noise of a rollout step; the default draws it from a ``torch.Generator`` on
the device seeded from (start_step, step). Tests pass JAX's exact noise.
The noise is a function of (step, shape) alone, so the refiner takes each
draw once and keeps it on the device (``draw_once``): a compiled request
(``utils/jit.py``) reads it as a constant buffer, drawn outside the graph
in the warm-up, and every later request, compiled or eager, gets the same
tensor. A data-parallel caller wraps the noise in ``windowed_noise``: each
process draws the whole global batch's noise once and keeps its rows, so
the run refines every clip with the noise a single process would give it.
The whole draw is taken once per (step, batch size) and the rows are a view
of it, so a graph captured for one window reads that window's rows for
good: a compiled request keys on the window (``BatchWindow.key``, an
argument of ``predict/predict.make_predict_fn``'s program), and a batch
with other rows, or another batch size, gets a graph of its own.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

from sd_video_gen_tpu_torch.diffusion.sd import SDPipeline
from sd_video_gen_tpu_torch.diffusion.vae_codec import VAECodec


def resize_nearest(frames_u8: torch.Tensor, size: int) -> torch.Tensor:
    """(N, H, W, 3) uint8 -> (N, size, size, 3) uint8, half-pixel centres.
    The (N, 3, H, W) view of the frames is channels-last and stays so through
    the resize, so neither permute copies."""
    x = frames_u8.permute(0, 3, 1, 2).float()
    x = F.interpolate(x, size=(size, size), mode="nearest-exact")
    return x.to(torch.uint8).permute(0, 2, 3, 1).contiguous()


def draw_once(noise_fn: Callable, device) -> Callable:
    """``noise_fn``'s draw for each (step, shape), taken at the first ask
    and kept on ``device``."""
    kept = {}

    def draw(step: int, shape) -> torch.Tensor:
        key = (int(step), tuple(shape))
        if key not in kept:
            kept[key] = noise_fn(step, shape).to(device)
        return kept[key]
    draw.draws_once = True
    return draw


def default_noise(start_step: int, device) -> Callable:
    def draw(step: int, shape) -> torch.Tensor:
        g = torch.Generator(device=device)
        # 16 bits each: the CPU generator keeps only a 32-bit seed
        g.manual_seed((start_step << 16) | int(step))
        return torch.randn(shape, generator=g, device=device)
    return draw_once(draw, device)


class BatchWindow:
    """The rows [lo, hi) of an ``n``-row global batch this process holds
    (``parallel/mesh.Layout.rows``), set by the caller before each batch."""

    def __init__(self):
        self.lo = self.hi = self.n = 0

    def set(self, lo: int, hi: int, n: int) -> None:
        self.lo, self.hi, self.n = lo, hi, n

    def key(self) -> tuple[int, int, int]:
        """``(lo, hi, n)``: what the noise of a batch depends on beyond
        its shape, so part of a compiled request's key."""
        return self.lo, self.hi, self.n


def windowed_noise(noise_fn: Callable, window: BatchWindow) -> Callable:
    """``noise_fn``'s draw for the whole global batch, cut to the rows of
    ``window`` (a view). ``noise_fn`` should draw once (``default_noise``
    does): the window moves from batch to batch, the whole draw does not."""
    def draw(step: int, shape) -> torch.Tensor:
        if shape[0] != window.hi - window.lo:
            raise ValueError(f"noise for {shape[0]} rows, but the window "
                             f"holds [{window.lo}, {window.hi})")
        whole = noise_fn(step, (window.n,) + tuple(shape[1:]))
        return whole[window.lo:window.hi]
    draw.draws_once = True
    return draw


def make_denoise_refiner(pipe: SDPipeline, frame_size: int, start_step: int,
                         num_inference_steps: int = 50,
                         hi_res: Optional[int] = 512,
                         noise_fn: Optional[Callable] = None,
                         sampler: str = "ddim",
                         solver_steps: Optional[int] = None) -> Callable:
    """Build the refine hook for ``ar_rollout``:
    ``refine(flat_latents (B, latent_dim), step) -> (B, latent_dim)``.

    The empty-prompt embedding is computed once, here. ``noise_fn(step,
    shape)`` must depend on (step, shape) alone: each draw is taken once
    (``draw_once``) unless it already is.
    """
    vae_lo = VAECodec(frame_size, pipe.vae)
    uncond = pipe.uncond_embeddings(1)
    noise_fn = noise_fn or default_noise(start_step, pipe.device)
    if not getattr(noise_fn, "draws_once", False):
        noise_fn = draw_once(noise_fn, pipe.device)

    if hi_res is None:
        # the VAE owns its compression factor: the grid is its latent_hw
        h_lo, c = vae_lo.latent_hw, vae_lo.latent_channels

        def refine_native(flat_latents: torch.Tensor,
                          step: int = 0) -> torch.Tensor:
            B = flat_latents.shape[0]
            emb = uncond[:1].expand(2 * B, -1, -1)
            noise = noise_fn(step, (B, h_lo, h_lo, c)).to(flat_latents.device)
            den = pipe.i2i_scan(flat_latents.reshape(B, c, h_lo, h_lo), emb,
                                start_step, num_inference_steps,
                                noise=noise.permute(0, 3, 1, 2),
                                sampler=sampler, solver_steps=solver_steps)
            return den.reshape(B, -1)

        return refine_native

    vae_hi = VAECodec(hi_res, pipe.vae)
    h, lc = vae_hi.latent_hw, vae_hi.latent_channels

    def refine(flat_latents: torch.Tensor, step: int = 0) -> torch.Tensor:
        B = flat_latents.shape[0]
        emb = uncond[:1].expand(2 * B, -1, -1)
        img_lo = vae_lo.decode_latents(flat_latents)            # (B, lo, lo, 3)
        img_hi = resize_nearest(img_lo, hi_res)
        lat_hi = vae_hi.encode_frames(img_hi[:, None]).reshape(B, lc, h, h)
        noise = noise_fn(step, (B, h, h, lc)).to(lat_hi.device)
        den = pipe.i2i_scan(lat_hi, emb, start_step, num_inference_steps,
                            noise=noise.permute(0, 3, 1, 2), sampler=sampler,
                            solver_steps=solver_steps)
        img_den = vae_hi.decode_latents(den.reshape(B, -1))     # (B, hi, hi, 3)
        img_back = resize_nearest(img_den, frame_size)
        return vae_lo.encode_frames(img_back[:, None])[:, 0]

    return refine
