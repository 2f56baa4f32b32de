"""Per-frame partial-denoise refinement for the AR rollout (``--denoise``).

Counterpart of ``make_denoise_refiner`` in
``sd_video_gen_tpu/diffusion/refine.py`` with ``hi_res`` set: for every
predicted latent, decode -> nearest-upscale to ``hi_res`` -> re-encode ->
DDIM add_noise at ``timesteps[start_step]`` -> the remaining DDIM steps with
guidance 0 and the empty-prompt embedding -> decode -> nearest-downscale ->
re-encode.

Nearest resizing uses half-pixel centres ('nearest-exact'), as
``jax.image.resize`` does: a 512 -> 64 downscale picks source pixel 8i+4,
where torch's legacy 'nearest' would pick 8i.

Noise: the JAX package draws from ``fold_in(PRNGKey(start_step), step)``,
which torch cannot reproduce. Here ``noise_fn(step, shape)`` gives the NHWC
noise of a rollout step; the default draws it from a ``torch.Generator`` on
the device seeded from (start_step, step). Tests pass JAX's exact noise.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

from sd_video_gen_tpu_torch.diffusion.sd import SDPipeline
from sd_video_gen_tpu_torch.diffusion.vae_codec import VAECodec


def resize_nearest(frames_u8: torch.Tensor, size: int) -> torch.Tensor:
    """(N, H, W, 3) uint8 -> (N, size, size, 3) uint8, half-pixel centres."""
    x = frames_u8.permute(0, 3, 1, 2).float()
    x = F.interpolate(x, size=(size, size), mode="nearest-exact")
    return x.to(torch.uint8).permute(0, 2, 3, 1).contiguous()


def default_noise(start_step: int, device) -> Callable:
    def draw(step: int, shape) -> torch.Tensor:
        g = torch.Generator(device=device)
        # 16 bits each: the CPU generator keeps only a 32-bit seed
        g.manual_seed((start_step << 16) | int(step))
        return torch.randn(shape, generator=g, device=device)
    return draw


def make_denoise_refiner(pipe: SDPipeline, frame_size: int, start_step: int,
                         num_inference_steps: int = 50, hi_res: int = 512,
                         noise_fn: Optional[Callable] = None) -> Callable:
    """Build the refine hook for ``ar_rollout``:
    ``refine(flat_latents (B, latent_dim), step) -> (B, latent_dim)``.

    The empty-prompt embedding is computed once, here.
    """
    vae_lo = VAECodec(frame_size, pipe.vae)
    vae_hi = VAECodec(hi_res, pipe.vae)
    h, lc = vae_hi.latent_hw, vae_hi.latent_channels
    uncond = pipe.uncond_embeddings(1)
    noise_fn = noise_fn or default_noise(start_step, pipe.device)

    def refine(flat_latents: torch.Tensor, step: int = 0) -> torch.Tensor:
        B = flat_latents.shape[0]
        emb = uncond[:1].expand(2 * B, -1, -1)
        img_lo = vae_lo.decode_latents(flat_latents)            # (B, lo, lo, 3)
        img_hi = resize_nearest(img_lo, hi_res)
        lat_hi = vae_hi.encode_frames(img_hi[:, None]).reshape(B, lc, h, h)
        noise = noise_fn(step, (B, h, h, lc)).to(lat_hi.device)
        den = pipe.i2i_scan(lat_hi, emb, start_step, num_inference_steps,
                            noise=noise.permute(0, 3, 1, 2))
        img_den = vae_hi.decode_latents(den.reshape(B, -1))     # (B, hi, hi, 3)
        img_back = resize_nearest(img_den, frame_size)
        return vae_lo.encode_frames(img_back[:, None])[:, 0]

    return refine
