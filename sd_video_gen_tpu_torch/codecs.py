"""Latent codecs: pixel video <-> flattened frame-latent tokens
(``sd_video_gen_tpu/codecs.py``).

Latents are ``(B, T, latent_dim)`` with latent_dim = 4*(H/8)*(W/8) flattened
channel-major (4, h, w), as the reference's SD utilities lay them out.

  - ``PixelCodec``: a weight-free invertible stand-in on the SD latent grid
    (bilinear resize, 4 packed channels).
  - ``VAECodec`` (``diffusion/vae_codec.py``): the SD VAE, same contract.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from sd_video_gen_tpu_torch.models import default_device

SD_LATENT_SCALE = 0.18215  # SD latent scaling
SOS_VALUE = 2.0            # SOS token = ones * 2


def sos_token(latent_dim: int, batch: int, device=None) -> torch.Tensor:
    return torch.full((batch, 1, latent_dim), SOS_VALUE, dtype=torch.float32,
                      device=device)


def add_sos(latents: torch.Tensor) -> torch.Tensor:
    """Prepend the SOS token: (B, T, L) -> (B, T+1, L)."""
    sos = sos_token(latents.shape[-1], latents.shape[0], latents.device)
    return torch.cat([sos.to(latents.dtype), latents], dim=1)


class PixelCodec:
    """Weight-free invertible codec on the SD latent grid.

    encode: BGR uint8 (B, T, H, W, 3) -> [-1, 1], bilinear resize to
    (H/8, W/8), channels [B, G, R, luma] -> flatten (4, h, w). decode inverts
    and drops luma. The shrinking resize antialiases (a triangle filter as
    wide as the scale), as ``jax.image.resize`` does; the enlarging one needs
    none. ``device`` is where frames are taken to and latents live (the card
    unless the caller asks for the CPU).
    """

    def __init__(self, frame_size: int, device=None):
        self.frame_size = frame_size
        self.latent_hw = frame_size // 8
        self.latent_dim = 4 * self.latent_hw * self.latent_hw
        self.device = default_device(device)

    def encode_frames(self, frames: torch.Tensor) -> torch.Tensor:
        """(B, T, H, W, 3) uint8 -> (B, T, latent_dim) f32."""
        B, T, H, W, _ = frames.shape
        x = frames.to(self.device).float() / 255.0 * 2.0 - 1.0
        x = x.reshape(B * T, H, W, 3).permute(0, 3, 1, 2)
        h = self.latent_hw
        x = F.interpolate(x, size=(h, h), mode="bilinear",
                          align_corners=False, antialias=True)
        luma = x.mean(dim=1, keepdim=True)
        return torch.cat([x, luma], dim=1).reshape(B, T, self.latent_dim)

    def decode_latents(self, latents: torch.Tensor) -> torch.Tensor:
        """(N, latent_dim) f32 -> (N, H, W, 3) uint8 BGR."""
        N, h, s = latents.shape[0], self.latent_hw, self.frame_size
        x = latents.reshape(N, 4, h, h)[:, :3].float()
        x = F.interpolate(x, size=(s, s), mode="bilinear",
                          align_corners=False)
        x = torch.clamp((x + 1.0) / 2.0, 0.0, 1.0)
        x = torch.round(x * 255.0).to(torch.uint8)
        return x.permute(0, 2, 3, 1).contiguous()

    def encode_batch(self, frames: torch.Tensor,
                     use_sos: bool = True) -> torch.Tensor:
        lat = self.encode_frames(frames)
        return add_sos(lat) if use_sos else lat


def make_codec(cfg, kind: str = "pixel", vae=None, device=None):
    """Factory: 'pixel' (no weights) or 'vae' (the SD VAE ``vae``, an
    ``AutoencoderKL``; seeded random weights at SD widths when none is
    given). ``cfg`` needs ``frame_size``."""
    if kind == "pixel":
        return PixelCodec(cfg.frame_size, device)
    if kind == "vae":
        from sd_video_gen_tpu_torch.diffusion.vae_codec import VAECodec
        if vae is None:
            from sd_video_gen_tpu_torch.models import build
            from sd_video_gen_tpu_torch.models.vae import (AutoencoderKL,
                                                           VAEConfig)
            vae = build(AutoencoderKL, VAEConfig(), device)
        return VAECodec(cfg.frame_size, vae)
    raise ValueError(f"unknown codec kind: {kind}")
