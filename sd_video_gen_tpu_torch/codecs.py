"""Latent-token constants and the SOS token (``sd_video_gen_tpu/codecs.py``).

Latents are ``(B, T, latent_dim)`` with latent_dim = 4*(H/8)*(W/8) flattened
channel-major (4, h, w), as the reference's SD utilities lay them out. The SD
VAE codec itself lives in ``diffusion/vae_codec.py``.
"""

from __future__ import annotations

import torch

SD_LATENT_SCALE = 0.18215  # SD latent scaling
SOS_VALUE = 2.0            # SOS token = ones * 2


def sos_token(latent_dim: int, batch: int, device=None) -> torch.Tensor:
    return torch.full((batch, 1, latent_dim), SOS_VALUE, dtype=torch.float32,
                      device=device)


def add_sos(latents: torch.Tensor) -> torch.Tensor:
    """Prepend the SOS token: (B, T, L) -> (B, T+1, L)."""
    sos = sos_token(latents.shape[-1], latents.shape[0], latents.device)
    return torch.cat([sos.to(latents.dtype), latents], dim=1)
