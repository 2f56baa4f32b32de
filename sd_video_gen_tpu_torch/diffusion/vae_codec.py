"""SD-VAE latent codec (``sd_video_gen_tpu/diffusion/vae_codec.py``).

  encode: uint8 BGR / 255 -> [-1, 1] -> VAE posterior mean -> * 0.18215,
          flattened channel-major (4, h, w) per frame -> (B, T, latent_dim)
  decode: latent / 0.18215 -> VAE decode -> clip((x / 2) + 0.5, 0, 1) * 255
          -> round -> uint8 NHWC
  encode_batch: encode, then prepend the SOS token.

The posterior mean by default, as in the JAX package; a ``generator`` (or
explicit ``noise``) draws a posterior sample instead (``sample_latent``, the
reference's ``latent_dists.sample()``). ``from_checkpoint`` builds the codec
from a diffusers VAE file.

Frames and latents keep the JAX package's layouts. The model works on
(B, C, H, W) in ``torch.channels_last`` memory, which is the frames' own NHWC:
the permutes to and from frames are views, and only the latents' channel-major
flatten copies (4 channels, small).
"""

from __future__ import annotations

import torch

from sd_video_gen_tpu_torch.codecs import SD_LATENT_SCALE, add_sos
from sd_video_gen_tpu_torch.models.vae import AutoencoderKL, sample_latent


class VAECodec:
    def __init__(self, frame_size: int, model: AutoencoderKL):
        self.frame_size = frame_size
        self.model = model
        cfg = model.cfg
        # spatial compression = 2^(n_blocks - 1): 8x for the 4-block SD VAE
        self.latent_hw = frame_size // 2 ** (len(cfg.block_out_channels) - 1)
        self.latent_channels = cfg.latent_channels
        self.latent_dim = cfg.latent_channels * self.latent_hw ** 2

    @classmethod
    def from_checkpoint(cls, frame_size: int, path: str, device=None,
                        dtype=torch.float32, cfg=None) -> "VAECodec":
        """The codec of the VAE in the weight file at ``path`` (diffusers
        keys, ``.safetensors`` / ``.pt`` / ``.bin``), SD-v1.4's widths unless
        ``cfg`` says otherwise, on ``device`` (the card unless the CPU is
        asked for) in ``dtype``."""
        from sd_video_gen_tpu_torch.diffusion.weights import build_from_file
        from sd_video_gen_tpu_torch.models.vae import VAEConfig
        return cls(frame_size, build_from_file(
            AutoencoderKL, cfg or VAEConfig(), "vae", path, device, dtype))

    @property
    def device(self) -> torch.device:
        return self.model.quant_conv.weight.device

    def encode_frames(self, frames: torch.Tensor, generator=None,
                      noise=None) -> torch.Tensor:
        """(B, T, H, W, 3) uint8 BGR -> (B, T, latent_dim) f32: the posterior
        mean, or a posterior sample with ``generator`` (a ``torch.Generator``
        on the codec's device) or ``noise`` ((B * T, 4, h, w))."""
        B, T, H, W, _ = frames.shape
        x = frames.to(self.device).float() / 255.0 * 2.0 - 1.0
        x = x.reshape(B * T, H, W, 3).permute(0, 3, 1, 2)   # channels-last
        mean, logvar = self.model.encode(x)
        if generator is not None or noise is not None:
            mean = sample_latent(mean, logvar, generator, noise)
        z = mean.float() * SD_LATENT_SCALE          # (N, 4, h, w)
        return z.reshape(B, T, self.latent_dim)

    def decode_latents(self, latents: torch.Tensor) -> torch.Tensor:
        """(N, latent_dim) f32 -> (N, H, W, 3) uint8 BGR."""
        N, h = latents.shape[0], self.latent_hw
        z = latents.reshape(N, self.latent_channels, h, h) / SD_LATENT_SCALE
        x = self.model.decode(z)
        x = torch.clamp(x.float() / 2.0 + 0.5, 0.0, 1.0)
        x = torch.round(x * 255.0).to(torch.uint8)
        return x.permute(0, 2, 3, 1).contiguous()   # no copy: x is NHWC

    def encode_batch(self, frames: torch.Tensor, use_sos: bool = True,
                     generator=None, noise=None) -> torch.Tensor:
        """(B, T, H, W, 3) uint8 -> (B, T + 1, latent_dim): SOS, then frames
        (no SOS and T tokens with ``use_sos=False``); ``generator`` and
        ``noise`` as in ``encode_frames``."""
        lat = self.encode_frames(frames, generator, noise)
        return add_sos(lat) if use_sos else lat
