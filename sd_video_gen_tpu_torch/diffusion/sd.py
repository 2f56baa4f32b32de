"""The part of ``SDPipeline`` that the video denoise path uses.

Counterpart of ``sd_video_gen_tpu/diffusion/sd.py``: the empty-prompt
embedding (``uncond_embeddings``), the guidance-0 noise prediction (one
B-batch UNet call on the uncond half) and the DDIM partial denoise
(``i2i_scan``) as a Python loop. Latents here are NCHW, the UNet's layout.
Classifier-free guidance, LMS and DPM-Solver++ are not ported yet.
"""

from __future__ import annotations

import torch

from sd_video_gen_tpu_torch.diffusion.schedulers import DDIMSchedule
from sd_video_gen_tpu_torch.models.clip_text import (CLIPTextEncoder,
                                                     empty_prompt_ids)
from sd_video_gen_tpu_torch.models.unet import UNet2DCondition
from sd_video_gen_tpu_torch.models.vae import AutoencoderKL


class SDPipeline:
    def __init__(self, vae: AutoencoderKL, unet: UNet2DCondition,
                 clip: CLIPTextEncoder):
        self.vae, self.unet, self.clip = vae, unet, clip

    @property
    def device(self) -> torch.device:
        return self.unet.conv_in.weight.device

    @torch.inference_mode()
    def uncond_embeddings(self, batch: int = 1) -> torch.Tensor:
        """encode_text(['']) as [uncond; cond], (2B, 77, hidden) f32."""
        ids = empty_prompt_ids(batch, self.clip.cfg.max_length, self.device)
        e = self.clip(ids)
        return torch.cat([e, e], dim=0)

    def _unet_eps(self, latents, t: float, text_embeddings):
        """Guidance scale 0: eps is exactly the uncond prediction, so only the
        uncond half of the pair runs (one B-batch UNet call)."""
        B = latents.shape[0]
        tt = torch.full((B,), float(t), dtype=torch.float32,
                        device=latents.device)
        return self.unet(latents, tt, text_embeddings[:B])

    def i2i_scan(self, latents, text_embeddings, start_step: int,
                 num_inference_steps: int, noise=None):
        """DDIM partial denoise from ``start_step`` with guidance scale 0.

        latents: (B, 4, h, w) f32; text_embeddings: (2B, 77, hidden);
        noise: (B, 4, h, w), required when ``start_step > 0``. Runs
        ``n_steps - start_step`` UNet calls (``n_steps`` is the length of the
        timesteps array, which exceeds S when S does not divide N).
        """
        sched = DDIMSchedule(num_inference_steps)
        x = latents
        if start_step > 0:
            if noise is None:
                raise ValueError("i2i_scan: start_step > 0 needs noise")
            x = sched.add_noise_at(x, noise.to(x.dtype), start_step)
        for i in range(start_step, sched.n_steps):
            eps = self._unet_eps(x, sched.timesteps[i], text_embeddings)
            x = sched.step(eps, i, x)
        return x
