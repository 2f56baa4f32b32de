"""``SDPipeline``: the reference SDUtils surface in PyTorch.

Counterpart of ``sd_video_gen_tpu/diffusion/sd.py``: CLIP text encoding with
the [uncond; cond] concat, full denoising from noise with classifier-free
guidance (LMS, or DPM-Solver++(2M) over the whole range), the DDIM / DPM-
Solver++ partial denoise from ``start_step`` (``i2i_scan``,
``gen_i2i_latents``), ``prompt_to_img``, ``img_to_img``, ``perturb_latents``.
The classifier-free-guidance pair runs as one 2B-batch UNet call; a guidance
scale of 0 given as a Python number runs only the uncond half. Every loop is
a Python loop over host-side scheduler constants; nothing is cached but the
LMS schedules (scipy quadratures).

Compiled programs (``utils/jit.py``), the counterpart of the JAX pipeline's
``_jit_cache``: the CLIP forward, the LMS and full-range DPM-Solver++ loops
of ``denoise_img_latents``, the DDIM partial denoise of ``gen_i2i_latents``
(``img_to_img``'s), and the pixel encode and decode around them, each one
CUDA graph per (sampler, steps, start step, guidance, shape) on the card.
Random draws happen before the program and enter it as inputs, as the JAX
``run(unet_params, latents, ...)`` takes them. ``i2i_scan`` is a plain
function: the refiner calls it inside the predictor's program.

Latents here are (B, 4, h, w), the UNet's logical shape, where the JAX
package's are NHWC; they may arrive in any strides (the UNet makes its input
channels-last itself). Random draws come from a ``torch.Generator`` on the
pipeline's device (seed 0 when none is given) or are passed in as tensors.
"""

from __future__ import annotations

import functools
import os
import warnings

import torch

from sd_video_gen_tpu_torch.codecs import SD_LATENT_SCALE
from sd_video_gen_tpu_torch.diffusion.schedulers import (DDIMSchedule,
                                                         DPMSolverPPSchedule,
                                                         LMSSchedule)
from sd_video_gen_tpu_torch.models.clip_text import (CLIPTextEncoder,
                                                     empty_prompt_ids)
from sd_video_gen_tpu_torch.models.unet import UNet2DCondition
from sd_video_gen_tpu_torch.models.vae import AutoencoderKL
from sd_video_gen_tpu_torch.utils.jit import jit

# ~4 S scipy quadratures a schedule: built once per step count
_lms_schedule = functools.lru_cache(maxsize=8)(LMSSchedule)


def _static_zero(guidance_scale) -> bool:
    """A Python number equal to 0 (not a tensor): the uncond-only shortcut."""
    return isinstance(guidance_scale, (int, float)) and guidance_scale == 0.0


class SDPipeline:
    def __init__(self, vae: AutoencoderKL, unet: UNet2DCondition,
                 clip: CLIPTextEncoder, tokenizer_dir: str | None = None):
        self.vae, self.unet, self.clip = vae, unet, clip
        self.tokenizer_dir = tokenizer_dir
        self._tokenizer = None
        self._clip_apply = jit(self._clip_forward, name="clip_apply")
        self._lms = jit(self._lms_loop, name="sd_lms")
        self._dpm_full = jit(self._dpm_full_loop, name="sd_dpmpp")
        self._i2i = jit(self._i2i_loop, name="sd_ddim")
        self._encode = jit(self._encode_pixels, name="sd_encode")
        self._decode = jit(self._decode_latents, name="sd_decode")

    @classmethod
    def from_pretrained_dir(cls, path: str, device=None,
                            dtype=torch.float32, vae_cfg=None, unet_cfg=None,
                            clip_cfg=None) -> "SDPipeline":
        """The pipeline from a diffusers model directory:
        ``<path>/{vae,unet}/diffusion_pytorch_model.(safetensors|bin)``,
        ``<path>/text_encoder/(model.safetensors|pytorch_model.bin)``,
        ``<path>/tokenizer/``. A missing component keeps seeded random
        weights (seeds 0, 1, 2, as ``predict.sd_modules``), with a warning.
        The configurations default to SD-v1.4's."""
        from sd_video_gen_tpu_torch.diffusion.weights import build_from_file
        from sd_video_gen_tpu_torch.models.clip_text import CLIPTextConfig
        from sd_video_gen_tpu_torch.models.unet import UNetConfig
        from sd_video_gen_tpu_torch.models.vae import VAEConfig

        def find(sub, names):
            for n in names:
                f = os.path.join(path, sub, n)
                if os.path.exists(f):
                    return f
            warnings.warn(f"SDPipeline.from_pretrained_dir: no {sub} weights "
                          f"under {path}: seeded random init")
            return None

        model_files = ("diffusion_pytorch_model.safetensors",
                       "diffusion_pytorch_model.bin")
        tok = os.path.join(path, "tokenizer")
        return cls(
            build_from_file(AutoencoderKL, vae_cfg or VAEConfig(), "vae",
                            find("vae", model_files), device, dtype, seed=0),
            build_from_file(UNet2DCondition, unet_cfg or UNetConfig(), "unet",
                            find("unet", model_files), device, dtype, seed=1),
            build_from_file(CLIPTextEncoder, clip_cfg or CLIPTextConfig(),
                            "clip", find("text_encoder", (
                                "model.safetensors", "pytorch_model.bin")),
                            device, dtype, seed=2),
            tokenizer_dir=tok if os.path.isdir(tok) else None)

    @property
    def device(self) -> torch.device:
        return self.unet.conv_in.weight.device

    def _generator(self, generator):
        if generator is not None:
            return generator
        return torch.Generator(device=self.device).manual_seed(0)

    def _randn(self, shape, generator) -> torch.Tensor:
        return torch.randn(shape, generator=self._generator(generator),
                           device=self.device)

    # -- text ---------------------------------------------------------------
    def tokenize(self, prompts: list[str]) -> torch.Tensor:
        """Token ids; '' needs no tokenizer data (the video denoise path)."""
        L = self.clip.cfg.max_length
        if all(p == "" for p in prompts):
            return empty_prompt_ids(len(prompts), L, self.device)
        if self._tokenizer is None:
            if self.tokenizer_dir is None:
                raise ValueError(
                    "non-empty prompts need a CLIP tokenizer: pass "
                    "tokenizer_dir with vocab.json/merges.txt")
            from transformers import CLIPTokenizer
            self._tokenizer = CLIPTokenizer.from_pretrained(self.tokenizer_dir)
        out = self._tokenizer(prompts, padding="max_length", max_length=L,
                              truncation=True, return_tensors="np")
        return torch.from_numpy(out["input_ids"]).long().to(self.device)

    def _clip_forward(self, ids):
        return self.clip(ids)

    @torch.inference_mode()
    def encode_text(self, prompts: list[str]) -> torch.Tensor:
        """[uncond; cond] embeddings, (2B, 77, hidden)."""
        cond = self._clip_apply(self.tokenize(prompts))
        uncond = self._clip_apply(empty_prompt_ids(
            len(prompts), self.clip.cfg.max_length, self.device))
        return torch.cat([uncond, cond], dim=0)

    @torch.inference_mode()
    def uncond_embeddings(self, batch: int = 1) -> torch.Tensor:
        """encode_text(['']) as [uncond; cond], (2B, 77, hidden) f32."""
        ids = empty_prompt_ids(batch, self.clip.cfg.max_length, self.device)
        e = self._clip_apply(ids)
        return torch.cat([e, e], dim=0)

    # -- latent loops -------------------------------------------------------
    def _unet_eps(self, latents, t: float, text_embeddings,
                  guidance_scale=0.0):
        """Classifier-free-guidance noise prediction: one 2B-batch UNet call.

        A Python-number ``guidance_scale`` of 0 skips the pair: eps is
        exactly the uncond prediction, so only the uncond half runs (one
        B-batch call). A tensor scale always runs the pair."""
        B = latents.shape[0]
        n = B if _static_zero(guidance_scale) else 2 * B
        tt = torch.full((n,), float(t), dtype=torch.float32,
                        device=latents.device)
        if n == B:
            return self.unet(latents, tt, text_embeddings[:B])
        eps = self.unet(torch.cat([latents, latents], dim=0), tt,
                        text_embeddings)
        eps_uncond, eps_text = eps.chunk(2, dim=0)
        return eps_uncond + guidance_scale * (eps_text - eps_uncond)

    @torch.inference_mode()
    def denoise_img_latents(self, text_embeddings, height: int = 512,
                            width: int = 512, num_inference_steps: int = 50,
                            guidance_scale=7.5, latents=None, generator=None,
                            sampler: str = "lms"):
        """Full denoise loop from noise; (B, 4, height/8, width/8) out.

        ``sampler='lms'`` is the reference-parity path. ``sampler='dpmpp'``
        runs DPM-Solver++(2M) over the full training range (from t = 999) in
        ``num_inference_steps`` UNet evaluations. Explicit ``latents`` are
        the VP sample x_T ~ N(0, I) for dpmpp, while the LMS path scales
        them by sigma[0] itself (the sigma-space convention).
        """
        if sampler not in ("lms", "dpmpp"):
            raise ValueError(f"unknown sampler '{sampler}' "
                             "(expected 'lms' or 'dpmpp')")
        B = text_embeddings.shape[0] // 2
        if latents is None:
            latents = self._randn((B, self.unet.cfg.in_channels, height // 8,
                                   width // 8), generator)
        loop = self._dpm_full if sampler == "dpmpp" else self._lms
        return loop(latents, text_embeddings, num_inference_steps,
                    guidance_scale)

    def _dpm_full_loop(self, latents, text_embeddings,
                       num_inference_steps: int, guidance_scale):
        dpm = DPMSolverPPSchedule(num_inference_steps, 999.0)
        return self._dpm_solve(dpm, latents, text_embeddings, guidance_scale)

    def _lms_loop(self, latents, text_embeddings, num_inference_steps: int,
                  guidance_scale):
        sched = _lms_schedule(num_inference_steps)
        x = latents * sched.init_noise_scale()
        hist = sched.init_history(x)
        for i in range(num_inference_steps):
            eps = self._unet_eps(sched.scale_input(x, i), sched.timesteps[i],
                                 text_embeddings, guidance_scale)
            x, hist = sched.step(eps, i, x, hist)
        return x

    def _dpm_solve(self, dpm, x, text_embeddings, guidance_scale):
        x0 = torch.zeros_like(x)
        for i in range(len(dpm.timesteps)):
            eps = self._unet_eps(x, dpm.timesteps[i], text_embeddings,
                                 guidance_scale)
            x, x0 = dpm.step(eps, i, x, x0)
        return x

    def _ddim_tail(self, x, text_embeddings, guidance_scale, sched,
                   start_step: int, keep: bool = False):
        """DDIM steps ``start_step``..end on an already noised ``x``; with
        ``keep`` the list of every step's output as well."""
        kept = []
        for i in range(start_step, sched.n_steps):
            eps = self._unet_eps(x, sched.timesteps[i], text_embeddings,
                                 guidance_scale)
            x = sched.step(eps, i, x)
            if keep:
                kept.append(x)
        return (x, kept) if keep else x

    def i2i_scan(self, latents, text_embeddings, start_step: int,
                 num_inference_steps: int, noise=None, sampler: str = "ddim",
                 solver_steps: int | None = None, guidance_scale=0.0):
        """Partial denoise from DDIM step ``start_step``.

        latents: (B, 4, h, w) f32; text_embeddings: (2B, 77, hidden);
        noise: (B, 4, h, w), required when ``start_step > 0``.

        ``sampler='ddim'`` runs ``n_steps - start_step`` UNet calls
        (``n_steps`` is the length of the timesteps array, which exceeds S
        when S does not divide N). ``sampler='dpmpp'`` solves the same noise
        interval with DPM-Solver++(2M) in ``solver_steps`` UNet calls
        (default half the DDIM tail, at least 2) at fractional timesteps.
        """
        sched = DDIMSchedule(num_inference_steps)
        if sampler not in ("ddim", "dpmpp"):
            raise ValueError(f"unknown sampler '{sampler}' "
                             "(expected 'ddim' or 'dpmpp')")
        if start_step > 0 and noise is None:
            raise ValueError("i2i_scan: start_step > 0 needs noise")
        x = latents
        if sampler == "dpmpp":
            tail = sched.n_steps - start_step
            k = solver_steps if solver_steps is not None else max(2, tail // 2)
            dpm = DPMSolverPPSchedule(k, float(sched.timesteps[start_step]))
            if start_step > 0:
                x = dpm.add_noise_at_start(x, noise.to(x.dtype))
            return self._dpm_solve(dpm, x, text_embeddings, guidance_scale)
        if start_step > 0:
            x = sched.add_noise_at(x, noise.to(x.dtype), start_step)
        return self._ddim_tail(x, text_embeddings, guidance_scale, sched,
                               start_step)

    @torch.inference_mode()
    def gen_i2i_latents(self, text_embeddings, height: int = 512,
                        width: int = 512, num_inference_steps: int = 50,
                        guidance_scale=7.5, latents=None, start_step: int = 10,
                        generator=None, return_all_latents: bool = False,
                        noise=None):
        """DDIM partial denoise from ``start_step``: add noise at
        ``timesteps[start_step]``, then the remaining steps.

        The noise is ``noise`` or a draw from ``generator``; where the
        initial latents are drawn too, they come first from the same
        generator, so the two are independent. ``return_all_latents`` gives
        the noised start and every step's output, ((n + 1) B, 4, h, w).
        """
        B = text_embeddings.shape[0] // 2
        generator = self._generator(generator)
        if latents is None:
            latents = self._randn((B, self.unet.cfg.in_channels, height // 8,
                                   width // 8), generator)
        if start_step <= 0:
            noise = None
        elif noise is None:
            noise = self._randn(tuple(latents.shape), generator)
        return self._i2i(latents, noise, text_embeddings, num_inference_steps,
                         guidance_scale, start_step, return_all_latents)

    def _i2i_loop(self, latents, noise, text_embeddings,
                  num_inference_steps: int, guidance_scale, start_step: int,
                  return_all_latents: bool):
        sched = DDIMSchedule(num_inference_steps)
        x = latents
        if start_step > 0:
            x = sched.add_noise_at(x, noise.to(x.dtype), start_step)
        if not return_all_latents:
            return self._ddim_tail(x, text_embeddings, guidance_scale, sched,
                                   start_step)
        _, kept = self._ddim_tail(x, text_embeddings, guidance_scale, sched,
                                  start_step, keep=True)
        return torch.cat([x, *kept], dim=0)

    # -- top-level generation -----------------------------------------------
    def prompt_to_img(self, prompts, height: int = 512, width: int = 512,
                      num_inference_steps: int = 50, guidance_scale=7.5,
                      latents=None, generator=None, sampler: str = "lms"):
        if isinstance(prompts, str):
            prompts = [prompts]
        emb = self.encode_text(prompts)
        lat = self.denoise_img_latents(emb, height, width,
                                       num_inference_steps, guidance_scale,
                                       latents, generator, sampler=sampler)
        return self._decode_pixels(lat)

    def img_to_img(self, prompts, img, height: int = 512, width: int = 512,
                   num_inference_steps: int = 50, guidance_scale=7.5,
                   start_step: int = 10, generator=None, noise=None):
        if isinstance(prompts, str):
            prompts = [prompts]
        lat = self.encode_img(img)
        emb = self.encode_text(prompts)
        out = self.gen_i2i_latents(emb, height, width, num_inference_steps,
                                   guidance_scale, latents=lat,
                                   start_step=start_step, generator=generator,
                                   noise=noise)
        return self._decode_pixels(out)

    # -- pixel <-> latent ---------------------------------------------------
    @torch.inference_mode()
    def encode_img(self, imgs_u8) -> torch.Tensor:
        """(B, H, W, 3) uint8 -> (B, 4, H/8, W/8) scaled latents (posterior
        mean)."""
        return self._encode(torch.as_tensor(imgs_u8).to(self.device))

    def _encode_pixels(self, imgs_u8):
        x = imgs_u8.float() / 255.0 * 2.0 - 1.0
        mean, _ = self.vae.encode(x.permute(0, 3, 1, 2))
        return mean.float() * SD_LATENT_SCALE

    @torch.inference_mode()
    def _decode_pixels(self, latents) -> torch.Tensor:
        """(B, 4, h, w) scaled latents of any spatial size -> (B, 8h, 8w, 3)
        uint8 pixels (the VAE is fully convolutional)."""
        return self._decode(latents)

    def _decode_latents(self, latents):
        x = self.vae.decode(latents / SD_LATENT_SCALE)
        x = torch.clamp(x.float() / 2.0 + 0.5, 0.0, 1.0)
        x = torch.round(x * 255.0).to(torch.uint8)
        return x.permute(0, 2, 3, 1).contiguous()

    def perturb_latents(self, latents, scale: float = 0.1, generator=None,
                        noise=None):
        """Latent jitter + renormalise (mean 0, population std 1)."""
        if noise is None:
            noise = self._randn(tuple(latents.shape), generator)
        new = (1 - scale) * latents + scale * noise.to(latents)
        return (new - new.mean()) / new.std(unbiased=False)
